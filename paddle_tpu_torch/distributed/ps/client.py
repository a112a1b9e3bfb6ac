"""The parameter-server client (port of
``paddle_tpu/distributed/ps/client.py``): routes pulls and pushes to the
server that owns each id, ``id % num_servers``, each server's share on
its own thread, so the servers work at once.

Reference analogue: BrpcPsClient
(paddle/fluid/distributed/ps/service/brpc_ps_client.cc) —
sparse keys are sharded over servers; dense tables live on shard 0 here
(the reference splits dense blocks across servers too; with host-RAM tables
that buys nothing until tables exceed one host).
"""

from __future__ import annotations

import numpy as np

from .rpc import RpcClient


class PSClient:
    def __init__(self, endpoints):
        if isinstance(endpoints, str):
            endpoints = [e for e in endpoints.split(",") if e]
        self._conns = []
        self._pool = None
        for ep in endpoints:
            host, port = ep.rsplit(":", 1)
            self._conns.append(RpcClient(host, int(port)))

    @property
    def num_servers(self):
        return len(self._conns)

    # -- table creation (broadcast so every shard knows the schema) ---------
    def create_sparse_table(self, table, dim, **kw):
        seed = kw.pop("seed", 0)
        for i, c in enumerate(self._conns):
            c.call(op="create_sparse", table=table, dim=dim, seed=seed + i,
                   **kw)

    def create_dense_table(self, table, shape, **kw):
        self._conns[0].call(op="create_dense", table=table,
                            shape=list(shape), **kw)

    # -- sparse -------------------------------------------------------------
    def _shard(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        owner = ids % self.num_servers
        return ids, owner

    def _on_servers(self, calls):
        """Run ``{server: fn}`` and return ``{server: fn()}``: each
        server's request on its own thread (each connection is its own
        socket), so the servers work at once."""
        if len(calls) <= 1:
            return {s: fn() for s, fn in calls.items()}
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(self.num_servers)
        futs = {s: self._pool.submit(fn) for s, fn in calls.items()}
        return {s: f.result() for s, f in futs.items()}

    def pull_sparse(self, table, ids):
        ids, owner = self._shard(ids)
        masks = {s: owner == s for s in range(self.num_servers)}
        masks = {s: m for s, m in masks.items() if m.any()}
        vals = self._on_servers({s: (lambda s=s, m=m: self._conns[s].call(
            op="pull_sparse", table=table, ids=ids[m])["values"])
            for s, m in masks.items()})
        dim = next(iter(vals.values())).shape[1] if vals else 0
        out = np.zeros((ids.size, dim), np.float32)
        for s, m in masks.items():
            out[m] = vals[s]
        return out

    def push_sparse(self, table, ids, grads, lr):
        ids, owner = self._shard(ids)
        grads = np.asarray(grads, np.float32).reshape(ids.size, -1)
        masks = {s: owner == s for s in range(self.num_servers)}
        self._on_servers({s: (lambda s=s, m=m: self._conns[s].call(
            op="push_sparse", table=table, ids=ids[m], grads=grads[m],
            lr=lr)) for s, m in masks.items() if m.any()})

    def _on_each(self, **req):
        """``req`` sent to every server at once; their replies in order."""
        out = self._on_servers({s: (lambda c=c: c.call(**req))
                                for s, c in enumerate(self._conns)})
        return [out[s] for s in range(self.num_servers)]

    def sparse_table_size(self, table):
        return sum(r["size"] for r in self._on_each(op="table_size",
                                                    table=table))

    # -- dense --------------------------------------------------------------
    def pull_dense(self, table):
        return self._conns[0].call(op="pull_dense", table=table)["value"]

    def push_dense_grad(self, table, grad, lr):
        self._conns[0].call(op="push_dense_grad", table=table,
                            grad=np.asarray(grad, np.float32), lr=lr)

    def push_dense_delta(self, table, delta):
        self._conns[0].call(op="push_dense_delta", table=table,
                            delta=np.asarray(delta, np.float32))

    def dense_init_once(self, table, value):
        """Atomic first-writer-wins seeding (GeoTrainer startup)."""
        return self._conns[0].call(op="dense_init_once", table=table,
                                   value=np.asarray(value,
                                                    np.float32))["seeded"]

    # -- lifecycle ----------------------------------------------------------
    def save(self, dirname):
        self._on_servers({i: (lambda i=i, c=c: c.call(
            op="save", dirname=f"{dirname}/shard{i}"))
            for i, c in enumerate(self._conns)})

    def load(self, dirname):
        self._on_servers({i: (lambda i=i, c=c: c.call(
            op="load", dirname=f"{dirname}/shard{i}"))
            for i, c in enumerate(self._conns)})

    def stop_servers(self):
        for c in self._conns:
            try:
                c.call(op="stop")
            except (RuntimeError, ConnectionError, OSError):
                pass

    def close(self):
        for c in self._conns:
            c.close()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


__all__ = ["PSClient"]
