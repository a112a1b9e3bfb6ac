"""The parameter server (port of ``paddle_tpu/distributed/ps/server.py``).

Reference analogue: BrpcPsServer + PsService
(paddle/fluid/distributed/ps/service/brpc_ps_server.cc —
PULL_SPARSE/PUSH_SPARSE/PULL_DENSE/PUSH_DENSE/BARRIER/SAVE/LOAD rpc verbs).
Multiple servers shard a sparse table by ``id % num_servers`` (the client
does the routing, mirroring the reference's shard_num partitioning).
"""

from __future__ import annotations

from .rpc import RpcServer
from .table import DenseTable, SparseTable, load_tables, save_tables


class ParameterServer:
    """Holds tables, answers pull/push.  Create tables up front (from the
    worker-declared schema) or lazily on first touch."""

    def __init__(self, host="127.0.0.1", port=0):
        self.tables: dict[str, object] = {}
        self._host = host
        self._rpc = RpcServer(host, port, self._handle)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._rpc.start()
        return self

    @property
    def endpoint(self):
        return f"{self._host}:{self._rpc.port}"

    def run(self):
        """Block until a stop rpc arrives (fleet.run_server)."""
        self._rpc._stop.wait()

    def stop(self):
        self._rpc.stop()

    # -- table management ---------------------------------------------------
    def create_sparse_table(self, name, dim, **kw):
        if name not in self.tables:
            self.tables[name] = SparseTable(name, dim, **kw)
        return self.tables[name]

    def create_dense_table(self, name, shape, **kw):
        if name not in self.tables:
            self.tables[name] = DenseTable(name, shape, **kw)
        return self.tables[name]

    # -- rpc dispatch -------------------------------------------------------
    def _handle(self, req):
        op = req.get("op")
        if op == "create_sparse":
            self.create_sparse_table(req["table"], req["dim"],
                                     initializer=req.get("initializer",
                                                         "normal"),
                                     init_scale=req.get("init_scale", 0.01),
                                     optimizer=req.get("optimizer", "sgd"),
                                     seed=req.get("seed", 0))
            return {"ok": True}
        if op == "create_dense":
            self.create_dense_table(req["table"], req["shape"],
                                    initializer=req.get("initializer",
                                                        "zeros"),
                                    init_scale=req.get("init_scale", 0.01),
                                    optimizer=req.get("optimizer", "sgd"),
                                    seed=req.get("seed", 0))
            return {"ok": True}
        if op == "pull_sparse":
            return {"values": self.tables[req["table"]].pull(req["ids"])}
        if op == "push_sparse":
            self.tables[req["table"]].push(req["ids"], req["grads"],
                                           req["lr"])
            return {"ok": True}
        if op == "pull_dense":
            return {"value": self.tables[req["table"]].pull()}
        if op == "push_dense_grad":
            self.tables[req["table"]].push_grad(req["grad"], req["lr"])
            return {"ok": True}
        if op == "push_dense_delta":
            self.tables[req["table"]].push_delta(req["delta"])
            return {"ok": True}
        if op == "dense_init_once":
            return {"seeded": self.tables[req["table"]].init_once(
                req["value"])}
        if op == "table_size":
            return {"size": len(self.tables[req["table"]])}
        if op == "save":
            save_tables(self.tables, req["dirname"])
            return {"ok": True}
        if op == "load":
            load_tables(self.tables, req["dirname"])
            return {"ok": True}
        if op == "stop":
            return {"ok": True}
        raise ValueError(f"unknown PS op '{op}'")


__all__ = ["ParameterServer"]
