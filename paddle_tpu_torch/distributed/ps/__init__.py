"""The parameter-server training stack (port of
``paddle_tpu/distributed/ps``).

Reference analogue: fleet's parameter-server mode —
python/paddle/distributed/fleet/fleet.py init_server()/run_server()/
init_worker() over the brpc PS runtime (paddle/fluid/distributed/ps/),
with the a_sync and GeoSGD strategies and ``paddle.static.nn.
sparse_embedding``.

The servers hold the parameters that do not fit the card (embedding
tables of millions of rows) in host memory, one process each, sharded
by ``id % num_servers``; a worker pulls the rows its batch touches,
lands them on the card as one ``[n_unique, dim]`` leaf that needs a
gradient, gathers them to the ids' shape with torch ops, and after
``backward()`` pushes that leaf's gradient back to the servers, which
apply their optimizer (:class:`SparseEmbedding`).  Dense replicas under
GeoSGD push their parameter deltas every k steps (:class:`GeoTrainer`).
Roles come from the environment the reference's PaddleCloudRoleMaker
reads: ``TRAINING_ROLE``, ``PADDLE_PSERVERS_IP_PORT_LIST``,
``PADDLE_PORT``, ``PADDLE_TRAINER_ID``.  The wire format and the table
files are the JAX package's, so the two packages' clients and servers
interoperate.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .client import PSClient
from .server import ParameterServer
from .table import DenseTable, SparseTable  # noqa: F401


class PSRoleMaker:
    """Environment role discovery (reference: PaddleCloudRoleMaker,
    python/paddle/distributed/fleet/base/role_maker.py)."""

    def __init__(self, role=None, endpoints=None, worker_id=0):
        self.role = role or os.environ.get("TRAINING_ROLE", "TRAINER").lower()
        eps = endpoints or os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self.endpoints = ([e for e in eps.split(",") if e]
                          if isinstance(eps, str) else list(eps))
        self.worker_id = int(os.environ.get("PADDLE_TRAINER_ID", worker_id))
        self.server_port = int(os.environ.get("PADDLE_PORT", 0))

    def is_server(self):
        return self.role == "pserver"

    def is_worker(self):
        return self.role in ("trainer", "worker")


class _PSContext:
    role_maker: PSRoleMaker | None = None
    server: ParameterServer | None = None
    client: PSClient | None = None


_CTX = _PSContext()


def init(role=None, endpoints=None, worker_id=0):
    _CTX.role_maker = PSRoleMaker(role, endpoints, worker_id)
    return _CTX.role_maker


def is_server():
    return _CTX.role_maker is not None and _CTX.role_maker.is_server()


def is_worker():
    return _CTX.role_maker is not None and _CTX.role_maker.is_worker()


def init_server(load_dir=None, host="127.0.0.1", port=None):
    """Start this process's :class:`ParameterServer` (fleet.init_server;
    ``load_dir`` loads saved tables, the reference's incremental
    training)."""
    rm = _CTX.role_maker or init(role="pserver")
    _CTX.server = ParameterServer(
        host, rm.server_port if port is None else port).start()
    if load_dir:
        from .table import load_tables
        load_tables(_CTX.server.tables, load_dir)
    return _CTX.server


def run_server():
    """Serve until a worker's ``stop_worker()`` (fleet.run_server)."""
    if _CTX.server is None:
        raise RuntimeError("call init_server() before run_server()")
    _CTX.server.run()


def init_worker(endpoints=None):
    """Connect this trainer to the servers (fleet.init_worker)."""
    rm = _CTX.role_maker or init()
    _CTX.client = PSClient(endpoints or rm.endpoints)
    return _CTX.client


def stop_worker():
    """Stop the servers and close this worker's connections."""
    if _CTX.client is not None:
        _CTX.client.stop_servers()
        _CTX.client.close()
        _CTX.client = None


def client():
    if _CTX.client is None:
        raise RuntimeError("PS worker not initialized — call "
                           "ps.init_worker(endpoints)")
    return _CTX.client


def _torch(t):
    from ...core.tensor import unwrap
    return unwrap(t)


def _host(t):
    """``t`` (a port Tensor or Parameter, a torch tensor or an array) as
    a float32 numpy array."""
    t = _torch(t)
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _set(p, value):
    with torch.no_grad():
        t = _torch(p)
        t.copy_(torch.from_numpy(np.asarray(value)).to(t.device, t.dtype))


class SparseEmbedding:
    """An embedding whose table lives on the parameter servers
    (reference: python/paddle/static/nn/common.py sparse_embedding, the
    distributed lookup-table op).

    ``forward(ids)`` pulls the batch's unique rows, lands them on
    ``device`` (default: the ids' device, or the port's default device
    for host ids) as one ``[n_unique, dim]`` leaf that needs a gradient,
    and gathers it to ``ids``' shape + ``[dim]`` (``index_select``).
    ``push_step(lr)`` sends that leaf's gradient to the host and the
    servers, which apply their own optimizer (apply-on-push, as the
    reference's sparse accessors do)."""

    def __init__(self, name, num_embeddings, embedding_dim, ps_client=None,
                 optimizer="sgd", init_scale=0.01, device=None):
        self.name = name
        self.dim = int(embedding_dim)
        self.num = int(num_embeddings)  # advisory: the table is open-keyed
        self.device = device
        self._client = ps_client or client()
        self._client.create_sparse_table(name, self.dim,
                                         optimizer=optimizer,
                                         init_scale=init_scale)
        self._pulled = None
        self._ids = None

    def __call__(self, ids):
        return self.forward(ids)

    def forward(self, ids):
        from ...core.tensor import Tensor
        from ...device import default_device
        t = _torch(ids)
        if isinstance(t, torch.Tensor):
            ids_np = t.detach().cpu().numpy().astype(np.int64)
            device = self.device or t.device
        else:
            ids_np = np.asarray(t, np.int64)
            device = self.device or default_device()
        uniq, inv = np.unique(ids_np.reshape(-1), return_inverse=True)
        rows = self._client.pull_sparse(self.name, uniq)
        pulled = torch.from_numpy(rows).to(device).requires_grad_(True)
        self._pulled, self._ids = pulled, uniq
        out = pulled.index_select(0, torch.from_numpy(
            inv.reshape(-1)).to(device))
        return Tensor._wrap(out.reshape(*ids_np.shape, self.dim))

    def push_step(self, lr):
        """After ``loss.backward()``: push the pulled rows' gradients."""
        if self._pulled is None or self._pulled.grad is None:
            return
        self._client.push_sparse(self.name, self._ids,
                                 self._pulled.grad.detach().cpu().numpy(),
                                 lr)
        self._pulled = self._ids = None


class GeoTrainer:
    """GeoSGD for dense parameters (reference: GeoCommunicator,
    paddle/fluid/distributed/ps/service/communicator/communicator.h):
    local SGD, the parameter deltas pushed every k steps, the merged
    global parameters pulled back.

    Wraps a list of parameters (the port's or torch's); call :meth:`step`
    once an optimizer step."""

    def __init__(self, table_prefix, parameters, k_steps=4, ps_client=None):
        self._client = ps_client or client()
        self._params = list(parameters)
        self._k = int(k_steps)
        self._step = 0
        self._names = []
        self._base = []
        for i, p in enumerate(self._params):
            name = f"{table_prefix}.{i}"
            self._names.append(name)
            self._client.create_dense_table(name, tuple(_torch(p).shape))
            # the first worker's value wins on the server; every worker
            # then starts from the settled value
            self._client.dense_init_once(name, _host(p))
            server_val = self._client.pull_dense(name)
            _set(p, server_val)
            self._base.append(server_val.copy())

    def step(self):
        """Call after ``optimizer.step()``; every k-th call syncs."""
        self._step += 1
        if self._step % self._k:
            return False
        self.sync()
        return True

    def sync(self):
        """Push the local deltas and pull the merged global parameters
        (the communicator's flush; call it once more at the end of
        training so every worker ends on the same global state)."""
        for p, name, base in zip(self._params, self._names, self._base):
            self._client.push_dense_delta(name, _host(p) - base)
            _set(p, self._client.pull_dense(name))
        self._base = [_host(p).copy() for p in self._params]


__all__ = [
    "DenseTable", "GeoTrainer", "PSClient", "PSRoleMaker",
    "ParameterServer", "SparseEmbedding", "SparseTable", "client", "init",
    "init_server", "init_worker", "is_server", "is_worker", "run_server",
    "stop_worker",
]
