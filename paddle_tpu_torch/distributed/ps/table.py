"""Parameter-server tables (port of ``paddle_tpu/distributed/ps/table.py``;
reference: paddle/fluid/distributed/ps/table/memory_sparse_table.cc,
rows created on first touch with the optimizer applied on push, and
common_dense_table).

The tables live in host memory on the server processes: they hold the
parameters too large for the card (embedding tables of many millions
of rows); the card holds only the rows pulled for the current batch.
The optimizer state stays with the rows.  ``save``/``load`` write and
read the JAX package's ``.npz`` layout (``ids``, ``values``, ``dim``;
``value`` for a dense table), so either package loads the other's.

A table's initial rows come from ``seed`` and a stable hash of its name
(CRC-32), so every server process draws the same rows for the same
name; the JAX package seeds with Python's ``hash(name)``, which each
process randomises (ROADMAP.md C).  A pull creates the missing rows in
the order of their first appearance, drawn as one block: the same
values, row for row, as drawing them one at a time.
"""

from __future__ import annotations

import os
import threading
import zlib

import numpy as np


def _name_seed(name):
    return zlib.crc32(str(name).encode()) & 0x7FFFFFFF


class _SGD:
    name = "sgd"

    def apply(self, state, value, grad, lr):
        value -= lr * grad
        return value


class _Adagrad:
    """Per-row adagrad (the reference's sparse accessor default family)."""

    name = "adagrad"

    def __init__(self, eps=1e-8):
        self.eps = eps

    def apply(self, state, value, grad, lr):
        g2 = state.setdefault("g2", np.zeros_like(value))
        g2 += grad * grad
        value -= lr * grad / (np.sqrt(g2) + self.eps)
        return value


_OPTIMIZERS = {"sgd": _SGD, "adagrad": _Adagrad}


def make_optimizer(name):
    try:
        return _OPTIMIZERS[name]()
    except KeyError:
        raise ValueError(f"unknown PS table optimizer '{name}' "
                         f"(have {sorted(_OPTIMIZERS)})") from None


class SparseTable:
    """id -> embedding row, rows created on first pull (the reference's
    MemorySparseTable: unseen ids take the initializer's rows; ``entry``
    thresholds omitted).

    The rows are one float32 array that grows by doubling, with an
    id -> slot dict; the optimizer's per-row state (adagrad's ``g2``) is
    arrays of the same rows.  A pull gathers its slots; a push updates
    its slots as one block, for every optimizer: the same float32
    operations, element for element, as the JAX table's loop a row."""

    def __init__(self, name, dim, initializer="normal", init_scale=0.01,
                 optimizer="sgd", seed=0):
        self.name = name
        self.dim = int(dim)
        self.init_scale = float(init_scale)
        self.initializer = initializer
        self.optimizer = make_optimizer(optimizer)
        self._slot: dict[int, int] = {}
        self._values = np.zeros((0, self.dim), np.float32)
        self._state: dict[str, np.ndarray] = {}
        self._rng = np.random.RandomState(seed ^ _name_seed(name))
        self._lock = threading.Lock()

    def _init_rows(self, n):
        if self.initializer == "zeros":
            return np.zeros((n, self.dim), np.float32)
        return (self._rng.standard_normal((n, self.dim)) *
                self.init_scale).astype(np.float32)

    def _grown(self, arr, cap):
        out = np.zeros((cap, self.dim), np.float32)
        out[:len(self._slot)] = arr[:len(self._slot)]
        return out

    def _slots(self, ids):
        """The slots of ``ids`` (a list), the missing rows created in the
        order of their first appearance."""
        slot = self._slot
        missing = list(dict.fromkeys(v for v in ids if v not in slot))
        if missing:
            n, m = len(slot), len(missing)
            if n + m > len(self._values):
                cap = max(n + m, 2 * len(self._values))
                self._values = self._grown(self._values, cap)
                self._state = {k: self._grown(a, cap)
                               for k, a in self._state.items()}
            self._values[n:n + m] = self._init_rows(m)
            slot.update(zip(missing, range(n, n + m)))
        return np.fromiter((slot[v] for v in ids), np.int64, count=len(ids))

    def pull(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1).tolist()
        with self._lock:
            slots = self._slots(ids)
            return self._values[slots]

    def push(self, ids, grads, lr):
        """Apply the optimizer update for (possibly repeated) ids: a
        repeated id's gradients are summed first, as a dense embedding's
        backward sums them."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(ids.size, self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        acc = np.zeros((uniq.size, self.dim), np.float32)
        np.add.at(acc, inv.reshape(-1), grads)
        with self._lock:
            slots = self._slots(uniq.tolist())
            state = {k: a[slots] for k, a in self._state.items()}
            self._values[slots] = self.optimizer.apply(
                state, self._values[slots], acc, lr)
            for k, a in state.items():
                if k not in self._state:
                    self._state[k] = np.zeros_like(self._values)
                self._state[k][slots] = a

    def __len__(self):
        return len(self._slot)

    def save(self, path):
        with self._lock:
            ids = np.fromiter(self._slot, np.int64, count=len(self._slot))
            vals = self._values[:len(self._slot)]
            np.savez(path, ids=ids, values=vals, dim=self.dim)

    def load(self, path):
        data = np.load(path)
        ids = data["ids"].tolist()
        with self._lock:
            self._values = np.array(data["values"], np.float32).reshape(
                len(ids), self.dim)
            self._slot = dict(zip(ids, range(len(ids))))
            self._state = {}


class DenseTable:
    """A flat dense parameter block with add-delta (GeoSGD) and
    apply-gradient (a_sync) push modes."""

    def __init__(self, name, shape, initializer="zeros", init_scale=0.01,
                 optimizer="sgd", seed=0):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        if initializer == "zeros":
            self.value = np.zeros(self.shape, np.float32)
        else:
            rng = np.random.RandomState(seed ^ _name_seed(name))
            self.value = (rng.standard_normal(self.shape) *
                          init_scale).astype(np.float32)
        self.optimizer = make_optimizer(optimizer)
        self._state: dict = {}
        self._seeded = False
        self._lock = threading.Lock()

    def pull(self):
        with self._lock:
            return self.value.copy()

    def init_once(self, value):
        """Seed the table with the first caller's value; later callers
        are no-ops (the workers' GeoTrainer start-up race)."""
        with self._lock:
            if self._seeded:
                return False
            self.value = np.asarray(value, np.float32).reshape(self.shape)
            self._seeded = True
            return True

    def push_grad(self, grad, lr):
        with self._lock:
            self.value = self.optimizer.apply(
                self._state, self.value, np.asarray(grad, np.float32), lr)

    def push_delta(self, delta):
        """GeoSGD: the server adds the trainers' deltas (reference:
        ps/service/communicator — GeoCommunicator's push of parameter
        differences)."""
        with self._lock:
            self.value += np.asarray(delta, np.float32)

    def save(self, path):
        np.savez(path, value=self.pull())

    def load(self, path):
        with self._lock:
            self.value = np.load(path)["value"].astype(np.float32)


def save_tables(tables, dirname):
    os.makedirs(dirname, exist_ok=True)
    for t in tables.values():
        t.save(os.path.join(dirname, f"{t.name}.npz"))


def load_tables(tables, dirname):
    for t in tables.values():
        p = os.path.join(dirname, f"{t.name}.npz")
        if os.path.exists(p):
            t.load(p)


__all__ = ["DenseTable", "SparseTable", "load_tables", "make_optimizer",
           "save_tables"]
