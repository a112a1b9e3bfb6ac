"""The port's data pipeline (``paddle_tpu_torch.io``) against the JAX
package's.

* Samplers, ``BatchSampler(shuffle=True)``, ``random_split`` and
  ``DistributedBatchSampler`` (per rank and epoch) draw from numpy's
  global RNG (or a per-epoch ``RandomState``) with the same calls: under
  one ``np.random.seed`` the orders are equal, exactly.
* ``DataLoader`` with 0 and 2 worker threads gives the JAX loader's
  batches: equal values and dtypes (the port's are host tensors, the
  JAX package's device arrays; JAX, without x64, keeps int64 as int32),
  over numpy, int, float, tuple and dict
  samples, shuffled or not; a worker's exception reaches the consumer.
* ``DevicePrefetcher``'s skip-replay and ``consumed`` and
  ``StackingPrefetcher``'s windows (the partial tail, a break in the
  batch shape, a resumed offset) as the JAX package's
  (``tests/test_resilience.py``'s ``TestPrefetcherCursor``), on the CPU.
* ``io.native.collate_stack`` / ``gather_rows`` give numpy's
  ``np.stack`` / ``src[idx]`` (negative indices, out-of-bounds error,
  the index's shape).

Everything is compared exactly: no arithmetic happens on the values.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import io as jio
from paddle_tpu.profiler import counters as jcounters
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import native as tnative
from paddle_tpu_torch.profiler import counters as tcounters

SIDES = {"jax": (jio, jcounters), "torch": (tio, tcounters)}


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _np(x):
    """A batch leaf of either package as numpy."""
    if hasattr(x, "_data"):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _flat(batch):
    """A batch (nested tuples/lists/dicts) as a list of numpy leaves."""
    if isinstance(batch, dict):
        return [a for k in sorted(batch) for a in _flat(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [a for b in batch for a in _flat(b)]
    return [_np(batch)]


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        fx, fy = _flat(x), _flat(y)
        assert len(fx) == len(fy)
        for u, v in zip(fx, fy):
            # JAX runs without x64: its int64 arrays are int32
            assert u.dtype == v.dtype or (u.dtype, v.dtype) == (
                np.int64, np.int32)
            assert u.shape == v.shape
            np.testing.assert_array_equal(u, v)


class _Rows:
    """A map-style dataset of numpy rows, built the same for both."""

    def __init__(self, n, kind):
        rng = np.random.default_rng(n)
        self.x = rng.standard_normal((n, 3)).astype(np.float32)
        self.y = rng.integers(0, 9, n)
        self.kind = kind

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        if self.kind == "array":
            return self.x[i]
        if self.kind == "tuple":
            return self.x[i], int(self.y[i]), float(self.x[i, 0])
        return {"x": self.x[i], "y": np.int64(self.y[i])}


def _dataset(io, n, kind):
    ds = _Rows(n, kind)
    return type("Rows", (io.Dataset,), {
        "__len__": lambda self: len(ds), "__getitem__":
        lambda self, i: ds[i]})()


# -- samplers ----------------------------------------------------------------
def _sampler_cases():
    return {
        "sequence": lambda io, ds: io.SequenceSampler(ds),
        "random": lambda io, ds: io.RandomSampler(ds),
        "random_num_samples": lambda io, ds: io.RandomSampler(
            ds, num_samples=7),
        "random_replacement": lambda io, ds: io.RandomSampler(
            ds, replacement=True, num_samples=30),
        "weighted": lambda io, ds: io.WeightedRandomSampler(
            np.linspace(0.1, 2.0, 13), 20),
        "weighted_no_replacement": lambda io, ds: io.WeightedRandomSampler(
            np.linspace(0.1, 2.0, 13), 9, replacement=False),
        "subset_random": lambda io, ds: io.SubsetRandomSampler(
            [3, 1, 4, 1, 5, 9, 2, 6]),
        "batch_shuffle": lambda io, ds: io.BatchSampler(
            ds, shuffle=True, batch_size=4),
        "batch_drop_last": lambda io, ds: io.BatchSampler(
            sampler=io.RandomSampler(ds), batch_size=5, drop_last=True),
    }


@pytest.mark.parametrize("case", sorted(_sampler_cases()))
def test_sampler_orders_equal_jax(case):
    out = {}
    for name, (io, _) in SIDES.items():
        np.random.seed(11)
        s = _sampler_cases()[case](io, _dataset(io, 13, "array"))
        out[name] = ([list(s) for _ in range(2)], len(s))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("lengths", [[5, 8], [0.3, 0.7], [13]])
def test_random_split_equal_jax(lengths):
    out = {}
    for name, (io, _) in SIDES.items():
        np.random.seed(5)
        ds = _dataset(io, 13, "array")
        parts = io.random_split(ds, lengths)
        out[name] = [(list(p.indices), len(p)) for p in parts]
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_distributed_batch_sampler_per_rank_and_epoch(shuffle, drop_last):
    out = {}
    for name, (io, _) in SIDES.items():
        ds = _dataset(io, 23, "array")
        per = []
        for rank in range(3):
            s = io.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                           shuffle=shuffle,
                                           drop_last=drop_last)
            for epoch in (0, 1):
                s.set_epoch(epoch)
                per.append((rank, epoch, list(s), len(s)))
        out[name] = per
    assert out["torch"] == out["jax"]


def test_what_a7_owns_raises_naming_it():
    """What A7 owned in ``io`` works since the mesh slice: a
    ``DistributedBatchSampler`` without ``num_replicas``/``rank`` asks
    the process group (none here: one replica, rank 0, as the JAX
    sampler answers in one process), and ``sharding=`` takes a partition
    spec on a mesh; a ``sharding=`` that is no spec raises ``TypeError``
    naming what it wants.  The sharded values are held against the JAX
    prefetchers in ``tests/test_torch_mesh_train.py``."""
    ds = _dataset(tio, 4, "array")
    s = tio.DistributedBatchSampler(ds, 2)
    js = jio.DistributedBatchSampler(_dataset(jio, 4, "array"), 2)
    assert (s.nranks, s.local_rank) == (js.nranks, js.local_rank) == (1, 0)
    assert list(s) == list(js)
    for cls in (tio.DevicePrefetcher, tio.StackingPrefetcher):
        args = (2,) if cls is tio.StackingPrefetcher else ()
        with pytest.raises(TypeError, match="partition spec"):
            cls(tio.DataLoader(ds), *args, sharding=object())


def test_dataset_kinds_equal_jax():
    out = {}
    for name, (io, _) in SIDES.items():
        a, b = _dataset(io, 5, "array"), _dataset(io, 7, "array")
        cat = io.ConcatDataset([a, b])
        comp = io.ComposeDataset([a, b])
        sub = io.Subset(b, [6, 0, 3])
        chain = io.ChainDataset([[1, 2], [3]])
        out[name] = ([_np(cat[i]) for i in (0, 4, 5, 11, -1)], len(cat),
                     [list(map(_np, comp[i])) for i in range(len(comp))],
                     [_np(sub[i]) for i in range(len(sub))], [c for c in chain],
                     io.get_worker_info())
    t, j = out["torch"], out["jax"]
    assert repr(t) == repr(j)


# -- the loader --------------------------------------------------------------
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("kind", ["array", "tuple", "dict"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_equal_jax(workers, kind, shuffle):
    out = {}
    for name, (io, _) in SIDES.items():
        np.random.seed(3)
        loader = io.DataLoader(_dataset(io, 11, kind), batch_size=4,
                               shuffle=shuffle, num_workers=workers)
        out[name] = (len(loader), list(loader))
    assert out["torch"][0] == out["jax"][0]
    _same_batches(out["torch"][1], out["jax"][1])
    for b in out["torch"][1]:
        assert all(not (isinstance(x, torch.Tensor) and x.is_cuda)
                   for x in _flat_torch(b))


def _flat_torch(batch):
    if isinstance(batch, dict):
        return [a for v in batch.values() for a in _flat_torch(v)]
    if isinstance(batch, (list, tuple)):
        return [a for b in batch for a in _flat_torch(b)]
    return [batch._data if hasattr(batch, "_data") else batch]


def test_tensor_dataset_and_iterable_dataset_equal_jax():
    out = {}
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    y = np.arange(10)
    for name, (io, _) in SIDES.items():
        pkg = jp if name == "jax" else tp
        ds = io.TensorDataset([pkg.to_tensor(x), pkg.to_tensor(y)])

        class Stream(io.IterableDataset):
            def __iter__(self):
                return iter(x[i] for i in range(7))
        out[name] = (list(io.DataLoader(ds, batch_size=3, num_workers=2)),
                     list(io.DataLoader(Stream(), batch_size=3)),
                     list(io.DataLoader(Stream(), batch_size=3,
                                        drop_last=True)))
    for a, b in zip(out["torch"], out["jax"]):
        _same_batches(a, b)


def test_worker_exception_reaches_the_consumer():
    class Bad(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("row 5 is unreadable")
            return np.full(2, i, np.float32)

    it = iter(tio.DataLoader(Bad(), batch_size=2, num_workers=2))
    got = [_np(next(it)) for _ in range(2)]
    np.testing.assert_array_equal(got[1], [[2, 2], [3, 3]])
    with pytest.raises(KeyError, match="row 5"):
        next(it)


def test_loader_delivers_in_order_under_backpressure():
    """More batches than ``prefetch_factor * workers`` in flight, slow
    and fast rows mixed: sampler order, none lost."""
    import time

    class Slow(tio.Dataset):
        def __len__(self):
            return 40

        def __getitem__(self, i):
            if i % 7 == 0:
                time.sleep(0.002)
            return np.array([i], np.int64)

    got = [int(_np(b)[0, 0]) for b in tio.DataLoader(
        Slow(), batch_size=1, num_workers=4, prefetch_factor=2)]
    assert got == list(range(40))


# -- the prefetchers ---------------------------------------------------------
def _xy(io, pkg, n_batches, batch=4, seed=3):
    rng = np.random.RandomState(seed)
    return io.TensorDataset(
        [pkg.to_tensor(rng.randn(n_batches * batch, 6).astype("float32")),
         pkg.to_tensor(rng.randn(n_batches * batch, 3).astype("float32"))])


def _pkg(name):
    return jp if name == "jax" else tp


def test_device_prefetcher_skip_replay_as_jax():
    out = {}
    for name, (io, counters) in SIDES.items():
        ds = _xy(io, _pkg(name), 6)
        full = list(io.DevicePrefetcher(io.DataLoader(ds, batch_size=4),
                                        depth=2))
        before = counters.snapshot()
        pref = io.DevicePrefetcher(io.DataLoader(ds, batch_size=4), depth=2,
                                   start_offset=2)
        n = len(pref)
        got = list(pref)
        d = counters.delta(before)
        out[name] = (full, got, n, pref.consumed,
                     d.get("io.skipped_batches", 0),
                     d.get("io.device_put_calls", 0))
    t, j = out["torch"], out["jax"]
    _same_batches(t[0], j[0])
    _same_batches(t[1], j[1])
    _same_batches(t[1], t[0][2:])
    assert t[2:] == j[2:] == (4, 6, 2, 8)


@pytest.mark.parametrize("n_batches,offset", [(8, 0), (8, 4), (7, 0),
                                              (7, 2)])
def test_stacking_prefetcher_windows_as_jax(n_batches, offset):
    """Full windows, a partial tail (7 batches) and a resumed offset."""
    out = {}
    for name, (io, _) in SIDES.items():
        ds = _xy(io, _pkg(name), n_batches)
        pref = io.StackingPrefetcher(io.DataLoader(ds, batch_size=4), 2,
                                     start_offset=offset)
        n = len(pref)
        wins = list(pref)
        out[name] = ([w.k for w in wins], wins, n, pref.consumed)
    t, j = out["torch"], out["jax"]
    assert (t[0], t[2], t[3]) == (j[0], j[2], j[3])
    _same_batches(t[1], j[1])


def test_stacking_prefetcher_flushes_on_a_shape_break_as_jax():
    """10 rows in batches of 4: 4, 4, 2 (``drop_last=False``); windows
    of 2 give [4, 4] and then the remainder alone."""
    out = {}
    for name, (io, _) in SIDES.items():
        ds = io.TensorDataset([_pkg(name).to_tensor(
            np.arange(30, dtype=np.float32).reshape(10, 3))])
        wins = list(io.StackingPrefetcher(io.DataLoader(ds, batch_size=4),
                                          2))
        out[name] = ([w.k for w in wins], [tuple(_np(a).shape for a in w)
                                            for w in wins], wins)
    assert out["torch"][:2] == out["jax"][:2] == (
        [2, 1], [((2, 4, 3),), ((1, 2, 3),)])
    _same_batches(out["torch"][2], out["jax"][2])


def test_prefetchers_place_numpy_and_host_leaves_on_the_target_device():
    """Numpy leaves come out as ``Tensor``s, torch leaves as torch
    tensors, on the target device (here the CPU); values unchanged."""
    batches = [(np.full((2, 3), i, np.int64), torch.full((2,), float(i)))
               for i in range(3)]
    got = list(tio.DevicePrefetcher(batches, depth=2, device="cpu"))
    for (a, b), (x, y) in zip(batches, got):
        assert isinstance(x, tp.Tensor) and x._data.device.type == "cpu"
        np.testing.assert_array_equal(_np(x), a)
        assert isinstance(y, torch.Tensor) and torch.equal(y, b)


# -- native collation --------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "int64", "uint8", "bool",
                                   "float16"])
def test_collate_stack_is_np_stack(dtype):
    rng = np.random.default_rng(1)
    arrays = [(rng.standard_normal((5, 7)) * 50).astype(dtype)
              for _ in range(6)]
    got = tnative.collate_stack(arrays)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.stack(arrays))
    ro = [a.copy() for a in arrays]
    for a in ro:
        a.setflags(write=False)
    np.testing.assert_array_equal(tnative.collate_stack(ro).numpy(),
                                  np.stack(arrays))
    # mixed dtypes take numpy's promotion; mixed shapes numpy's error
    mixed = [arrays[0], arrays[1].astype(np.float64)]
    np.testing.assert_array_equal(tnative.collate_stack(mixed).numpy(),
                                  np.stack(mixed))
    with pytest.raises(ValueError):
        tnative.collate_stack([arrays[0], arrays[0][:2]])


@pytest.mark.parametrize("idx", [[3, 0, 9, 3], [[1, -1], [-10, 2]], [],
                                 np.int64(4)])
def test_gather_rows_is_numpy_indexing(idx):
    src = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
    got = tnative.gather_rows(src, idx)
    want = src[np.asarray(idx, np.int64)]
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_rows_out_of_bounds_raises():
    src = np.zeros((5, 2), np.float32)
    for bad in ([5], [-6]):
        with pytest.raises(IndexError):
            tnative.gather_rows(src, bad)


def test_torch_tensor_samples_stack_where_they_lie():
    """A dataset of torch tensors (the port's arrays where the JAX
    package's datasets hold numpy rows) batches into torch tensors."""
    rows = np.arange(20, dtype=np.float32).reshape(10, 2)

    class Rows(tio.Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return torch.from_numpy(rows[i]), i

    got = list(tio.DataLoader(Rows(), batch_size=4))
    assert [tuple(b[0].shape) for b in got] == [(4, 2), (4, 2), (2, 2)]
    for x, i in got:
        assert isinstance(x, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), rows[_np(i)])
