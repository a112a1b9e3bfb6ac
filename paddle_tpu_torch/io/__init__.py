"""The data pipeline (port of ``paddle_tpu/io/__init__.py``; reference:
python/paddle/io/, Dataset/DataLoader and the multiprocess workers'
async staging).

The host side is the JAX package's: datasets, the samplers (drawing
from numpy's global RNG with the same calls, so one ``np.random.seed``
gives the JAX package's orders), ``default_collate_fn`` and the
``DataLoader``, whose workers are threads that deliver batches in order
under backpressure and hand a worker's exception to the consumer.

The device side differs.  The JAX ``DataLoader`` hands out device
arrays and ``DevicePrefetcher`` issues ``jax.device_put`` for batch
N+1 while step N runs.  Here the ``DataLoader``'s batches stay on the
host (``default_collate_fn`` stacks them into pinned memory where CUDA
is, ``io.native``), and ``DevicePrefetcher`` moves them: each host leaf
is copied to the card with a ``non_blocking`` copy on a CUDA stream of
its own, from pinned memory (a leaf in pageable memory is pinned
first: a copy from pageable memory is not asynchronous), and the batch
is handed out ``depth - 1`` batches later, after the consumer's stream
has waited on the copy's event.  ``StackingPrefetcher`` stacks ``k``
staged batches into a ``Window`` with ``torch.stack`` on the card.
Values are bit for bit the loader's.

On a mesh (``distributed.build_mesh``), ``sharding=`` (a partition
spec such as ``P("dp")``, or a ``(mesh, spec)`` pair) gives each rank
its rows of every leaf: the rank's piece of each split dimension, cut
on the host before the copy; a leaf whose dimension does not divide
stays whole (replicated), as the JAX prefetchers leave it.  The staged
tensors carry ``_local_rows = True``, and ``jit.CompiledTrainStep``
does not split them again.  ``DistributedBatchSampler`` without
``num_replicas``/``rank`` reads them from the process group.
"""

from __future__ import annotations

import itertools
import threading
import time as _time
import weakref
from collections import deque

import numpy as np
import torch

from ..core.tensor import Tensor
from ..profiler import counters as _counters
from ..profiler import host_tracer as _trace
from ..profiler import metrics as _metrics


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Random disjoint subsets of the given lengths (or fractions summing
    to 1); the permutation is numpy's global ``np.random.permutation``,
    as in JAX (``generator`` is accepted and unused there too)."""
    lengths = list(lengths)
    if all(isinstance(n, float) for n in lengths) \
            and abs(sum(lengths) - 1) < 1e-6:
        n = len(dataset)
        lengths = [int(np.floor(n * f)) for f in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(len(dataset)).tolist()
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n]))
        ofs += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, uniform draws) from
    numpy's global RNG; ``generator`` is accepted and unused, as in
    JAX."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num = num_samples

    @property
    def num_samples(self):
        return self._num if self._num is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


def _numpy(x):
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(_numpy(weights), dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(p), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """A fixed index subset in random order (reference: io/sampler.py
    SubsetRandomSampler)."""

    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        order = np.random.permutation(len(self.indices))
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards indices across data-parallel ranks (reference:
    io/dataloader/batch_sampler.py DistributedBatchSampler).
    ``num_replicas`` and ``rank`` default to the process group's world
    size and rank (1 and 0 without one)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed.env import get_rank, get_world_size
        if num_replicas is None:
            num_replicas = get_world_size()
        if rank is None:
            rank = get_rank()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate(
            [indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Stack a list of samples into a batch on the host: numpy arrays
    and numbers become a ``Tensor`` over host memory (pinned where CUDA
    is), ``Tensor`` and ``torch.Tensor`` samples are stacked where they
    lie, tuples, lists and dicts recurse."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        from .native import collate_stack
        return Tensor._wrap(collate_stack(batch))
    if isinstance(sample, Tensor):
        return Tensor._wrap(torch.stack([t._data for t in batch]))
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return Tensor._wrap(torch.from_numpy(np.asarray(batch, np.int64)))
    if isinstance(sample, (float, np.floating)):
        return Tensor._wrap(torch.from_numpy(np.asarray(batch, np.float32)))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


class _PrefetchIter:
    """Background-thread prefetcher, the BlockingQueue analogue
    (reference: io/dataloader/dataloader_iter.py:365 multiprocess loop):
    ``num_workers`` threads fetch batches, delivered in sampler order,
    at most ``prefetch_factor * num_workers`` ahead."""

    def __init__(self, loader, index_iter):
        self._loader = loader
        self._index_iter = index_iter
        self._index_lock = threading.Lock()
        self._stop = threading.Event()
        self._seq = itertools.count()
        self._results = {}
        self._cv = threading.Condition()
        self._next_emit = 0
        n = max(1, loader.num_workers)
        self._max_pending = max(2, loader.prefetch_factor) * n
        self._threads = []
        # Workers start after all the state above exists (they touch
        # _cv/_results at once) and hold only a weakref to self, so an
        # abandoned iterator is collectable and its workers exit.
        wref = weakref.ref(self)
        for _ in range(n):
            t = threading.Thread(target=_PrefetchIter._worker_main,
                                 args=(wref,), daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _worker_main(wref):
        strong = wref()
        if strong is None:
            return
        # long-lived primitives; none of these keep the iterator alive
        cv = strong._cv
        stop = strong._stop
        index_lock = strong._index_lock
        index_iter = strong._index_iter
        seq_counter = strong._seq
        del strong
        try:
            while not stop.is_set():
                sampler_err = None
                with index_lock:
                    try:
                        indices = next(index_iter)
                    except StopIteration:
                        break
                    except Exception as e:  # broken batch_sampler: deliver,
                        sampler_err = e     # don't silently truncate
                    seq = next(seq_counter)

                # backpressure: at most _max_pending undelivered batches;
                # the predicate re-resolves the weakref so a blocked
                # worker never pins an abandoned iterator
                def _ready():
                    st = wref()
                    return (st is None or stop.is_set()
                            or seq - st._next_emit < st._max_pending)

                with cv:
                    while not cv.wait_for(_ready, timeout=0.5):
                        pass
                s = wref()
                if s is None or stop.is_set():
                    return
                if sampler_err is not None:
                    batch = sampler_err
                else:
                    try:
                        batch = s._fetch(indices)
                    except Exception as e:  # delivered to the consumer
                        batch = e
                with cv:
                    s._results[seq] = batch
                    cv.notify_all()
                if isinstance(batch, Exception):
                    break
                del s
        finally:
            # a worker ending for any reason must not leave the consumer
            # blocked
            s = wref()
            if s is not None:
                with cv:
                    s._results.setdefault("done", None)
                    cv.notify_all()

    def _fetch(self, indices):
        with _trace.span("io.reader"):
            data = [self._loader.dataset[i] for i in indices]
            cf = self._loader.collate_fn or default_collate_fn
            return cf(data)

    def __next__(self):
        t0 = _time.perf_counter_ns()
        with self._cv:
            while True:
                if self._next_emit in self._results:
                    batch = self._results.pop(self._next_emit)
                    self._next_emit += 1
                    self._cv.notify_all()  # wake backpressured workers
                    _metrics.observe("io.queue_wait_ns",
                                     _time.perf_counter_ns() - t0,
                                     unit="ns", sum_counter=True)
                    if isinstance(batch, Exception):
                        raise batch
                    return batch
                if "done" in self._results and not any(
                        isinstance(k, int) and k >= self._next_emit
                        for k in self._results):
                    if not any(t.is_alive() for t in self._threads):
                        raise StopIteration
                self._cv.wait(timeout=0.05)

    def __iter__(self):
        return self

    def __del__(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()  # wake backpressured workers to exit


class DataLoader:
    """reference: python/paddle/io/reader.py:216 DataLoader.  Batches
    are on the host; ``DevicePrefetcher`` moves them to the card."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self._is_iterable = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif self._is_iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._is_iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _iter_iterable(self):
        cf = self.collate_fn or default_collate_fn
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield cf(batch)
                batch = []
        if batch and not getattr(self, "drop_last", False):
            yield cf(batch)

    def __iter__(self):
        if self._is_iterable:
            return self._iter_iterable()
        index_iter = iter(self.batch_sampler)
        if self.num_workers == 0:
            def gen():
                cf = self.collate_fn or default_collate_fn
                for indices in index_iter:
                    with _trace.span("io.reader"):
                        batch = cf([self.dataset[i] for i in indices])
                    yield batch
            return gen()
        return _PrefetchIter(self, index_iter)


def _rows_of(sharding):
    """A function giving this rank's rows of a host tensor under
    ``sharding`` (a spec on the global mesh or ``(mesh, spec)``), or
    None without one."""
    if sharding is None:
        return None
    from ..distributed.env import get_mesh
    from ..distributed.sharding_utils import P, local_shard, validate_spec
    mesh, spec = (sharding if isinstance(sharding, tuple)
                  and not isinstance(sharding, P) else (get_mesh(), sharding))
    if mesh is None or not isinstance(spec, tuple):
        raise TypeError(f"sharding={sharding!r}: want a partition spec "
                        "(distributed.P) on the global mesh, or (mesh, spec)")

    def rows(t):
        rspec = validate_spec(spec, tuple(t.shape), mesh, quiet=True)
        out = local_shard(t, rspec, mesh)
        if out is not t:
            _counters.inc("dist.device_put_sharded_bytes",
                          int(out.numel() * out.element_size()))
        return out
    return rows


def _target_device(device):
    from ..device import default_device
    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DevicePrefetcher:
    """Depth-``depth`` device buffer over any batch iterable.

    Wrap a DataLoader (or any iterable yielding ``Tensor``s,
    ``torch.Tensor``s, numpy arrays, or tuples/lists/dicts of them) and
    iterate the wrapper: each host batch is copied to ``device``
    (default: the default device) the moment the loader produces it and
    handed to the consumer ``depth - 1`` batches later.  On CUDA the
    copies run on the prefetcher's own stream from pinned memory, so the
    copy of batch N+1 overlaps step N; the consumer's current stream
    waits on the batch's copy event when the batch is handed out, and
    each copied tensor is recorded on that stream so the allocator keeps
    it until the stream is done with it.  Leaves already on ``device``
    pass through.  Numpy leaves come out as ``Tensor``s.  Values are bit
    for bit the loader's.

        loader = paddle_tpu_torch.io.DataLoader(ds, batch_size=64)
        for x, y in paddle_tpu_torch.io.DevicePrefetcher(loader, depth=2):
            loss = compiled_step(x, y)

    Resume cursor (``resilience.CheckpointManager``): ``consumed`` counts
    batches handed to the consumer (buffered ones do not count: nothing
    trained on them), the exact offset to checkpoint.  Passing it back as
    ``start_offset`` on a fresh prefetcher over a deterministic loader
    replays the epoch to that position: skipped batches are pulled from
    the loader but neither copied nor handed out, and are counted under
    ``io.skipped_batches`` (and in ``skipped``, this prefetcher's own
    count).

    Counters, under the JAX names: ``io.device_put_calls`` and
    ``io.device_put_bytes`` (one a leaf placed), ``io.reader_ns``, the
    ``io.prefetch_stall_ns`` histogram (reader waits while no batch was
    buffered), ``io.skipped_batches``; with ``sharding=``,
    ``dist.device_put_sharded_bytes`` (the bytes of the rows a rank
    keeps).
    """

    def __init__(self, loader, depth=2, device=None, start_offset=0,
                 sharding=None):
        self._rows = _rows_of(sharding)
        self.loader = loader
        self.depth = max(1, int(depth))
        self.device = device
        self.start_offset = max(0, int(start_offset))
        self.consumed = self.start_offset
        self.skipped = 0
        self._stream = None

    def __len__(self):
        return max(0, len(self.loader) - self.start_offset)

    def _put(self, t, dev, copied):
        if self._rows is not None:
            t = self._rows(t)
        out = self._copy(t, dev, copied)
        if self._rows is not None:
            out._local_rows = True
        return out

    def _copy(self, t, dev, copied):
        _counters.inc("io.device_put_calls")
        _counters.inc("io.device_put_bytes",
                      int(t.numel() * t.element_size()))
        if t.device == dev:
            return t
        if dev.type != "cuda":
            return t.to(dev)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        with torch.cuda.stream(self._stream):
            out = t.to(dev, non_blocking=True)
        copied.append(out)
        return out

    def _stage(self, batch, dev, copied):
        if isinstance(batch, Tensor):
            return Tensor._wrap(self._put(batch._data, dev, copied))
        if isinstance(batch, torch.Tensor):
            return self._put(batch, dev, copied)
        if isinstance(batch, (np.ndarray, np.generic)):
            from .native import _as_torch
            return Tensor._wrap(self._put(_as_torch(np.asarray(batch)), dev,
                                          copied))
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._stage(b, dev, copied) for b in batch)
        if isinstance(batch, dict):
            return {k: self._stage(v, dev, copied) for k, v in batch.items()}
        return batch

    def _staged(self, batch, dev):
        """``(staged batch, copy event, copied tensors)``."""
        copied = []
        if dev.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        staged = self._stage(batch, dev, copied)
        event = None
        if copied:
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event, copied

    @staticmethod
    def _ready(entry, dev):
        staged, event, copied = entry
        if event is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(event)
            for t in copied:
                t.record_stream(stream)
        return staged

    def __iter__(self):
        dev = _target_device(self.device)
        buf = deque()
        it = iter(self.loader)
        self.consumed = self.start_offset
        if self.start_offset:
            # replay to the offset: skipped batches are only pulled from
            # the loader, never copied
            with _trace.span("io.skip_replay"):
                skipped = 0
                for _ in range(self.start_offset):
                    try:
                        next(it)
                    except StopIteration:
                        break
                    skipped += 1
                self.skipped += skipped
                _counters.inc("io.skipped_batches", skipped)
        while True:
            with _trace.span("io.prefetcher"):
                t0 = _time.perf_counter_ns()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                wait = _time.perf_counter_ns() - t0
                # a reader wait is a stall only when nothing is buffered;
                # otherwise the copy already in flight hides it
                _counters.inc("io.reader_ns", wait)
                if not buf:
                    _metrics.observe("io.prefetch_stall_ns", wait,
                                     unit="ns", sum_counter=True)
                with _trace.span("io.device_put"):
                    buf.append(self._staged(batch, dev))
            if len(buf) >= self.depth:
                self.consumed += 1
                yield self._ready(buf.popleft(), dev)
        while buf:
            self.consumed += 1
            yield self._ready(buf.popleft(), dev)


class Window(tuple):
    """A window of ``k`` training batches stacked along a new leading
    axis, for ``jit.CompiledTrainStep(..., fused_steps=k)``.

    A ``Window`` is the tuple of stacked step arguments (``step(*w)``
    unpacks them) and carries the window length as ``.k``, so a partial
    tail window (a loader whose length is no multiple of k) describes
    itself: the step runs it as single steps instead of dropping or
    padding batches."""

    def __new__(cls, args, k):
        self = tuple.__new__(cls, tuple(args))
        self.k = int(k)
        return self


class StackingPrefetcher:
    """Window feeder for fused multi-step dispatch: stages the next ``k``
    batches on the device (through a ``DevicePrefetcher``) and stacks
    them into one ``Window`` with ``torch.stack`` on the device.

        loader = paddle_tpu_torch.io.DataLoader(ds, batch_size=64)
        step = jit.CompiledTrainStep(model, loss_fn, opt, fused_steps=4)
        for w in paddle_tpu_torch.io.StackingPrefetcher(loader, k=4):
            losses = step(w)      # one CUDA-graph replay for 4 steps

    The graph then copies the window into its static inputs: a second
    device copy of each window (``PERF.md`` §5).

    Drain edge: when the loader length is no multiple of ``k``, or a
    batch changes shape or structure (a ``drop_last=False`` remainder),
    what has accumulated is emitted as a partial ``Window`` (``w.k <
    k``), never dropped or padded; the step runs it as single steps.
    ``consumed`` counts underlying batches of the windows handed out.
    ``sharding=`` stages each batch's rows of this rank (see
    ``DevicePrefetcher``), so a window holds ``[k, rows, ...]``: the
    window axis whole, the batch axis split.
    """

    def __init__(self, loader, k, depth=None, device=None, start_offset=0,
                 sharding=None):
        self.loader = loader
        self.k = max(1, int(k))
        # double-buffered in windows: the next window's batches stage
        # while the current one runs
        depth = 2 * self.k if depth is None else max(1, int(depth))
        self.start_offset = max(0, int(start_offset))
        self._pref = DevicePrefetcher(loader, depth=depth, device=device,
                                      start_offset=self.start_offset,
                                      sharding=sharding)
        self.consumed = self.start_offset

    def __len__(self):
        n = max(0, len(self.loader) - self.start_offset)
        return (n + self.k - 1) // self.k

    @staticmethod
    def _spec(batch):
        if isinstance(batch, Tensor):
            batch = batch._data
        if isinstance(batch, torch.Tensor):
            return ("t", tuple(batch.shape), str(batch.dtype))
        if isinstance(batch, (list, tuple)):
            return tuple(StackingPrefetcher._spec(b) for b in batch)
        if isinstance(batch, dict):
            return {k: StackingPrefetcher._spec(v)
                    for k, v in sorted(batch.items())}
        return ("py", type(batch).__name__)

    def _stack(self, items):
        first = items[0]
        if isinstance(first, Tensor):
            return Tensor._wrap(self._stack([t._data for t in items]))
        if isinstance(first, torch.Tensor):
            out = torch.stack(items)
            if getattr(first, "_local_rows", False):
                out._local_rows = True
            return out
        if isinstance(first, (list, tuple)):
            return type(first)(self._stack([b[i] for b in items])
                               for i in range(len(first)))
        if isinstance(first, dict):
            return {k: self._stack([b[k] for b in items]) for k in first}
        dev = _target_device(self._pref.device)
        return Tensor._wrap(torch.stack([torch.as_tensor(x, device=dev)
                                         for x in items]))

    def _emit(self, batches):
        with _trace.span("io.stack_window"):
            _counters.inc("io.stack_windows")
            _counters.inc("io.stack_batches", len(batches))
            stacked = self._stack(batches)
            args = stacked if isinstance(stacked, tuple) else (stacked,)
            self.consumed += len(batches)
            return Window(args, len(batches))

    def __iter__(self):
        pending = []
        spec0 = None
        self.consumed = self.start_offset
        for staged in self._pref:
            s = self._spec(staged)
            if pending and s != spec0:
                # a shape or structure break: flush what accumulated as a
                # partial window
                yield self._emit(pending)
                pending = []
            if not pending:
                spec0 = s
            pending.append(staged)
            if len(pending) == self.k:
                yield self._emit(pending)
                pending = []
        if pending:
            # the loader's length is no multiple of k: a partial tail
            yield self._emit(pending)


def get_worker_info():
    return None


__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "DataLoader", "Dataset", "DevicePrefetcher",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "StackingPrefetcher", "Subset",
           "SubsetRandomSampler", "TensorDataset", "WeightedRandomSampler",
           "Window", "default_collate_fn", "get_worker_info",
           "random_split"]
