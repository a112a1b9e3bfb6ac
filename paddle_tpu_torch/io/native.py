"""Batch collation into host memory the device copy can read directly
(port of ``paddle_tpu/io/native.py``).

The JAX package builds a threaded C++ copy engine (``_native/
collate.cc``) for these two functions.  Here torch's CPU ops are that
threaded copy: ``torch.stack`` and ``torch.index_select`` write straight
into a tensor in pinned (page-locked) memory when CUDA is available, so
``io.DevicePrefetcher`` can copy the batch to the card asynchronously
without first copying it into pinned memory itself.  Without CUDA the
output is ordinary host memory.  Both return a ``torch.Tensor`` on the
CPU whose values are numpy's ``np.stack(arrays)`` / ``src[idx]``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def _host_empty(shape, dtype):
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.cuda.is_available())


def _as_torch(a):
    """A numpy array (or a CPU tensor) as a CPU tensor sharing its
    memory; numpy dtypes torch lacks raise ``TypeError``."""
    if isinstance(a, torch.Tensor):
        return a
    with warnings.catch_warnings():
        # a read-only array (np.load's mmap, a broadcast view): torch
        # warns that it cannot guard writes, and only reads it here
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a))


def collate_stack(arrays):
    """``np.stack(arrays)`` as a host tensor (pinned where CUDA is).
    Items of one shape and dtype are stacked by torch into the output;
    anything else goes through ``np.stack`` (numpy's promotion and
    errors) first."""
    first = arrays[0]
    if any(np.shape(a) != np.shape(first)
           or getattr(a, "dtype", None) != getattr(first, "dtype", None)
           for a in arrays) or not isinstance(first, (np.ndarray,
                                                      torch.Tensor)):
        return _pin(_as_torch(np.stack(arrays)))
    items = [_as_torch(a) for a in arrays]
    out = _host_empty((len(items),) + tuple(items[0].shape), items[0].dtype)
    torch.stack(items, out=out)
    return out


def _pin(t):
    return t.pin_memory() if torch.cuda.is_available() else t


def gather_rows(src, idx):
    """``src[idx]`` along dim 0 as a host tensor (pinned where CUDA is):
    negative indices wrap, an index out of bounds raises ``IndexError``
    (numpy's rules), the shape is ``idx.shape + src.shape[1:]``."""
    src = _as_torch(src)
    idx = np.asarray(idx, np.int64)
    nrows = src.shape[0]
    idx = np.where(idx < 0, idx + nrows, idx)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= nrows):
        raise IndexError(
            f"gather_rows: index out of bounds for axis 0 of size {nrows}")
    flat = torch.from_numpy(np.ascontiguousarray(idx.reshape(-1)))
    out = _host_empty((flat.numel(),) + tuple(src.shape[1:]), src.dtype)
    torch.index_select(src, 0, flat, out=out)
    return out.reshape(idx.shape + tuple(src.shape[1:]))


__all__ = ["collate_stack", "gather_rows"]
