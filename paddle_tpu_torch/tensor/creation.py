"""Creation ops (port of the parts of ``paddle_tpu/tensor/creation.py``
this slice calls): new tensors land on the default device, ``*_like``
ones on their model's."""

from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor, to_tensor  # noqa: F401
from ..device import default_device


def _dt(dtype, default=torch.float32):
    d = dtypes.convert_dtype(dtype)
    return default if d is None else d


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    if isinstance(shape, int):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def zeros(shape, dtype=None, name=None):
    return Tensor._wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                                    device=default_device()))


def ones(shape, dtype=None, name=None):
    return Tensor._wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                                   device=default_device()))


def full(shape, fill_value, dtype=None, name=None):
    """A float fill without a dtype is float32, an int one int64."""
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    d = dtypes.convert_dtype(dtype)
    if d is None:
        d = (torch.float32 if isinstance(fill_value, float) else
             torch.bool if isinstance(fill_value, bool) else torch.int64)
    return Tensor._wrap(torch.full(_shape(shape), fill_value, dtype=d,
                                   device=default_device()))


def zeros_like(x, dtype=None, name=None):
    return Tensor._wrap(torch.zeros_like(x._data,
                                         dtype=dtypes.convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    return Tensor._wrap(torch.ones_like(x._data,
                                        dtype=dtypes.convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return Tensor._wrap(torch.full_like(x._data, fill_value,
                                        dtype=dtypes.convert_dtype(dtype)))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """int64 unless an argument is a float (then float32)."""
    def _v(x):
        return x.item() if isinstance(x, Tensor) else x
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    d = dtypes.convert_dtype(dtype)
    if d is None:
        d = (torch.float32 if any(isinstance(v, float)
                                  for v in (start, end, step))
             else torch.int64)
    return Tensor._wrap(torch.arange(start, end, step, dtype=d,
                                     device=default_device()))


__all__ = ["arange", "full", "full_like", "ones", "ones_like", "to_tensor",
           "zeros", "zeros_like"]
