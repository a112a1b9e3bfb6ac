"""``matmul`` and ``add`` (port of the parts of
``paddle_tpu/tensor/math.py`` this slice calls).  Two tensors promote
as jnp does (``core.tensor._promote``)."""

from __future__ import annotations

import numbers

import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor, _binary


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op("matmul", _binary(fn), _t(x), _t(y))


def add(x, y, name=None):
    y = y if isinstance(y, numbers.Number) else _t(y)
    return apply_op("add", _binary(torch.add), _t(x), y)


__all__ = ["add", "matmul"]
