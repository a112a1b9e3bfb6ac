"""Shape ops (port of the parts of ``paddle_tpu/tensor/manipulation.py``
the layers call)."""

from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _static_shape(shape):
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in (shape if isinstance(shape, (list, tuple))
                           else [shape]))


def reshape(x, shape, name=None):
    shp = _static_shape(shape)
    return apply_op("reshape", lambda v: torch.reshape(v, shp), _t(x))


def transpose(x, perm, name=None):
    perm = [int(p) for p in perm]
    return apply_op("transpose", lambda v: v.permute(*perm), _t(x))


def concat(x, axis=0, name=None):
    """Promotes as ``jnp.concatenate``: to the widest input dtype."""
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)

    def fn(*vs):
        dt = vs[0].dtype
        for v in vs[1:]:
            dt = torch.promote_types(dt, v.dtype)
        return torch.cat([v.to(dt) for v in vs], dim=ax)
    return apply_op("concat", fn, *[_t(v) for v in x])


def expand(x, shape, name=None):
    """Broadcast to ``shape``; -1 keeps that dim."""
    shp = _static_shape(shape)

    def fn(v):
        tgt = [v.shape[i - len(shp) + v.dim()] if s == -1 else s
               for i, s in enumerate(shp)]
        return torch.broadcast_to(v, tgt)
    return apply_op("expand", fn, _t(x))


__all__ = ["concat", "expand", "reshape", "transpose"]
