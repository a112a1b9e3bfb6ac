"""``linear``, ``dropout`` and ``embedding`` (port of the parts of
``paddle_tpu/nn/functional/common.py`` the layers call)."""

from __future__ import annotations

import torch

from ...core.dispatch import apply_op
from ...core.tensor import Tensor, _promote, weak_scalar
from ...tensor.random import default_generator


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _linear(a, w, b=None):
    """``a @ w (+ b)``, operands promoted as jnp does."""
    out = torch.matmul(*_promote(a, w))
    return out if b is None else out + b


def linear(x, weight, bias=None, name=None):
    """y = x W (+ b), weight ``[in, out]`` as in Paddle (so state dicts
    map one to one).  The product is ``torch.matmul``: the JAX package
    leaves it to XLA, outside any Pallas kernel."""
    if bias is None:
        return apply_op("linear", _linear, _t(x), weight)
    return apply_op("linear", _linear, _t(x), weight, bias)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element (each slice along ``axis``) with probability
    ``p``; ``upscale_in_train`` scales the kept ones by ``1/(1-p)``.  The
    mask is drawn from the default generator of ``x``'s device."""
    if not training or p == 0:
        return _t(x)
    if p == 1:
        return apply_op("dropout", torch.zeros_like, _t(x))
    x = _t(x)

    def fn(v):
        shape = list(v.shape)
        if axis is not None:
            axes = [axis] if isinstance(axis, int) else list(axis)
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = torch.rand(shape, generator=default_generator(v.device),
                          device=v.device) >= p
        if mode == "upscale_in_train":
            # 1 - p rounded to v's dtype first, as jnp's weak float is
            return torch.where(keep, v / weak_scalar(1.0 - p, v.dtype),
                               0.0).to(v.dtype)
        return torch.where(keep, v, 0.0).to(v.dtype)
    return apply_op("dropout", fn, x)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ids ``x``; rows at ``padding_idx`` are 0."""
    def fn(ids, w):
        out = torch.nn.functional.embedding(ids, w)
        if padding_idx is not None:
            out = torch.where((ids == padding_idx)[..., None], 0.0, out)
        return out
    return apply_op("embedding", fn, _t(x), weight)


__all__ = ["dropout", "embedding", "linear"]
