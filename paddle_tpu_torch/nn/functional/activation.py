"""``gelu``, ``tanh``, ``relu`` and ``softmax`` (port of the parts of
``paddle_tpu/nn/functional/activation.py`` the layers call)."""

from __future__ import annotations

import torch

from ...core import dtype as dtypes
from ...core.dispatch import apply_op
from ...core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def relu(x, name=None):
    return apply_op("relu", torch.relu, _t(x))


def gelu(x, approximate=False, name=None):
    """erf GELU, or the tanh approximation (``jax.nn.gelu``)."""
    how = "tanh" if approximate else "none"
    return apply_op("gelu",
                    lambda v: torch.nn.functional.gelu(v, approximate=how),
                    _t(x))


def tanh(x, name=None):
    return apply_op("tanh", torch.tanh, _t(x))


def softmax(x, axis=-1, dtype=None, name=None):
    dt = dtypes.convert_dtype(dtype)

    def fn(v):
        return torch.softmax(v if dt is None else v.to(dt), dim=axis)
    return apply_op("softmax", fn, _t(x))


__all__ = ["gelu", "relu", "softmax", "tanh"]
