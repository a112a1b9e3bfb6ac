"""``layer_norm`` (port of ``paddle_tpu/nn/functional/norm.py``'s):
statistics in fp32, the normalised value rounded to the input's dtype,
then the affine in the promoted dtype, as the JAX function computes it.
XLA fuses it in the reference; there is no Pallas kernel behind it."""

from __future__ import annotations

import torch

from ...core.dispatch import apply_op
from ...core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    ns = ((normalized_shape,) if isinstance(normalized_shape, int)
          else tuple(normalized_shape))
    axes = tuple(range(-len(ns), 0))

    def fn(v, *wb):
        v32 = v.float()
        var, mean = torch.var_mean(v32, dim=axes, keepdim=True,
                                   correction=0)
        out = ((v32 - mean) * torch.rsqrt(var + epsilon)).to(v.dtype)
        i = 0
        if weight is not None:
            out = out * wb[i]
            i += 1
        if bias is not None:
            out = out + wb[i]
        return out
    args = [a for a in (weight, bias) if a is not None]
    return apply_op("layer_norm", fn, _t(x), *args)


__all__ = ["layer_norm"]
