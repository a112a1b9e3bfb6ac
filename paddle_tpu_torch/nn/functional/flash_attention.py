"""Attention functionals (port of
``paddle_tpu/nn/functional/flash_attention.py``), ``[B, S, H, D]``.

:func:`scaled_dot_product_attention` takes the flash kernels exactly
where the JAX function takes Pallas (``:25-32, 61``): no mask,
``dropout_p == 0``, 4-d input, ``S >= 128``, ``S % 128 == 0`` and ``D``
in (64, 128, 256), with "the tensor is on CUDA" for "the platform is a
TPU".  It then calls ``kernels.flash_attention.flash_attention_fwd``:
K1 in the forward, K2 and K3 in the backward, under the op name
``"flash_attention"`` (D 64 and 128 on the wgmma kernels; D 256 with K1
and K3 on the D 256 wgmma kernels and K2 on the mma.sync one).  Everywhere else (a mask, attention dropout, other shapes,
the CPU) it runs :func:`_sdpa_reference` under ``"sdpa"``, as JAX does;
that path applies no attention dropout, as JAX's does not.
"""

from __future__ import annotations

import math

import torch

from ...core.dispatch import apply_op
from ...core.tensor import Tensor
from ...kernels.flash_attention import flash_attention_fwd

_NEG = -1e30


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _use_kernel(q):
    """The JAX ``_use_pallas``: where the route takes the kernel."""
    if q.dim() != 4 or not q.is_cuda:
        return False
    b, s, h, d = q.shape
    return s >= 128 and s % 128 == 0 and d in (64, 128, 256)


def _sdpa_reference(q, k, v, mask, causal, dropout_p, scale=None):
    """Plain attention ``[B, S, H, D]``: fp32 logits, a bool mask (False
    drops a key) or an additive one, softmax, the probabilities cast to
    ``v``'s dtype for the value product.  ``dropout_p`` is not applied
    (the JAX function ignores it too)."""
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bshd,bthd->bhst", q.float() * sc, k.float())
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(t - s)
        logits = torch.where(keep, logits, _NEG)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, _NEG)
        else:
            logits = logits + mask.to(logits.dtype)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    q, k, v = _t(query), _t(key), _t(value)
    if _use_kernel(q._data) and attn_mask is None and dropout_p == 0.0:
        return apply_op(
            "flash_attention",
            lambda a, b, c: flash_attention_fwd(a, b, c, causal=is_causal),
            q, k, v)
    m = attn_mask._data if isinstance(attn_mask, Tensor) else attn_mask
    return apply_op("sdpa",
                    lambda a, b, c: _sdpa_reference(a, b, c, m, is_causal,
                                                    dropout_p), q, k, v)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """``(out, None)``, as the JAX function returns it."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


__all__ = ["flash_attention", "scaled_dot_product_attention"]
