"""Int8 weight-only post-training quantization of the GPT serving
weights (port of the PTQ part of ``paddle_tpu/quantization``).

:func:`ptq_int8_decode_state` replaces every stacked layer matmul weight
in :data:`PTQ_WEIGHTS` of ``GPTForCausalLM.decode_state()`` by its int8
tensor plus a ``<name>__scale`` fp32 per-output-channel companion; the
model's ``_mm`` spots the scale and applies it after the product.
"""

from __future__ import annotations

import torch

__all__ = ["PTQ_WEIGHTS", "channel_scales", "quantize_weight_int8",
           "ptq_int8_decode_state"]

#: stacked [L, in, out] layer weights eligible for weight-only PTQ;
#: biases, norms, embeddings and the LM head stay full precision.
PTQ_WEIGHTS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def _percentile(a, percentile, dim):
    """``jnp.percentile(a, percentile, axis=dim)`` with its default
    linear interpolation, rounded as the reference computes it on the
    CPU: XLA turns ``/ 100`` into ``* fp32(0.01)`` and folds it into the
    ``* (n - 1)`` constant, so the rank is ``p * fp32(0.01 * (n - 1))``;
    the sorted neighbours below and above it are interpolated as
    ``fma(low, 1 - frac, high * frac)`` (one rounding of the first
    product: it is exact in float64)."""
    n = a.shape[dim]
    f32 = torch.float32
    step = torch.tensor(0.01, dtype=f32) * torch.tensor(n - 1, dtype=f32)
    rank = torch.tensor(percentile, dtype=f32) * step
    low, high = torch.floor(rank), torch.ceil(rank)
    w_high = rank - low
    w_low = 1 - w_high
    s = torch.sort(a, dim=dim).values
    lo = s.select(dim, int(low.clamp(0, n - 1)))
    hi = s.select(dim, int(high.clamp(0, n - 1)))
    return (lo.double() * w_low.double() + (hi * w_high).double()).float()


def channel_scales(w, observer="absmax", percentile=99.99, qmax=127.0):
    """Per-output-channel symmetric scales for a stacked weight
    ``w [L, in, out]``: one fp32 scale per (layer, out) channel, shaped
    ``[L, 1, out]`` so it broadcasts over the contraction result.
    ``observer="absmax"`` uses the channel max; ``"percentile"`` clips to
    the given percentile of |w| per channel (outlier-robust)."""
    wf = w.float().abs()
    if observer == "absmax":
        amax = wf.amax(dim=-2)                             # [L, out]
    elif observer == "percentile":
        amax = _percentile(wf, percentile, dim=-2)
    else:
        raise ValueError(f"observer must be 'absmax' or 'percentile', "
                         f"got {observer!r}")
    return (amax.clamp_min(1e-8) / qmax)[:, None, :]       # [L, 1, out]


def quantize_weight_int8(w, observer="absmax", percentile=99.99):
    """``(q_int8 [L, in, out], scale [L, 1, out] fp32)`` such that
    ``q * scale ~= w`` (symmetric, per-output-channel; values beyond a
    percentile clip saturate at +-127).  Rounds half to even, as
    ``jnp.round``."""
    scale = channel_scales(w, observer, percentile)
    q = torch.round(w.float() / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


@torch.no_grad()
def ptq_int8_decode_state(model, observer="absmax", percentile=99.99):
    """Int8 weight-only PTQ of a GPT serving weight dict: the model's
    ``decode_state()`` with every stacked matmul weight in
    :data:`PTQ_WEIGHTS` replaced by its int8 tensor plus a
    ``<name>__scale`` fp32 per-output-channel companion, on the model's
    device.  Embeddings, the LM head, biases and norms stay as they
    are.

    A model built under a mesh holds shards (``w["tp"]``): a row-parallel
    weight's scales are taken from the whole input dimension (gathered
    from every rank, which all call), so each rank's int8 shard is the
    unsharded quantization's."""
    w = model.decode_state()
    tp = w.get("tp")
    lws = dict(w["lws"])
    for name in PTQ_WEIGHTS:
        v = lws.get(name)
        if v is None or v.dim() != 3:
            continue
        spec = tuple(tp.spec(name)) if tp is not None else ()
        if len(spec) > 1 and spec[1] is not None:
            scale = channel_scales(tp.full(name, v), observer, percentile)
            q = torch.round(v.float() / scale).clamp(-127, 127)
            q = q.to(torch.int8)
        else:
            q, scale = quantize_weight_int8(v, observer, percentile)
        lws[name] = q
        lws[name + "__scale"] = scale
    w["lws"] = lws
    return w
