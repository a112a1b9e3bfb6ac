"""Decode-time sampling (port of ``paddle_tpu/serving/sampling.py``).

The temperature / top-k / top-p logits transform, the token draw, and
the speculative-decoding residual draw.
Randomness comes from an explicit ``torch.Generator`` (the engine keeps
one per request, seeded from the request's ``seed``) in place of a JAX
key; the two packages' random streams differ, so sampled tokens are
compared by distribution, never token by token.  Greedy is ``argmax``.
Knobs are host scalars: the engine samples each row with its request's
own knobs.
"""

from __future__ import annotations

import torch


def filter_logits(lg, temperature=1.0, top_k=0, top_p=1.0):
    """Temperature scaling, then top-k, then top-p (nucleus) masking over
    fp32 logits ``lg[..., V]``.  Masked entries become -1e30 (exp == 0
    exactly under softmax).  Neutral knobs (``top_k=0``, ``top_p=1.0``)
    skip their step."""
    V = lg.shape[-1]
    lg = lg / max(float(temperature), 1e-6)
    if top_k and int(top_k) > 0:
        kth = torch.sort(lg, dim=-1).values[..., -min(int(top_k), V)]
        lg = torch.where(lg < kth[..., None], -1e30, lg)
    if float(top_p) < 1.0:
        s = -torch.sort(-lg, dim=-1).values  # descending
        probs = torch.softmax(s, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep a token while the mass strictly BEFORE it is < p; the top
        # token is always kept (0 < p)
        keep = (cum - probs) < top_p
        cnt = keep.sum(dim=-1).clamp(min=1)
        cutoff = torch.gather(s, -1, (cnt - 1)[..., None])
        lg = torch.where(lg < cutoff, -1e30, lg)
    return lg


def sample_tokens(lg, generator=None, *, do_sample=True, temperature=1.0,
                  top_k=0, top_p=1.0):
    """Next tokens (int64) from fp32 logits ``lg[B, V]``.
    ``do_sample=False`` is pure argmax (the generator is not touched);
    otherwise one categorical draw per row over the filtered
    distribution, from ``generator``."""
    if not do_sample:
        return torch.argmax(lg, dim=-1)
    probs = torch.softmax(filter_logits(lg, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def residual_sample(p, q, generator=None):
    """One draw per row from the speculative-decoding residual
    ``norm(max(0, p - q))`` (Leviathan et al., ICML 2023): ``p`` is the
    target's probability row(s) ``[..., V]``, ``q`` the draft's.  A
    correction drawn from it when a proposal is rejected keeps the
    overall output distribution equal to sampling from ``p`` alone.  A
    row whose residual mass is 0 (``q >= p`` everywhere, only possible up
    to rounding) falls back to ``p`` itself.  Returns int64 tokens of
    shape ``p.shape[:-1]``."""
    res = torch.clamp(p - q, min=0.0)
    mass = res.sum(dim=-1, keepdim=True)
    dist = torch.where(mass > 0, res / mass.clamp_min(1e-20), p)
    V = dist.shape[-1]
    draw = torch.multinomial(dist.reshape(-1, V), 1, generator=generator)
    return draw.reshape(dist.shape[:-1])
