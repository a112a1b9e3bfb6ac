"""Ring attention — context parallelism over the ``sep`` mesh axis (port
of ``paddle_tpu/kernels/ring_attention.py``).

Every rank of the ``sep`` group holds one chunk of the sequence of Q, K
and V, ``[B, S_local, H, D]``, in global order (member r holds chunk r:
the mesh train step cuts the batch so).  The K/V chunks travel round the
ring through :func:`distributed.communication.ring_shift` (K and V in one
``all_to_all_single``): at step s member r holds chunk ``(r - s) mod n``.
Each visit gives the local queries an ``(o, lse)`` pair: causally on the
diagonal, over every key for an older chunk; a newer chunk is skipped
(no launch: the JAX ring's ``lse = NEG_INF`` branch, whose merge step is
an exact no-op).  The pairs merge into an fp32 online softmax ``(acc, m,
l)`` by the JAX ring's own formulas.  A non-causal ring visits every
chunk.  The JAX scan shifts n times; the last shift only returns every
chunk to its owner, so here a call shifts ``n - 1`` times.

The chunk route is the JAX ``_chunk_attention``: a chunk whose length is
a multiple of 128 runs :func:`flash_attention_with_lse` in the ``[B, H,
S, D]`` layout — K1 forward, K2/K3 backward with the chunk's LSE
cotangent folded in as δ − dlse; any other length takes the plain chunk
math of the JAX fallback branch (counted in
``kernels.flash.reference_fallbacks``, as the flash entry's fallback
is).  On CPU tensors the flash wrappers take their plain versions.

Gradients run through autograd: the chunks' custom backward and the
shift's (which shifts the gradient back), the port of JAX's
scan/``ppermute`` transposes and the flash custom VJP.  A ring inside a
recomputed stage (``recompute="selective"``) replays its forward in the
backward: every rank issues the same shifts in the same order, and the
replay doubles the K1 launches and the forward shifts.
"""

from __future__ import annotations

import math

import torch

from ..profiler import counters
from ._shapes import NEG_INF, check_equal
from .flash_attention import (SEQ_MULTIPLE, flash_attention_fwd,
                              flash_attention_with_lse)


def _chunk_attention(q, k, v, causal, scale, kernel):
    """``(out [B, S, H, D] in q's dtype, lse [B, S, H] fp32)`` of the
    local queries over one visiting K/V chunk."""
    if q.shape[1] % SEQ_MULTIPLE == 0:
        out, lse = flash_attention_with_lse(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
            scale, kernel=kernel)
        return out.transpose(1, 2), lse.transpose(1, 2)
    counters.inc("kernels.flash.reference_fallbacks")
    logits = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(t - s)
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, device=q.device))
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1).clamp_min(1e-30)
    o = torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)
    o = o / l.to(o.dtype).transpose(1, 2)[..., None]
    return o, (m + torch.log(l)).transpose(1, 2)


class _AlsoNeeds(torch.autograd.Function):
    """``out`` itself, with ``kv`` made an input whose gradient is zero.
    A causal rank skips the chunks after its own, so the last shifted K/V
    may feed nothing on it; its backward must still run every shift's
    backward, since each is a collective of the whole ring."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)


def ring_attention(q, k, v, causal=True, scale=None, axis="sep", mesh=None,
                   *, kernel=True):
    """Context-parallel attention of this rank's chunk ``q [B, S_local,
    H, D]`` over the whole sequence, whose K/V chunks ``k``/``v`` the
    members of mesh axis ``axis`` hold (default: the global mesh's).
    Returns ``[B, S_local, H, D]`` in q's dtype.  Without a mesh, or at
    degree 1, it is :func:`flash_attention_fwd`.  ``kernel=False`` swaps
    K1–K3 for their plain versions.  (The JAX function takes the global
    sequence and shards it itself.)"""
    from ..distributed.communication import ring_shift
    from ..distributed.env import get_mesh
    mesh = mesh or get_mesh()
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if mesh is None or mesh.degree(axis) == 1:
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   kernel=kernel)
    check_equal("ring_attention",
                k_seq_len=(k.shape[1], q.shape[1]),
                v_seq_len=(v.shape[1], q.shape[1]))
    n, me = mesh.degree(axis), mesh.index(axis)
    B, S, H, D = q.shape
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m_run = torch.full((B, S, H), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    kv = None
    for s in range(n):
        src = (me - s) % n          # the visiting chunk's global index
        visit = not causal or src <= me
        if visit:
            o_s, lse_s = _chunk_attention(q, kc, vc, causal and src == me,
                                          scale, kernel)
            m_new = torch.maximum(m_run, lse_s)
            keep = torch.exp(m_run - m_new)
            w = torch.exp(lse_s - m_new)
            acc = acc * keep[..., None] + o_s.float() * w[..., None]
            l_run = l_run * keep + w
            m_run = m_new
        if s < n - 1:
            kv = ring_shift(torch.stack([kc, vc]), axis, mesh)
            kc, vc = kv.unbind(0)
    out = (acc / l_run.clamp_min(1e-30)[..., None]).to(q.dtype)
    if not visit and torch.is_grad_enabled() and kv.requires_grad:
        out = _AlsoNeeds.apply(out, kv)
    return out


__all__ = ["ring_attention"]
