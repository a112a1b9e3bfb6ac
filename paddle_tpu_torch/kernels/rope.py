"""Rotary position embedding (port of ``paddle_tpu/kernels/rope.py``).
Plain tensor math: an elementwise chain that owes no kernel."""

from __future__ import annotations

import torch


def rope_tables(seq_len, head_dim, base=10000.0, dtype=torch.float32,
                offset=0, device=None):
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    t = offset + torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)  # [S, D/2]
    return torch.sin(freqs).to(dtype), torch.cos(freqs).to(dtype)


def apply_rope(x, sin=None, cos=None, neox=True, base=10000.0, offset=0):
    """x: [B, S, H, D].  ``offset`` shifts the absolute positions (a
    prefill chunk that starts at position ``offset``)."""
    b, s, h, d = x.shape
    if sin is None or cos is None:
        sin, cos = rope_tables(s, d, base, torch.float32, offset=offset,
                               device=x.device)
    else:
        # paddle passes [1, S, 1, D] tables with duplicated halves
        sin = sin.reshape(s, -1)[:, : d // 2].float()
        cos = cos.reshape(s, -1)[:, : d // 2].float()
    sin = sin[None, :, None, :]
    cos = cos[None, :, None, :]
    xf = x.float()
    if neox:
        x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    if neox:
        out = torch.cat([r1, r2], dim=-1)
    else:
        out = torch.stack([r1, r2], dim=-1).reshape(xf.shape)
    return out.to(x.dtype)
