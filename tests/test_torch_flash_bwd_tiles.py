"""The Hopper backward kernels' arithmetic, mirrored in plain PyTorch.

``csrc/flash_attention.cu`` computes dQ (K2) over 128-row query tiles
and 128-key tiles, diagonal tile first, and dK/dV (K3) over 128-key
tiles and 64-query tiles with the scores transposed (Sᵀ = K Qᵀ, dPᵀ =
V dOᵀ), LSE and δ taken per column.  Both form P in base 2, with
scale·log₂e folded into one multiply-add and the LSE pre-scaled by
log₂e, and round P and dS to bf16 where they enter a product.  The
mirror below repeats that tile order and that arithmetic on the CPU
(a test helper, on no path of the port) and is held against the JAX
``_flash_bwd`` (Pallas in interpret mode) at ``chip_smoke.py``'s
per-element tolerance for a kernel against its plain version
(``_flash_tol``): 2 bf16 ulps of the element + 2⁻⁷ of the row max +
2⁻¹² of the tensor max in bf16; 1e-4 of the row max + 1e-5 of the
tensor max in fp32.  S 256 gives K2 two key tiles and K3 four query
tiles.

At head dim 256, ``csrc/flash_attention_d256.cu`` runs K1 over 128-row
query items (64 rows a warpgroup) and 64-key tiles from the diagonal
down, the online softmax in base 2; K2 over the same items and 32-key
tiles from the diagonal down; and K3 over 64-key items and 64-query
tiles from the diagonal on, dS formed from the fp32 Pᵀ that one
warpgroup hands the other.  Their mirrors are held to the JAX kernels
(forward and backward computed once per case for all three) at D 256.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import _flash_tol
from paddle_tpu.kernels import flash_attention as jfa

LOG2E = 1.4426950408889634
BLOCK_M = BLOCK_N = 128     # K2's query rows and key tiles; K3's key rows
BLOCK_Q = 64                # K3's query tiles
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture()
def interpret_mode():
    jfa._INTERPRET[0] = True
    yield
    jfa._INTERPRET[0] = False


def _operand(x, low):
    """A product operand: rounded to bf16 for 16-bit inputs (P, dS)."""
    return x.to(torch.bfloat16).float() if low else x.float()


def _mm(a, b, low):
    return _operand(a, low) @ _operand(b, low)


def _p2(s, lse, scale):
    """P = 2^(s·(scale·log₂e) − lse·log₂e), in fp32 as the kernels form
    it from the raw scores."""
    return torch.exp2(s * (scale * LOG2E) - lse * LOG2E)


def _mirror_dq(q, k, v, do, lse, delta, causal, scale):
    """K2: per 128-row query tile, key tiles from the diagonal down; the
    diagonal tile alone masked; dQ scaled once at the end."""
    low = q.dtype == torch.bfloat16
    B, H, S, D = q.shape
    dq = torch.empty(B, H, S, D)
    lse2 = lse.float()
    for q0 in range(S - BLOCK_M, -1, -BLOCK_M):
        rows = slice(q0, q0 + BLOCK_M)
        qt, dot = q[:, :, rows].float(), do[:, :, rows].float()
        l2, dl = lse2[:, :, rows], delta[:, :, rows]
        n_tiles = (q0 + BLOCK_M if causal else S) // BLOCK_N
        acc = torch.zeros(B, H, BLOCK_M, D)
        for it in range(n_tiles):
            k0 = (n_tiles - 1 - it) * BLOCK_N
            kt = k[:, :, k0:k0 + BLOCK_N].float()
            vt = v[:, :, k0:k0 + BLOCK_N].float()
            p = _p2(qt @ kt.transpose(-1, -2), l2, scale)
            if causal and it == 0:
                r = torch.arange(BLOCK_M)[:, None] + q0
                c = torch.arange(BLOCK_N)[None, :] + k0
                p = torch.where(c > r, torch.zeros(()), p)
            ds = p * (dot @ vt.transpose(-1, -2) - dl)
            acc = acc + _mm(ds, kt, low)
        dq[:, :, rows] = acc * scale
    return dq.to(q.dtype)


def _mirror_dkv(q, k, v, do, lse, delta, causal, scale, block_k=BLOCK_N):
    """K3: per ``block_k``-key tile (128; 64 at D 256), 64-query tiles
    from the diagonal on, scores transposed (keys as rows), LSE and δ per
    column, dS from the fp32 Pᵀ; dK scaled once."""
    low = q.dtype == torch.bfloat16
    B, H, S, D = q.shape
    dk, dv = torch.empty(B, H, S, D), torch.empty(B, H, S, D)
    lse_t = lse.float().transpose(-1, -2)      # [B, H, 1, S]
    delta_t = delta.transpose(-1, -2)
    for k0 in range(0, S, block_k):
        keys = slice(k0, k0 + block_k)
        kt, vt = k[:, :, keys].float(), v[:, :, keys].float()
        acc_k = torch.zeros(B, H, block_k, D)
        acc_v = torch.zeros(B, H, block_k, D)
        first = k0 // BLOCK_Q if causal else 0
        for qs in range(first * BLOCK_Q, S, BLOCK_Q):
            cols = slice(qs, qs + BLOCK_Q)
            qt, dot = q[:, :, cols].float(), do[:, :, cols].float()
            pt = _p2(kt @ qt.transpose(-1, -2), lse_t[..., cols], scale)
            if causal and qs < k0 + block_k:
                r = torch.arange(block_k)[:, None] + k0
                c = torch.arange(BLOCK_Q)[None, :] + qs
                pt = torch.where(c < r, torch.zeros(()), pt)
            dpt = vt @ dot.transpose(-1, -2)
            dst = pt * (dpt - delta_t[..., cols])
            acc_v = acc_v + _mm(pt, dot, low)
            acc_k = acc_k + _mm(dst, qt, low)
        dk[:, :, keys] = acc_k * scale
        dv[:, :, keys] = acc_v
    return dk.to(q.dtype), dv.to(q.dtype)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 96])
def test_tile_mirror_matches_jax_backward(interpret_mode, D, dtype, causal,
                                          with_dlse):
    shape = (1, 1, 256, D)
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    jd, td = DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in arrs)
    q, k, v, do = (torch.from_numpy(a).to(td) for a in arrs)
    scale = 1.0 / math.sqrt(D)
    jout, jlse = jfa._flash_fwd(jq, jk, jv, causal, scale)
    dlse = (rng.standard_normal(shape[:3]).astype(np.float32)
            if with_dlse else None)
    jgrads = jfa._flash_bwd(jq, jk, jv, jout, jlse, jdo, causal, scale,
                            dlse=None if dlse is None else jnp.asarray(dlse))
    # both start from the JAX forward's residuals; δ as _flash_bwd forms it
    out = torch.from_numpy(_np(jout)).to(td)
    lse = torch.from_numpy(_np(jlse))
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - torch.from_numpy(dlse)[..., None]
    dq = _mirror_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _mirror_dkv(q, k, v, do, lse, delta, causal, scale)
    for name, got, jg in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads):
        assert got.dtype == td, name
        ref = torch.from_numpy(_np(jg))
        err = (got.float() - ref).abs()
        tol = _flash_tol(ref, td)
        worst = float((err / tol).nan_to_num(nan=0.0).max())
        assert worst <= 1.0, (name, worst)


# ---------------------------------------------------------------------------
# head dim 256: csrc/flash_attention_d256.cu's tile orders
# ---------------------------------------------------------------------------
D256_TILE = 64       # K1's key tiles; K3's key items and query tiles
D256_DQ_TILE = 32    # K2's key tiles
D256_SHAPE = (1, 1, 256, 256)


def _mirror_fwd_d256(q, k, v, causal, scale):
    """K1 at D 256: per 128-row query item, each 64-row half (a consumer
    warpgroup) over 64-key tiles from the diagonal down, skipping the
    tile whose keys all follow its rows; the online softmax on raw scores
    in base 2 (p = 2^(s·sl2 − m·sl2)), P rounded to bf16 for P·V;
    O = acc / max(l, 1e-30), LSE = m·scale + log(max(l, 1e-30))."""
    low = q.dtype == torch.bfloat16
    B, H, S, D = q.shape
    sl2 = scale * LOG2E
    out, lse = torch.empty(B, H, S, D), torch.empty(B, H, S, 1)
    for q0 in range(S - BLOCK_M, -1, -BLOCK_M):
        n_tiles = (q0 + BLOCK_M if causal else S) // D256_TILE
        for r0 in (q0, q0 + 64):
            qt = q[:, :, r0:r0 + 64].float()
            m = torch.full((B, H, 64, 1), -torch.finfo(torch.float32).max)
            l = torch.zeros(B, H, 64, 1)
            acc = torch.zeros(B, H, 64, D)
            for it in range(n_tiles):
                k0 = (n_tiles - 1 - it) * D256_TILE
                if causal and k0 > r0:
                    continue
                kt = k[:, :, k0:k0 + D256_TILE].float()
                vt = v[:, :, k0:k0 + D256_TILE].float()
                s = qt @ kt.transpose(-1, -2)
                if causal and k0 == r0:
                    r = torch.arange(64)[:, None] + r0
                    c = torch.arange(D256_TILE)[None, :] + k0
                    s = torch.where(c > r, torch.full((), -torch.finfo(
                        torch.float32).max), s)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2((m - mx) * sl2)
                p = torch.exp2(s * sl2 - mx * sl2)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + _mm(p, vt, low)
                m = mx
            l = l.clamp_min(1e-30)
            out[:, :, r0:r0 + 64] = acc / l
            lse[:, :, r0:r0 + 64] = m * scale + torch.log(l)
    return out.to(q.dtype), lse


def _mirror_dq_d256(q, k, v, do, lse, delta, causal, scale):
    """K2 at D 256: per 128-row query item, each 64-row half (a consumer
    warpgroup) over 32-key tiles from the diagonal down, skipping the
    tiles whose keys all follow its rows and masking those that cross
    its diagonal; P in base 2 from the raw scores and the pre-scaled LSE,
    dS rounded to bf16 for dS·K; dQ scaled once at the end."""
    low = q.dtype == torch.bfloat16
    B, H, S, D = q.shape
    dq = torch.empty(B, H, S, D)
    lse2 = lse.float()
    for q0 in range(S - BLOCK_M, -1, -BLOCK_M):
        n_tiles = (q0 + BLOCK_M if causal else S) // D256_DQ_TILE
        for r0 in (q0, q0 + 64):
            rows = slice(r0, r0 + 64)
            qt, dot = q[:, :, rows].float(), do[:, :, rows].float()
            l2, dl = lse2[:, :, rows], delta[:, :, rows]
            acc = torch.zeros(B, H, 64, D)
            for it in range(n_tiles):
                k0 = (n_tiles - 1 - it) * D256_DQ_TILE
                if causal and k0 - r0 >= 64:
                    continue
                kt = k[:, :, k0:k0 + D256_DQ_TILE].float()
                vt = v[:, :, k0:k0 + D256_DQ_TILE].float()
                p = _p2(qt @ kt.transpose(-1, -2), l2, scale)
                if causal and k0 >= r0:
                    r = torch.arange(64)[:, None] + r0
                    c = torch.arange(D256_DQ_TILE)[None, :] + k0
                    p = torch.where(c > r, torch.zeros(()), p)
                ds = p * (dot @ vt.transpose(-1, -2) - dl)
                acc = acc + _mm(ds, kt, low)
            dq[:, :, rows] = acc * scale
    return dq.to(q.dtype)


@pytest.fixture(scope="module")
def jax_d256():
    """The JAX forward and backward at ``D256_SHAPE``, Pallas in
    interpret mode: the forward once per (dtype, causal), the backward
    once per (dtype, causal, with_dlse), for both mirrors."""
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal(D256_SHAPE).astype(np.float32)
            for _ in range(4)]
    dlse = rng.standard_normal(D256_SHAPE[:3]).astype(np.float32)
    scale = 1.0 / math.sqrt(D256_SHAPE[-1])
    fwd, bwd = {}, {}

    def get(dtype, causal, with_dlse):
        jq, jk, jv, jdo = (jnp.asarray(a, DTYPES[dtype][0]) for a in arrs)
        jfa._INTERPRET[0] = True
        try:
            if (dtype, causal) not in fwd:
                fwd[dtype, causal] = jfa._flash_fwd(jq, jk, jv, causal, scale)
            jout, jlse = fwd[dtype, causal]
            key = (dtype, causal, with_dlse)
            if key not in bwd:
                bwd[key] = [_np(g) for g in jfa._flash_bwd(
                    jq, jk, jv, jout, jlse, jdo, causal, scale,
                    dlse=jnp.asarray(dlse) if with_dlse else None)]
        finally:
            jfa._INTERPRET[0] = False
        return (arrs, dlse if with_dlse else None, _np(jout), _np(jlse),
                bwd[key])

    return get


def _within_tol(name, got, ref, dtype):
    ref = torch.from_numpy(ref)
    err = (got.float() - ref).abs()
    worst = float((err / _flash_tol(ref, dtype)).nan_to_num(nan=0.0).max())
    assert worst <= 1.0, (name, worst)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d256_fwd_mirror_matches_jax(jax_d256, dtype, causal):
    arrs, _, jout, jlse, _ = jax_d256(dtype, causal, False)
    td = DTYPES[dtype][1]
    q, k, v = (torch.from_numpy(a).to(td) for a in arrs[:3])
    out, lse = _mirror_fwd_d256(q, k, v, causal,
                                1.0 / math.sqrt(D256_SHAPE[-1]))
    assert out.dtype == td
    _within_tol("out", out, jout, td)
    # fp32 log-sum-exps on both sides, 1e-5 relative (chip_smoke's)
    ref = torch.from_numpy(jlse)
    assert bool(((lse - ref).abs() <= 1e-5 * ref.abs().clamp_min(1.0)).all())


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d256_dkv_mirror_matches_jax(jax_d256, dtype, causal, with_dlse):
    arrs, dlse, jout, jlse, jgrads = jax_d256(dtype, causal, with_dlse)
    td = DTYPES[dtype][1]
    q, k, v, do = (torch.from_numpy(a).to(td) for a in arrs)
    out = torch.from_numpy(jout).to(td)
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - torch.from_numpy(dlse)[..., None]
    dk, dv = _mirror_dkv(q, k, v, do, torch.from_numpy(jlse), delta, causal,
                         1.0 / math.sqrt(D256_SHAPE[-1]), block_k=D256_TILE)
    for name, got, jg in (("dk", dk, jgrads[1]), ("dv", dv, jgrads[2])):
        assert got.dtype == td, name
        _within_tol(name, got, jg, td)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d256_dq_mirror_matches_jax(jax_d256, dtype, causal, with_dlse):
    arrs, dlse, jout, jlse, jgrads = jax_d256(dtype, causal, with_dlse)
    td = DTYPES[dtype][1]
    q, k, v, do = (torch.from_numpy(a).to(td) for a in arrs)
    out = torch.from_numpy(jout).to(td)
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - torch.from_numpy(dlse)[..., None]
    dq = _mirror_dq_d256(q, k, v, do, torch.from_numpy(jlse), delta, causal,
                         1.0 / math.sqrt(D256_SHAPE[-1]))
    assert dq.dtype == td
    _within_tol("dq", dq, jgrads[0], td)
