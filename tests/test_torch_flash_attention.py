"""Flash attention in the PyTorch port against the JAX reference.

The port's plain versions of K1 (forward), K2 (dQ) and K3 (dK/dV) — the
CPU path of the CUDA kernels' wrappers — are held against the JAX
``_flash_fwd``/``_flash_bwd`` Pallas kernels run in interpret mode, on
the same numpy inputs; then the port's autograd entry points against
``jax.vjp`` of the JAX ones.  The CUDA kernels themselves run only on the
card: ``chip_smoke.py`` holds them against these plain versions.

Tolerances:
* fp32: atol 1e-5 (rtol 1e-5).  Both sides compute in fp32 from the same
  inputs and differ only in the order of fp32 sums over <= 256 keys and
  64 dims of unit-scale values.
* bf16: 2 bf16 ulps of the output's scale (atol = 2 * 2**-7 * max|ref|).
  Both sides round the same operands to bf16 (P before P.V, dS before
  dS.K); an fp32 difference of one ulp can still flip a bf16 rounding of
  an operand or of the output.
* fp16: the same 2 bf16 ulps of the scale.  Both sides round every fp16
  operand (Q, K, V, dO, P, dS) to bf16 before its product, as the TPU
  kernel's ``_dot_f32`` does, so the same bf16 flips bound the
  difference; the fp16 output itself rounds 8x finer.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.profiler import counters

# [B, H, S, D]; D 80 and 256 are the head dims off the wgmma kernels
SHAPES = [(1, 2, 128, 32), (2, 2, 256, 64), (1, 1, 128, 80), (1, 1, 128, 256)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


@pytest.fixture()
def interpret_mode():
    jfa._INTERPRET[0] = True
    yield
    jfa._INTERPRET[0] = False


def _tol(dtype, ref):
    if dtype == "float32":
        return dict(atol=1e-5, rtol=1e-5)
    scale = float(np.abs(ref).max())
    return dict(atol=2 * 2.0 ** -7 * max(scale, 1e-6), rtol=0)


def _inputs(shape, dtype, seed, n=4):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax_kernel(interpret_mode, shape, causal,
                                          dtype):
    (jq, jk, jv, _), (q, k, v, _) = _inputs(shape, dtype, seed=1)
    scale = 1.0 / math.sqrt(shape[-1])
    jout, jlse = jfa._flash_fwd(jq, jk, jv, causal, scale)
    out, lse = tfa._flash_fwd_reference(q, k, v, causal, scale)
    assert out.dtype == DTYPES[dtype][1] and lse.dtype == torch.float32
    assert tuple(lse.shape) == tuple(jlse.shape) == shape[:3] + (1,)
    np.testing.assert_allclose(_np(out), _np(jout), **_tol(dtype, _np(jout)))
    # the LSE is fp32 on both sides whatever the input type
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_kernel(interpret_mode, shape, causal,
                                           dtype, with_dlse):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(shape, dtype, seed=2)
    scale = 1.0 / math.sqrt(shape[-1])
    jout, jlse = jfa._flash_fwd(jq, jk, jv, causal, scale)
    # both backwards start from the JAX forward's residuals
    out = torch.from_numpy(_np(jout)).to(q.dtype)
    lse = torch.from_numpy(_np(jlse))
    dlse_np = (np.random.default_rng(3).standard_normal(shape[:3])
               .astype(np.float32) if with_dlse else None)
    jgrads = jfa._flash_bwd(jq, jk, jv, jout, jlse, jdo, causal, scale,
                            dlse=None if dlse_np is None
                            else jnp.asarray(dlse_np))
    grads = tfa._flash_bwd_reference(
        q, k, v, out, lse, do, causal, scale,
        dlse=None if dlse_np is None else torch.from_numpy(dlse_np))
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == q.dtype, name
        np.testing.assert_allclose(_np(g), _np(jg), err_msg=name,
                                   **_tol(dtype, _np(jg)))


def _grad_case(dtype, causal, seed, S=128):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs((2, S, 2, 32), dtype, seed)
    return (jq, jk, jv, jdo), [t.requires_grad_() for t in (q, k, v)], do


@pytest.mark.parametrize("dtype,causal", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True)])
def test_entry_gradients_match_jax_vjp(interpret_mode, dtype, causal):
    """``flash_attention_fwd`` ([B, S, H, D]) through torch.autograd
    against jax.vjp of the JAX entry (Pallas forward and backward)."""
    (jq, jk, jv, jdo), (q, k, v), do = _grad_case(dtype, causal, seed=4)
    jout, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_fwd(a, b, c, causal=causal),
        jq, jk, jv)
    jgrads = vjp(jdo)
    out = tfa.flash_attention_fwd(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    np.testing.assert_allclose(_np(out), _np(jout), **_tol(dtype, _np(jout)))
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(_np(g), _np(jg), err_msg=name,
                                   **_tol(dtype, _np(jg)))


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_gradients_match_jax_vjp(interpret_mode, causal):
    """Both outputs of ``flash_attention_with_lse`` take a cotangent; the
    LSE's folds into δ."""
    rng = np.random.default_rng(5)
    shape = (1, 2, 128, 32)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    dlse = rng.standard_normal(shape[:3]).astype(np.float32)
    scale = 0.3
    (jout, jlse), vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_with_lse(a, b, c, causal, scale),
        *map(jnp.asarray, arrs[:3]))
    jgrads = vjp((jnp.asarray(arrs[3]), jnp.asarray(dlse)))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal, scale)
    assert tuple(lse.shape) == shape[:3]
    grads = torch.autograd.grad((out, lse), (q, k, v),
                                (torch.from_numpy(arrs[3]),
                                 torch.from_numpy(dlse)))
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=1e-5, rtol=1e-5)
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(_np(g), _np(jg), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seq_not_multiple_of_128_uses_reference_attention(interpret_mode,
                                                          dtype):
    """S = 96: both packages take their O(S²) ``reference_attention``
    (the JAX entry's own branch, ``flash_attention.py:416-425``); the
    port counts it."""
    (jq, jk, jv, jdo), (q, k, v), do = _grad_case(dtype, True, seed=6, S=96)
    jout, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_fwd(a, b, c, causal=True),
        jq, jk, jv)
    jgrads = vjp(jdo)
    before = counters.get("kernels.flash.reference_fallbacks")
    launches = tfa.flash_fwd.launches
    out = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert counters.get("kernels.flash.reference_fallbacks") == before + 1
    assert tfa.flash_fwd.launches == launches
    direct = tfa.reference_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, direct, atol=0, rtol=0)
    grads = torch.autograd.grad(out, (q, k, v), do)
    np.testing.assert_allclose(_np(out), _np(jout), **_tol(dtype, _np(jout)))
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(_np(g), _np(jg), err_msg=name,
                                   **_tol(dtype, _np(jg)))


def test_reference_attention_matches_jax():
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
            for _ in range(3)]
    for causal in (False, True):
        ref = jfa.reference_attention(*map(jnp.asarray, arrs), causal=causal)
        out = tfa.reference_attention(*map(torch.from_numpy, arrs),
                                      causal=causal)
        np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=1e-5)


def _bhsd(*shape):
    return torch.zeros(shape)


@pytest.mark.parametrize("call,match", [
    (lambda: tfa.flash_fwd(_bhsd(1, 2, 128, 32), _bhsd(1, 2, 256, 32),
                           _bhsd(1, 2, 128, 32), True, 1.0), "k_seq_len"),
    (lambda: tfa.flash_fwd(_bhsd(1, 2, 128, 32), _bhsd(1, 2, 128, 32),
                           _bhsd(1, 2, 128, 16), True, 1.0), "v_head_dim"),
    (lambda: tfa.flash_fwd(_bhsd(1, 2, 96, 32), _bhsd(1, 2, 96, 32),
                           _bhsd(1, 2, 96, 32), True, 1.0), "seq_len"),
    (lambda: tfa.flash_bwd_dq(*[_bhsd(1, 2, 128, 32)] * 4,
                              _bhsd(1, 2, 128, 2), _bhsd(1, 2, 128, 1),
                              True, 1.0), "lse_trailing"),
    (lambda: tfa.flash_bwd_dkv(*[_bhsd(1, 2, 128, 32)] * 3,
                               _bhsd(1, 3, 128, 32), _bhsd(1, 2, 128, 1),
                               _bhsd(1, 2, 128, 1), True, 1.0),
     "do_heads"),
])
def test_preflight_names_the_dimension(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_cpu_path_never_moves_launch_counters():
    _, (q, k, v, do) = _inputs((1, 2, 128, 32), "float32", seed=8)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq,
                                   tfa.flash_bwd_dkv)]
    out = tfa.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True)
    out.backward(do.transpose(1, 2))
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    assert [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq,
                                 tfa.flash_bwd_dkv)] == before


def test_kernel_keyword_swaps_in_plain_versions_with_equal_grads():
    """``kernel=False`` runs the plain versions in both directions; on the
    CPU the wrappers take the same plain versions, so the two agree
    exactly."""
    _, (q, k, v, do) = _inputs((1, 128, 2, 32), "float32", seed=9)
    res = []
    for kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tfa.flash_attention_fwd(*leaves, causal=True, kernel=kernel)
        res.append([out, *torch.autograd.grad(out, leaves, do)])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
