"""fp16 operands of the flash kernels: where and how they are rounded.

The products of K1–K3 take both operands in bf16, as the JAX kernels'
``_dot_f32`` rounds every 2-byte operand.  For fp16 operands,
``flash_attention.cu``'s K1 and K3 do that rounding themselves: TMA lands
the fp16 tile and converter warps round it in shared memory, each pair
of values widened to fp32 (exact) and rounded to nearest even by
``cvt.rn.bf16x2.f32``.  The kernel cannot run here, so these tests hold
its recipe, written in numpy, against torch's cast (what the wrapper's
copies and the plain versions do) and JAX's (what ``_dot_f32`` does),
over every fp16 bit pattern; and they pin which launches take the
in-kernel rounding (``_dtype_code``).  All exact: no tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

ALL_F16 = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)


def _kernel_rounding(bits):
    """The converters' recipe on fp16 bit patterns: widen to fp32, then
    round the fp32 bits to their top 16, to nearest and ties to even;
    NaN gives the canonical NaN 0x7fff, as ``cvt.rn.bf16x2.f32`` does."""
    f32 = bits.view(np.float16).astype(np.float32)
    u = f32.view(np.uint32).astype(np.uint64)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(f32), np.uint16(0x7FFF), rounded)


def _torch_rounding(bits):
    t = torch.from_numpy(bits.view(np.int16)).view(torch.float16)
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _jax_rounding(bits):
    x = jnp.asarray(bits.view(np.float16)).astype(jnp.bfloat16)
    return np.asarray(x).view(np.uint16)


def _is_nan(bf16_bits):
    return np.isnan((bf16_bits.astype(np.uint32) << 16).view(np.float32))


@pytest.mark.parametrize("other", [_torch_rounding, _jax_rounding],
                         ids=["torch", "jax"])
def test_recipe_matches_casts_on_every_fp16_pattern(other):
    mine, theirs = _kernel_rounding(ALL_F16), other(ALL_F16)
    nan = np.isnan(ALL_F16.view(np.float16))
    assert nan.sum() == 2 * 1023           # both signs, every payload
    np.testing.assert_array_equal(mine[~nan], theirs[~nan])
    assert _is_nan(mine[nan]).all() and _is_nan(theirs[nan]).all()


def test_recipe_rounds_ties_to_even_and_keeps_subnormals():
    """fp16 has 3 mantissa bits more than bf16: a pattern whose low 3 are
    0b100 lies halfway between two bf16 values and must go to the even
    one, up or down; fp16 subnormals are normal in fp32 and bf16 and must
    not be flushed."""
    f16 = ALL_F16.view(np.float16)
    finite = np.isfinite(f16)
    out = _kernel_rounding(ALL_F16)
    got = (out.astype(np.uint32) << 16).view(np.float32)
    exact = f16.astype(np.float32)
    # (a normal fp16's mantissa sits in the top 10 of fp32's 23 bits; a
    # subnormal's is shifted by the widening)
    normal = finite & (np.abs(exact) >= 2.0 ** -14)
    tie = normal & ((ALL_F16 & 0x7) == 0x4)
    assert tie.sum() == normal.sum() // 8
    assert ((out[tie] & 1) == 0).all()
    up = np.abs(got[tie]) > np.abs(exact[tie])
    assert 0 < up.sum() < tie.sum()        # both directions occur
    sub = finite & (np.abs(exact) < 2.0 ** -14) & (exact != 0)
    assert sub.sum() == 2 * 1023
    assert (got[sub] != 0).all()
    # to bf16's 8 significant bits: within half a bf16 ulp of the value
    assert (np.abs(got[finite] - exact[finite])
            <= np.abs(exact[finite]) * 2.0 ** -8).all()


def test_recipe_is_dot_f32_rounding():
    """The JAX kernels' ``_dot_f32`` itself, on every finite fp16 value as
    a [256, 256] matrix times the identity: each output is its operand
    rounded to bf16, summed in fp32 with exact zeros."""
    f16 = ALL_F16.view(np.float16).copy()
    f16[~np.isfinite(f16)] = 0
    a = jnp.asarray(f16.reshape(256, 256))
    eye = jnp.eye(256, dtype=jnp.float16)
    got = np.asarray(jfa._dot_f32(a, eye)).reshape(-1)
    mine = (_kernel_rounding(f16.view(np.uint16)).astype(np.uint32)
            << 16).view(np.float32)
    np.testing.assert_array_equal(got, mine)


KERNELS = ("fwd", "dq", "dkv")
HEAD_DIMS = (*tfa.KERNEL_HEAD_DIMS, tfa.D256_HEAD_DIM, 32, 80)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32],
                         ids=["fp16", "bf16", "fp32"])
def test_dtype_code(kernel, D, dtype):
    """fp16 K1, K2 and K3 at the wgmma head dims round in the kernel
    (code 3); fp16 at D 256 and at the mma.sync dims take the wrapper's
    rounded copies (code 2); bf16 is 1 and fp32 0."""
    code = tfa._dtype_code(kernel, D, dtype)
    if dtype == torch.float16:
        in_kernel = D in tfa.KERNEL_HEAD_DIMS
        assert code == (tfa.F16_IN_KERNEL if in_kernel else 2)
    else:
        assert code == {torch.bfloat16: 1, torch.float32: 0}[dtype]


def test_operands_copy_only_for_code_2():
    """At code 2 the wrapper hands the kernel bf16 copies of the fp16
    operands; at the in-kernel code it hands the fp16 views themselves
    (no copy), and bf16 operands pass as they are."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 128, 3 * 64))
                           .astype(np.float16))
    q, k, v = (t.reshape(2, 128, 1, 64).transpose(1, 2)
               for t in qkv.split(64, -1))
    copies = tfa._operands(2, q, k, v)
    assert all(c.dtype == torch.bfloat16 for c in copies)
    assert all(torch.equal(c, t.to(torch.bfloat16))
               for c, t in zip(copies, (q, k, v)))
    same = tfa._operands(tfa.F16_IN_KERNEL, q, k, v)
    assert all(a is b for a, b in zip(same, (q, k, v)))
    b16 = q.to(torch.bfloat16)
    assert tfa._operands(1, b16)[0] is b16
