"""RMSNorm (K5) in the PyTorch port against the JAX reference.

``rms_norm`` (the CPU path of the CUDA kernel's wrapper) is held against
the JAX ``rms_norm`` Pallas kernel in interpret mode, and
``rms_norm_reference`` against JAX's, on the same numpy inputs.  The
CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version.

Tolerance: fp32 outputs 1e-6 relative per element — both sides take the
mean of squares in fp32 in another order and an rsqrt that may differ
by an ulp, which moves every element of a row by the same few 1e-7.
bf16 outputs at most one bf16 ulp of the element: the normalized value
is rounded to bf16 before the weight product, and a reordered fp32 sum
can only move that rounding by one step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import rms_norm as jrn
from paddle_tpu_torch.kernels import rms_norm as trn

_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: (x, w) dtype pairs the kernel takes
PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("float32", "bfloat16")]


@pytest.fixture()
def interpret_mode():
    jrn._INTERPRET[0] = True
    yield
    jrn._INTERPRET[0] = False


def _inputs(rows, H, xd, wd, seed):
    """The same values for both packages: numpy draws rounded to each
    dtype by JAX, then handed to torch as fp32 and cast (exact)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, H)) * 3).astype(np.float32)
    w = rng.standard_normal(H).astype(np.float32)
    jx, jw = jnp.asarray(x, _J[xd]), jnp.asarray(w, _J[wd])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(_T[xd])
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(_T[wd])
    return jx, jw, tx, tw


def _assert_close(got, want):
    got_f = got.float().numpy()
    want_f = np.asarray(want.astype(jnp.float32))
    err = np.abs(got_f - want_f)
    if got.dtype == torch.float32:
        tol = 1e-6 * np.abs(want_f)
    else:   # one bf16 ulp: x = m * 2**e with m in [0.5, 1) has 2**(e - 8)
        tol = np.ldexp(1.0, np.frexp(np.abs(want_f))[1] - 8)
    assert (err <= tol).all(), float((err - tol).max())


@pytest.mark.parametrize("rows", [7, 257])
@pytest.mark.parametrize("xd,wd", PAIRS)
def test_rms_norm_matches_jax_kernel(interpret_mode, xd, wd, rows):
    jx, jw, tx, tw = _inputs(rows, 96, xd, wd, rows)
    want = jrn.rms_norm(jx, jw)
    got = trn.rms_norm(tx, tw)
    assert got.dtype == _T[xd] == _T[str(want.dtype)]
    assert got.shape == tx.shape
    _assert_close(got, want)


@pytest.mark.parametrize("rows", [7, 257])
@pytest.mark.parametrize("xd,wd", PAIRS + [("bfloat16", "float32")])
def test_reference_matches_jax_reference(xd, wd, rows):
    jx, jw, tx, tw = _inputs(rows, 64, xd, wd, 10 + rows)
    want = jrn.rms_norm_reference(jx, jw)
    got = trn.rms_norm_reference(tx, tw)
    # the result dtype is the promotion of x's and w's, in both packages
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    _assert_close(got, want)


def test_w_wider_than_x_is_refused_by_both_kernels(interpret_mode):
    jx, jw, tx, tw = _inputs(7, 64, "bfloat16", "float32", 3)
    with pytest.raises(ValueError, match="swap"):
        jrn.rms_norm(jx, jw)
    with pytest.raises(TypeError, match="wider"):
        trn.rms_norm(tx, tw)
    # while both plain versions return fp32 for it
    assert jrn.rms_norm_reference(jx, jw).dtype == jnp.float32
    assert trn.rms_norm_reference(tx, tw).dtype == torch.float32


def test_leading_dims_block_rows_and_no_launch_on_cpu():
    _, _, tx, tw = _inputs(24, 40, "float32", "float32", 4)
    x3 = tx.reshape(2, 12, 40)
    before = trn.rms_norm.launches
    out = trn.rms_norm(x3, tw, eps=1e-5, block_rows=5)   # block_rows: TPU only
    assert trn.rms_norm.launches == before == 0
    assert out.shape == x3.shape
    np.testing.assert_array_equal(
        out.reshape(24, 40).numpy(),
        trn.rms_norm_reference(tx, tw, eps=1e-5).numpy())
    with pytest.raises(ValueError, match="shape"):
        trn.rms_norm(tx, tw[:-1])
