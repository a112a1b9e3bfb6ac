"""The port's gradient clipping against the JAX package's, on the same
numpy gradients (fp32 and bf16), one parameter with ``need_clip =
False``.

Tolerances: fp32 1e-6 relative (the norms sum in different orders);
bf16 one bf16 ulp (2**-8 relative) of the value, since a scaled value on
a rounding boundary may round the other way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch.nn import clip as tclip

SHAPES = [(6, 5), (7,), (3, 4, 2)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x, np.float32)


def _case(dtype, scale=3.0, no_clip=1):
    """Params and grads of both packages; parameter ``no_clip`` has
    ``need_clip = False``."""
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(5)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [(scale * rng.standard_normal(s)).astype(np.float32)
          for s in SHAPES]
    jp = [JParameter(jnp.asarray(w, jd)) for w in ws]
    tp = [torch.from_numpy(w).to(td).requires_grad_() for w in ws]
    for i, (a, b, g) in enumerate(zip(jp, tp, gs)):
        a.grad = JTensor._wrap(jnp.asarray(g, jd))
        b.grad = torch.from_numpy(g).to(td)
        if i == no_clip:
            a.need_clip = False
            b.need_clip = False
    return jp, tp


def _close(got, want, dtype, what):
    rtol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                               atol=rtol * float(np.abs(_f32(want)).max()),
                               err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_clip_objects_match_jax(clip, dtype):
    jp, tp = _case(dtype)
    make = {"value": lambda m: m.ClipGradByValue(0.5, min=-0.7),
            "norm": lambda m: m.ClipGradByNorm(2.0),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(4.0)}[clip]
    jout = make(jclip)([(p, p.grad) for p in jp])
    tout = make(tclip)([(p, p.grad) for p in tp])
    for i, ((_, jg), (p, tg)) in enumerate(zip(jout, tout)):
        assert tg.dtype == p.dtype
        if getattr(p, "need_clip", True) is False:
            # Paddle's rule in all three; the JAX package honours
            # need_clip only in the global norm (ROADMAP.md C)
            assert tg is p.grad, i
            if clip == "global_norm":
                assert jg is jp[i].grad
            continue
        _close(tg, jg, dtype, f"{clip} grad {i}")
    if clip != "value":
        # the clip bites: some gradient shrank
        assert any(float(np.abs(_f32(g)).max())
                   < float(np.abs(_f32(p.grad)).max())
                   for p, g in tout if g is not p.grad)


def test_global_norm_leaves_need_clip_params_out_of_the_norm():
    jp, tp = _case("float32")
    gn = tclip.ClipGradByGlobalNorm(4.0)
    norm = float(gn.global_norm([(p, p.grad) for p in tp]))
    want = np.sqrt(sum(float(np.sum(_f32(p.grad) ** 2))
                       for i, p in enumerate(tp) if i != 1))
    assert norm == pytest.approx(want, rel=1e-6)
    # below the threshold nothing changes
    big = tclip.ClipGradByGlobalNorm(10 * norm)
    for (_, g), p in zip(big([(p, p.grad) for p in tp]), tp):
        torch.testing.assert_close(g, p.grad, rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_clips_given_the_sums_of_squares_clip_the_same(clip):
    """The train step hands the clip the sums of squares it took for its
    grad-norm metric: the clipped gradients are the same bits."""
    _, tp = _case("bfloat16")
    make = {"value": lambda: tclip.ClipGradByValue(0.5),
            "norm": lambda: tclip.ClipGradByNorm(2.0),
            "global_norm": lambda: tclip.ClipGradByGlobalNorm(4.0)}[clip]
    pairs = [(p, p.grad) for p in tp]
    sq = {id(p): tclip.sum_sq(p.grad) for p in tp}
    for (_, a), (_, b) in zip(make()(pairs), make()(pairs, sq)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type, dtype):
    jp, tp = _case(dtype)
    jtotal = jclip.clip_grad_norm_(jp, 1.5, norm_type=norm_type)
    ttotal = tclip.clip_grad_norm_(tp, 1.5, norm_type=norm_type)
    _close(ttotal, jtotal, dtype, "total norm")
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert b.grad.dtype == b.dtype
        _close(b.grad, a.grad, dtype, f"grad {i}")


def test_clip_grad_norm_error_if_nonfinite():
    _, tp = _case("float32")
    tp[0].grad[0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="not finite"):
        tclip.clip_grad_norm_(tp, 1.0, error_if_nonfinite=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_clip_grad_value_matches_jax(dtype):
    jp, tp = _case(dtype)
    jclip.clip_grad_value_(jp, 0.8)
    tclip.clip_grad_value_(tp, 0.8)
    for i, (a, b) in enumerate(zip(jp, tp)):
        np.testing.assert_array_equal(_f32(b.grad), _f32(a.grad),
                                      err_msg=f"grad {i}")
        assert float(b.grad.abs().max()) == pytest.approx(0.8, rel=2 ** -8)


def test_sparse_gradients_name_a4():
    """Once refused naming ROADMAP.md A4, now ported: the global-norm
    clip on a SelectedRows gradient (duplicate rows) beside a dense one
    merges the rows, puts the merged values' squares into the norm and
    scales them, as JAX's does (``_handles_selected_rows``; fp32, 1e-6
    relative).  ``ClipGradByValue``/``ByNorm`` never see one: the
    optimizer routes sparse gradients past them
    (``tests/test_torch_selected_rows.py``)."""
    from paddle_tpu.core.selected_rows import SelectedRows as JSR
    from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR
    jp, tp = _case("float32")
    rng = np.random.default_rng(9)
    rows = [1, 5, 1, 7]
    vals = (3.0 * rng.standard_normal((4, 4))).astype(np.float32)
    jt = JParameter(jnp.zeros((8, 4), jnp.float32))
    tt = torch.zeros(8, 4, requires_grad=True)
    jpairs = [(jt, JSR(rows, jnp.asarray(vals), 8))] + [
        (p, p.grad) for p in jp]
    tpairs = [(tt, TSR(torch.tensor(rows), torch.from_numpy(vals), 8))] + [
        (p, p.grad) for p in tp]
    assert tclip.ClipGradByGlobalNorm._handles_selected_rows
    jout = jclip.ClipGradByGlobalNorm(2.0)(jpairs)
    tout = tclip.ClipGradByGlobalNorm(2.0)(tpairs)
    (_, jg), (_, tg) = jout[0], tout[0]
    assert tg.rows.tolist() == np.asarray(jg.rows).tolist() == [1, 5, 7]
    _close(tg.values, jg.values, "float32", "sparse values")
    for i, ((_, a), (_, b)) in enumerate(zip(jout[1:], tout[1:])):
        _close(b, a, "float32", f"dense grad {i}")
