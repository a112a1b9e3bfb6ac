"""Sparse (SelectedRows) gradients in the PyTorch port against the JAX
package: ``nn.Embedding(sparse=True)``'s gradient, the optimizers' sparse
rules (SGD's row-wise update, Adam's densify fallback, Adam/AdamW
``lazy_mode``, ``amsgrad``), the three clips, microbatch accumulation and
the dense + sparse merge — the cases of ``tests/test_selected_rows.py``,
each run in both packages on the same numpy table and ids.

Both packages run the same fp32 formulas; sums of duplicate rows and of
the loss may run in another order, so values are held to ``RTOL`` of
their scale.  What must be exact is exact: the rows a gradient carries,
and the untouched rows of a lazy update (bit-equal to the start).
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu import SelectedRows as JSelectedRows
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.jit import CompiledTrainStep

V, D = 12, 4
RTOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal((V, D)).astype(
        np.float32)


def _ids(*rows):
    return np.array(rows, np.int64)


def _pair(w0, padding_idx=None, sparse=True):
    """The same table as a JAX and a port ``Embedding``."""
    je = jp.nn.Embedding(V, D, padding_idx=padding_idx, sparse=sparse)
    te = tp.nn.Embedding(V, D, padding_idx=padding_idx, sparse=sparse)
    with jp.no_grad():
        je.weight.set_value(jp.to_tensor(w0))
    te.weight.set_value(w0)
    return je, te


def _jloss(out, coef):
    return (out * jp.to_tensor(coef)).sum()


def _tloss(out, coef):
    """sum(out * coef) on the port's graph (the port's ``Tensor`` has no
    reduction ops yet: ROADMAP.md A10)."""
    return Tensor._wrap((out._data * torch.from_numpy(coef)).sum())


def _coef(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _backward(je, te, ids, coef):
    _jloss(je(jp.to_tensor(ids)), coef).backward()
    _tloss(te(tp.to_tensor(ids)), coef).backward()


def test_to_dense_and_merge_rows_match_jax():
    rows, vals = [1, 3, 1, 7, 3], _coef((5, D))
    js = JSelectedRows(rows, vals, V)
    ts = SelectedRows(torch.tensor(rows), torch.from_numpy(vals), V)
    _close(ts.numpy(), js.numpy())
    jm, tm = js.merge_rows(), ts.merge_rows()
    assert tm.rows.tolist() == np.asarray(jm.rows).tolist() == [1, 3, 7]
    _close(tm.values.numpy(), np.asarray(jm.values))
    assert ts.shape == js.shape == [V, D]


@pytest.mark.parametrize("padding_idx", [None, 0])
def test_sparse_grad_rows_and_values_match_jax(padding_idx):
    """The gradient is a SelectedRows of the batch's unique rows, sorted,
    with the values JAX gives (a padding row carries a zero row); the
    forward equals the dense lookup."""
    w0 = _table()
    je, te = _pair(w0, padding_idx)
    ids = _ids([[0, 5, 5], [9, 1, 0]])
    jout, tout = je(jp.to_tensor(ids)), te(tp.to_tensor(ids))
    _close(tout.numpy(), jout.numpy(), "forward")
    coef = _coef(ids.shape + (D,))
    _jloss(jout, coef).backward()
    _tloss(tout, coef).backward()
    jg, tg = je.weight.grad, te.weight.grad
    assert isinstance(jg, JSelectedRows) and isinstance(tg, SelectedRows)
    assert tg.rows.tolist() == np.asarray(jg.rows).tolist() == [0, 1, 5, 9]
    _close(tg.values.numpy(), np.asarray(jg.values), "values")
    if padding_idx is not None:
        np.testing.assert_array_equal(tout.numpy()[ids == padding_idx], 0.0)
        np.testing.assert_array_equal(tg.values.numpy()[0], 0.0)


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(learning_rate=0.1)),              # the row-wise rule
    ("Adam", dict(learning_rate=0.05)),            # densified
    ("Adam", dict(learning_rate=0.05, lazy_mode=True)),
    ("AdamW", dict(learning_rate=0.1, weight_decay=0.5, lazy_mode=True)),
    ("Adam", dict(learning_rate=0.05, lazy_mode=True, amsgrad=True)),
], ids=["sgd", "adam-densify", "adam-lazy", "adamw-lazy-decay",
        "adam-lazy-amsgrad"])
def test_sparse_trajectories_match_jax(name, kw):
    """Three steps over ids that repeat a row and leave others untouched:
    parameters and moments as JAX's.  The lazy rules leave untouched
    rows bit-equal to the start (AdamW decays only the touched rows);
    the densified ones (no lazy_mode, or amsgrad) move them as a dense
    gradient would."""
    w0 = _table()
    je, te = _pair(w0)
    jo = getattr(jp.optimizer, name)(parameters=[je.weight], **kw)
    to = getattr(tp.optimizer, name)(parameters=[te.weight], **kw)
    ids = _ids(3, 4, 3, 8)
    for step in range(3):
        _backward(je, te, ids, _coef((4, D), seed=step))
        jo.step()
        jo.clear_grad()
        to.step()
        to.clear_grad()
    _close(te.weight.numpy(), je.weight.numpy(), f"{name} {kw}")
    jstate, tstate = jo.state_dict(), to.state_dict()
    for acc, store in jstate["accumulators"].items():
        (want,) = store.values()
        _close(tstate["accumulators"][acc]["param_0"], want, acc)
    untouched = [r for r in range(V) if r not in (3, 4, 8)]
    lazy = kw.get("lazy_mode") and not kw.get("amsgrad")
    if name == "SGD" or lazy:
        np.testing.assert_array_equal(te.weight.numpy()[untouched],
                                      w0[untouched])
    elif "amsgrad" not in kw:
        # densified Adam: a zero gradient still moves nothing here, but
        # the moments of untouched rows decay (to 0 from 0) and the beta
        # powers advance for the whole table, as in JAX
        assert float(tstate["accumulators"]["beta1_pow"]["param_0"]) == \
            pytest.approx(0.9 ** 3)


@pytest.mark.parametrize("clip", ["ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm"])
def test_clips_on_sparse_gradients_match_jax(clip):
    """The global-norm clip merges the rows into the norm with a dense
    parameter's gradient and scales the values; the other two let the
    sparse gradient bypass them with JAX's RuntimeWarning."""
    w0 = _table()
    je, te = _pair(w0)
    lin = _coef((D, 3), seed=5)
    jl = jp.nn.Linear(D, 3)
    tl = tp.nn.Linear(D, 3)
    with jp.no_grad():
        jl.weight.set_value(jp.to_tensor(lin))
        jl.bias.set_value(jp.to_tensor(np.zeros(3, np.float32)))
    tl.weight.set_value(lin)
    tl.bias.set_value(np.zeros(3, np.float32))
    make = {"ClipGradByValue": dict(max=0.5),
            "ClipGradByNorm": dict(clip_norm=0.3),
            "ClipGradByGlobalNorm": dict(clip_norm=0.3)}[clip]
    jo = jp.optimizer.SGD(0.5, parameters=[je.weight, *jl.parameters()],
                          grad_clip=getattr(jp.nn, clip)(**make))
    to = tp.optimizer.SGD(0.5, parameters=[te.weight, *tl.parameters()],
                          grad_clip=getattr(tp.nn, clip)(**make))
    ids = _ids([2, 2, 6], [1, 6, 6])
    coef = _coef((2, 3, 3), seed=7)
    _jloss(jl(je(jp.to_tensor(ids))), coef).backward()
    _tloss(tl(te(tp.to_tensor(ids))), coef).backward()
    bypass = clip != "ClipGradByGlobalNorm"
    for opt in (jo, to):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            opt.step()
        assert any(issubclass(w.category, RuntimeWarning)
                   and "bypass clipping" in str(w.message)
                   for w in seen) == bypass
    _close(te.weight.numpy(), je.weight.numpy(), "table")
    _close(tl.weight.numpy(), jl.weight.numpy(), "linear")
    _close(tl.bias.numpy(), jl.bias.numpy(), "bias")


def test_microbatch_accumulation_concatenates_rows_as_jax():
    w0 = _table()
    je, te = _pair(w0)
    for i, ids in enumerate((_ids(1, 2), _ids(2, 3))):
        _backward(je, te, ids, _coef((2, D), seed=i))
    jg, tg = je.weight.grad, te.weight.grad
    assert tg.rows.tolist() == np.asarray(jg.rows).tolist() == [1, 2, 2, 3]
    _close(tg.numpy(), jg.numpy())


def test_dense_and_sparse_mix_merges_to_dense_as_jax():
    """A table used through the sparse lookup and densely in one loss: the
    gradient merges to dense, as in JAX."""
    w0 = _table()
    je, te = _pair(w0)
    ids = _ids(1, 2)
    coef = _coef((2, D))
    jloss = _jloss(je(jp.to_tensor(ids)), coef) + (je.weight * je.weight
                                                   ).sum()
    tloss = Tensor._wrap(_tloss(te(tp.to_tensor(ids)), coef)._data
                         + (te.weight._data ** 2).sum())
    jloss.backward()
    tloss.backward()
    assert not isinstance(je.weight.grad, JSelectedRows)
    assert not isinstance(te.weight.grad, SelectedRows)
    _close(te.weight.grad.numpy(), je.weight.grad.numpy())


def test_paddle_grad_and_clear_gradient_as_jax():
    """``paddle.grad`` leaves ``.grad`` alone (the table is not in its
    graph: the unused-input error, as in JAX); ``clear_gradient(True)``
    on a SelectedRows leaves dense zeros."""
    w0 = _table()
    je, te = _pair(w0)
    ids = _ids(1, 2)
    coef = _coef((2, D))
    with pytest.raises(RuntimeError, match="unused"):
        jp.grad(_jloss(je(jp.to_tensor(ids)), coef), [je.weight])
    with pytest.raises(RuntimeError, match="unused"):
        tp.grad(_tloss(te(tp.to_tensor(ids)), coef), [te.weight])
    assert je.weight.grad is None and te.weight.grad is None
    _backward(je, te, ids, coef)
    for e in (je, te):
        e.weight.clear_gradient(set_to_zero=True)
    np.testing.assert_array_equal(te.weight.grad.numpy(),
                                  je.weight.grad.numpy())
    assert te.weight.grad.numpy().shape == (V, D)


def test_train_step_takes_the_dense_path():
    """Inside ``CompiledTrainStep`` the lookup is dense (JAX's does so
    under tracing): the step matches an eager dense twin's."""
    w0 = _table()
    _, ts = _pair(w0, sparse=True)
    _, td = _pair(w0, sparse=False)
    ids = torch.from_numpy(_ids(3, 4, 3))
    coef = _coef((3, D))
    losses = []
    for emb in (ts, td):
        opt = tp.optimizer.Adam(0.05, parameters=[emb.weight])
        step = CompiledTrainStep(emb, lambda m, x: _tloss(m(x), coef), opt)
        losses.append(float(step(ids)))
        assert emb.weight.grad is None
    assert losses[0] == losses[1]
    np.testing.assert_array_equal(ts.weight.numpy(), td.weight.numpy())
