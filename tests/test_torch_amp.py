"""AMP in the port (``auto_cast``, ``decorate``, op dispatch's O1/O2
casts, ``GradScaler`` on the paddle-style surface) against the JAX
package.

The AMP lists act by op name, so the test records, for every op that
``apply_op`` dispatches, its name, the float dtypes of its inputs after
the AMP cast and the dtypes of its outputs, in both packages (by
wrapping each package's ``_amp_cast`` and ``_wrap_outputs``), through a
BERT forward and loss and a pre-norm encoder with a mask, under O1 and
O2, bf16 and fp16, and custom lists.  The two records must be equal, op
for op.  Integer dtypes are compared by kind (JAX's x64 is off).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.core.dispatch as jdispatch
import paddle_tpu_torch as tp
import paddle_tpu_torch.core.dispatch as tdispatch
from paddle_tpu.models.bert import BertConfig as JConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.models.bert import BertPretrainingCriterion as JCrit
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertPretrainingCriterion)

CFG = dict(vocab_size=40, hidden_size=32, num_hidden_layers=1,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=16, hidden_dropout_prob=0.1,
           attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _kind(dtype):
    name = str(dtype).replace("torch.", "")
    return "int" if "int" in name else name


def _floats(xs):
    return [_kind(x.dtype) for x in xs
            if hasattr(x, "dtype") and "float" in str(x.dtype)]


def _record(mod, log):
    """Wrap ``mod``'s AMP cast and output wrapping to append ``[name,
    input float dtypes after the cast, output dtypes]`` per op."""
    amp0, wrap0 = mod._amp_cast, mod._wrap_outputs

    def amp(name, datas):
        out = amp0(name, datas)
        log.append([name, _floats(out), None])
        return out

    def wrap(name, out, *args):
        outs = [_kind(o.dtype) for o in (out if isinstance(out, tuple)
                                         else (out,))]
        if log and log[-1][0] == name and log[-1][2] is None:
            log[-1][2] = outs
        else:                       # an op the AMP cast did not see
            log.append([name, None, outs])
        return wrap0(name, out, *args)
    mod._amp_cast, mod._wrap_outputs = amp, wrap
    return amp0, wrap0


def _traces(fn_jax, fn_torch, **amp_kw):
    logs = {}
    for key, mod, pkg, fn in (("jax", jdispatch, jp, fn_jax),
                              ("torch", tdispatch, tp, fn_torch)):
        log = logs[key] = []
        amp0, wrap0 = _record(mod, log)
        try:
            with pkg.amp.auto_cast(**amp_kw):
                fn()
        finally:
            mod._amp_cast, mod._wrap_outputs = amp0, wrap0
    return logs["jax"], logs["torch"]


def _berts(level, dtype):
    jp.seed(0)
    tp.seed(0)
    jm, tm = JBert(JConfig(**CFG)), BertForPretraining(BertConfig(**CFG))
    jp.amp.decorate(jm, level=level, dtype=dtype)
    tp.amp.decorate(tm, level=level, dtype=dtype)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG["vocab_size"], (2, 8))
    labels = np.where(rng.random((2, 8)) < 0.3, 3, -100)
    nsp = rng.integers(0, 2, (2,))

    def run(pkg, model, crit):
        def fn():
            logits, seq = model(pkg.to_tensor(ids))
            crit(logits, seq, pkg.to_tensor(labels), pkg.to_tensor(nsp))
        return fn
    return run(jp, jm, JCrit()), run(tp, tm, BertPretrainingCriterion())


@pytest.mark.parametrize("level,dtype", [("O1", "bfloat16"),
                                         ("O2", "bfloat16"),
                                         ("O1", "float16"),
                                         ("O2", "float16")])
def test_bert_casts_op_by_op_as_jax(level, dtype):
    j, t = _traces(*_berts(level, dtype), level=level, dtype=dtype)
    assert len(j) == 37 and t == j


@pytest.mark.parametrize("amp_kw", [
    dict(level="O1"),
    dict(level="O2"),
    dict(level="O1", custom_black_list={"linear"},
         custom_white_list={"layer_norm", "gelu"}),
    dict(level="O2", dtype="float16", custom_black_list={"sdpa"}),
])
def test_prenorm_encoder_with_mask_casts_as_jax(amp_kw):
    def make(pkg):
        layer = pkg.nn.TransformerEncoderLayer(
            16, 2, 32, dropout=0.0, activation="gelu", normalize_before=True)
        return pkg.nn.TransformerEncoder(layer, 2, norm=pkg.nn.LayerNorm(16))
    jp.seed(0)
    jm, tm = make(jp), make(tp)
    x = np.random.default_rng(1).standard_normal((2, 8, 16)).astype(
        np.float32)
    mask = np.tril(np.ones((8, 8), bool))[None, None]
    j, t = _traces(lambda: jm(jp.to_tensor(x), jp.to_tensor(mask)),
                   lambda: tm(tp.to_tensor(x), tp.to_tensor(mask)), **amp_kw)
    assert t == j and any(op[0] == "sdpa" for op in t)


@pytest.mark.parametrize("level,dtype", [("O2", "bfloat16"),
                                         ("O2", "float16"),
                                         ("O1", "bfloat16")])
def test_decorate_casts_what_jax_casts_in_place(level, dtype):
    jp.seed(0)
    tp.seed(0)
    jm, tm = JBert(JConfig(**CFG)), BertForPretraining(BertConfig(**CFG))
    before = {n: (p, p._data) for n, p in tm.named_parameters()}
    opt = tp.AdamW(1e-3, parameters=tm.parameters())
    held = list(opt._parameter_list)
    out = tp.amp.decorate(tm, opt, level=level, dtype=dtype)
    assert out[0] is tm and out[1] is opt
    jp.amp.decorate(jm, level=level, dtype=dtype)
    want = {n: _kind(p.dtype) for n, p in jm.named_parameters()}
    got = {n: _kind(p.dtype) for n, p in tm.named_parameters()}
    assert got == want
    cast = sorted(n for n, d in got.items() if d != "float32")
    kept = sorted(n for n, d in got.items() if d == "float32")
    if level == "O2":
        assert kept and all("norm" in n for n in kept) and cast
    else:
        assert not cast
    # the same wrapper, the same torch parameter, the optimizer's own
    for n, p in tm.named_parameters():
        assert before[n][0] is p and before[n][1] is p._data
    assert all(a is b for a, b in zip(opt._parameter_list, held))


def test_masters_start_from_the_decorated_values():
    tp.seed(0)
    m = tp.nn.Linear(8, 4)
    opt = tp.AdamW(0.0, parameters=m.parameters(), weight_decay=0.0)
    tp.amp.decorate(m, opt, level="O2")
    x = tp.to_tensor(np.ones((2, 8), np.float32))
    with tp.amp.auto_cast(level="O2"):
        loss = m(x).astype("float32") * 1.0
    loss.backward(tp.to_tensor(np.ones((2, 4), np.float32)))
    opt.step()
    for p in m.parameters():
        master = opt._master_weights[id(p._data)]
        assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
        np.testing.assert_array_equal(master.numpy(), p.numpy())


def test_grad_scaler_takes_tensors_and_layer_parameters():
    """An fp32 model: a power-of-two scale and its unscale are exact, so
    the scaled step equals the plain one bit for bit."""
    outs = []
    for scaler in (None, tp.amp.GradScaler(init_loss_scaling=2.0 ** 10)):
        tp.seed(0)
        m = tp.nn.Linear(8, 4)
        opt = tp.AdamW(1e-2, parameters=m.parameters())
        x = tp.to_tensor(np.linspace(-1, 1, 16, dtype=np.float32)
                         .reshape(2, 8))
        loss = tp.nn.functional.cross_entropy(
            m(x), tp.to_tensor(np.array([1, 3])))
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaled = scaler.scale(loss)
            assert isinstance(scaled, tp.Tensor)
            scaled.backward()
            scaler.step(opt)
            assert not scaler._found_inf
        outs.append([p.numpy() for p in m.parameters()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
