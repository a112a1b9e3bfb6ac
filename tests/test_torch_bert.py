"""BERT pretraining (``BertForPretraining`` + ``BertPretrainingCriterion``)
in the port against the JAX package, on the paddle-style surface.

A tiny BERT (vocab 40, hidden 32, 2 layers, 4 heads, intermediate 64,
S 16) gets the JAX model's weights (``load_numpy_state``) and the same
numpy ids, MLM labels on ~30 % of the positions (-100 elsewhere) and
NSP labels.  Both packages take their plain attention on the CPU.

Tolerances (each stated where it is used):
* fp32: loss to 1e-5 relative, every gradient to 1e-4 of its scale (the
  same fp32 math in another order, through 2 layers, a 40-way softmax and
  the tied decoder); the key biases, whose true gradient is 0, to 1e-4 of
  the query bias' gradient scale.
* bf16 O2: the port's loss and gradients within twice the JAX package's
  own distance from its fp32 run on the same (bf16-valued) weights, plus
  the fp32 tolerance at the fp32 result's scale (as the serving parity
  tests, e.g. ``tests/test_torch_slots.py``, hold bf16).  That distance is taken as at least half a bf16 ulp
  of the tensor's scale: a bf16 result is one rounding, anywhere within
  half an ulp of the exact value, so for a tensor of a few elements
  (the NSP bias' 2) JAX's own distance can fall far below what a result
  rounded the other way is off by.
* AdamW trajectory (fp32, 3 steps): every element within 1 % of lr,
  but for the key biases, held to Adam's bound (2 · steps · lr): their
  gradients are rounding noise, whose sign Adam's normalised update
  follows.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models.bert import BertConfig as JConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.models.bert import BertPretrainingCriterion as JCrit
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertPretrainingCriterion)

CFG = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=16, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
B, S, LR = 2, 16, 1e-3
TOL = 1e-4


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, S))
    labels = np.where(rng.random((B, S)) < 0.3,
                      rng.integers(0, CFG["vocab_size"], (B, S)), -100)
    return ids, labels, rng.integers(0, 2, (B,))


def _models(round_bf16=False, **kw):
    jp.seed(0)
    jm = JBert(JConfig(**{**CFG, **kw}))
    state = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    if round_bf16:      # the weights O2 will see, also for the fp32 runs
        state = {n: torch.tensor(v).bfloat16().float().numpy()
                 for n, v in state.items()}
        jm.set_state_dict(state)
    tm = BertForPretraining(BertConfig(**{**CFG, **kw}))
    tm.load_numpy_state(state)
    return jm, tm


def _loss_and_grads(pkg, model, crit, batch, level=None):
    ids, labels, nsp = batch
    with pkg.amp.auto_cast(enable=level is not None, level=level or "O1"):
        logits, seq = model(pkg.to_tensor(ids))
        loss = crit(logits, seq, pkg.to_tensor(labels), pkg.to_tensor(nsp))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy(), np.float64)
             for n, p in model.named_parameters()}
    for p in model.parameters():
        p.clear_gradient()
    return float(loss), grads


def _query_scale(grads, n):
    return np.abs(grads[n.replace("k_proj", "q_proj")]).max()


def test_loss_and_every_gradient_match_jax_fp32():
    jm, tm = _models()
    batch = _batch()
    jl, jg = _loss_and_grads(jp, jm, JCrit(), batch)
    tl, tg = _loss_and_grads(tp, tm, BertPretrainingCriterion(), batch)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert list(tg) == list(jg) and len(tg) == 45
    for n in jg:
        ref = (_query_scale(jg, n) if n.endswith("k_proj.bias")
               else np.abs(jg[n]).max())
        assert np.abs(tg[n] - jg[n]).max() <= TOL * ref, n


def test_bf16_o2_within_twice_jax_own_bf16_distance():
    jm, tm = _models(round_bf16=True)
    batch = _batch(1)
    runs = {}
    for level in (None, "O2"):
        if level:
            jp.amp.decorate(jm, level=level)
            tp.amp.decorate(tm, level=level)
        runs[level] = (_loss_and_grads(jp, jm, JCrit(), batch, level),
                       _loss_and_grads(tp, tm, BertPretrainingCriterion(),
                                       batch, level))
    ((jl32, jg32), _), ((jl16, jg16), (tl16, tg16)) = runs[None], runs["O2"]
    assert abs(tl16 - jl16) <= 2 * abs(jl16 - jl32) + TOL * abs(jl32)
    checked = 0
    for n in jg32:
        noise = np.abs(jg16[n] - jg32[n]).max()
        scale = (_query_scale(jg32, n) if n.endswith("k_proj.bias")
                 else np.abs(jg32[n]).max())
        half_ulp = 2.0 ** (np.floor(np.log2(np.abs(jg32[n]).max())) - 8)
        err = np.abs(tg16[n] - jg16[n]).max()
        assert err <= 2 * max(noise, half_ulp) + TOL * scale, (n, err, noise)
        checked += noise > 0
    assert checked > 40      # bf16 moved (almost) every gradient


def _trajectory(pkg, model, crit, steps=3):
    opt = pkg.optimizer.AdamW(LR, parameters=model.parameters(),
                              weight_decay=0.01,
                              grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0))
    losses = []
    for i in range(steps):
        ids, labels, nsp = _batch(10 + i)
        logits, seq = model(pkg.to_tensor(ids))
        loss = crit(logits, seq, pkg.to_tensor(labels), pkg.to_tensor(nsp))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, {n: np.asarray(p.numpy(), np.float64)
                    for n, p in model.named_parameters()}


def test_three_step_adamw_trajectory_matches_jax():
    jm, tm = _models()
    jl, jp_ = _trajectory(jp, jm, JCrit())
    tl, tp_ = _trajectory(tp, tm, BertPretrainingCriterion())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in jp_:
        bound = 2 * 3 * LR if n.endswith("k_proj.bias") else 1e-2 * LR
        assert np.abs(tp_[n] - jp_[n]).max() <= bound, n


def _seeded_grads(recompute, seed=5, **kw):
    tp.seed(seed)
    m = BertForPretraining(BertConfig(**{**CFG, "hidden_dropout_prob": 0.1,
                                         "recompute": recompute, **kw}))
    tp.seed(seed + 1)          # the dropout masks' stream
    return _loss_and_grads(tp, m, BertPretrainingCriterion(), _batch(2))


def test_recompute_with_dropout_equals_no_recompute():
    """The replayed forward draws the same dropout masks: the recompute
    restores the paddle-style generator (``torch.utils.checkpoint``
    restores only torch's global RNG)."""
    (l0, g0), (l1, g1) = _seeded_grads(False), _seeded_grads(True)
    assert l0 == l1
    for n in g0:
        np.testing.assert_array_equal(g1[n], g0[n], err_msg=n)
    # the masks matter: another dropout stream moves the gradients
    tp.seed(5)
    m = BertForPretraining(BertConfig(**{**CFG, "hidden_dropout_prob": 0.1,
                                         "recompute": True}))
    tp.seed(99)
    _, g3 = _loss_and_grads(tp, m, BertPretrainingCriterion(), _batch(2))
    assert any(not np.array_equal(g3[n], g0[n]) for n in g0)


def test_recompute_restores_auto_cast_for_its_replay():
    """The backward (and so the replay) runs after ``auto_cast`` closed:
    O2 with recompute equals O2 without, bit for bit."""
    out = []
    for recompute in (False, True):
        tp.seed(5)
        m = BertForPretraining(BertConfig(**{**CFG, "recompute": recompute}))
        tp.amp.decorate(m, level="O2")
        out.append(_loss_and_grads(tp, m, BertPretrainingCriterion(),
                                   _batch(3), level="O2"))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for n in g0:
        np.testing.assert_array_equal(g1[n], g0[n], err_msg=n)


def test_recompute_under_o2_keeps_norm_weights_fp32_unlike_jax():
    """Reference behaviour the port does not copy (ROADMAP.md C): the JAX
    ``recompute`` is one dispatched op named "recompute", so under O2 its
    AMP cast rounds every fp32 input, the layer's LayerNorm weights
    included, to bf16.  A norm weight of 1 + 2^-10 (1.0 in bf16) moves
    the JAX output with recompute; the port's recompute keeps the fp32
    weight, as it is without recompute."""
    outs = {}
    for recompute in (False, True):
        jm, tm = _models(num_hidden_layers=1, recompute=recompute)
        jp.amp.decorate(jm, level="O2")
        tp.amp.decorate(tm, level="O2")
        for pkg, m in ((jp, jm), (tp, tm)):
            norm = m.bert.encoder.layers[0].norm2
            norm.weight.set_value(np.full(32, 1 + 2.0 ** -10, np.float32))
            with pkg.amp.auto_cast(level="O2"):
                seq, _ = m.bert(pkg.to_tensor(_batch()[0]))
            outs[pkg.__name__, recompute] = np.asarray(seq.numpy())
    assert not np.array_equal(outs["paddle_tpu", True],
                              outs["paddle_tpu", False])
    np.testing.assert_array_equal(outs["paddle_tpu_torch", True],
                                  outs["paddle_tpu_torch", False])


def test_compiled_train_step_over_a_layer_equals_the_eager_loop():
    """``CompiledTrainStep(model, loss_fn, opt)`` with a ``Layer`` model
    and a ``Tensor`` loss: the same losses and parameters, bit for bit,
    as ``loss.backward(); opt.step(); opt.clear_grad()`` (dropout 0.1,
    the same seeds: the same masks)."""
    res = []
    for compiled in (False, True):
        tp.seed(7)
        m = BertForPretraining(BertConfig(**{**CFG,
                                             "hidden_dropout_prob": 0.1}))
        crit = BertPretrainingCriterion()
        opt = tp.AdamW(LR, parameters=m.parameters(), weight_decay=0.01)

        def loss_fn(model, ids, labels, nsp):
            logits, seq = model(ids)
            return crit(logits, seq, labels, nsp)
        step = tp.CompiledTrainStep(m, loss_fn, opt)
        tp.seed(8)
        losses = []
        for i in range(3):
            ids, labels, nsp = (torch.from_numpy(a) for a in _batch(20 + i))
            if compiled:
                losses.append(float(step(ids, labels, nsp)))
            else:
                loss = loss_fn(m, ids, labels, nsp)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
        res.append((losses, [p.numpy() for p in m.parameters()]))
    assert res[0][0] == res[1][0]
    for a, b in zip(res[0][1], res[1][1]):
        np.testing.assert_array_equal(a, b)


def test_bert_large_config_takes_overrides_unlike_jax():
    """Reference fault (ROADMAP.md C): the JAX ``bert_large(**kw)`` passes
    its own depth and widths beside ``kw``, so a cut depth raises."""
    cfg = BertConfig.bert_large(num_hidden_layers=2, recompute=True)
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.recompute) == (2, 1024, 16, 4096, True)
    assert vars(BertConfig.bert_large()) == vars(JConfig.bert_large())
    with pytest.raises(TypeError):
        JConfig.bert_large(num_hidden_layers=2)
