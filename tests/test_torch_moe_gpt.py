"""The MoE GPT of the PyTorch port (``GPTConfig(num_experts=E)``) against
the JAX package's, in fp32 on the JAX model's weights
(``load_numpy_state``) and the same numpy inputs.

* Logits, ``moe_aux_loss()`` and the gradients of ``crit + 0.01 *
  aux`` match (2 layers, hidden 32, 4 experts, top-2): within 1e-5 of
  each tensor's scale (the two packages sum in different orders).
* Every layer is an MoE layer whatever ``moe_every`` says: the JAX
  package reads it nowhere, and the port copies that.
* A 3-step ``CompiledTrainStep`` + ``AdamW`` trajectory on ``crit(m(x),
  y) + 0.01 * m.moe_aux_loss()``: losses within rtol 1e-5, parameters
  within ``LR / 20`` (AdamW's ``m / sqrt(v)`` turns an fp32 ulp of a
  near-zero gradient into up to ``lr`` of an update).
* The recompute modes give the gradients of no recompute bit for bit,
  with dropout (routing and masks replay identically).
* Greedy tokens of the port's paged, slot and speculative engines and of
  ``generate`` equal the JAX package's on requests whose decode steps
  drop tokens (3 slots, 4 experts, top-2: capacity 2 an expert for 6
  choices; ``model.moe_stats`` counts the drops).  Rows no request owns
  route and take capacity in both packages: prefill padding and idle
  decode rows.
* ``ptq_int8_decode_state`` quantizes what the JAX package's does and
  leaves the expert stacks (and the router) in the model dtype.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch
from paddle_tpu.jit import CompiledTrainStep as JStep
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu_torch import (AdamW, CompiledTrainStep, GPTConfig,
                              GPTForCausalLM, GPTPretrainingCriterion,
                              LLMEngine)
from paddle_tpu_torch import device as tdevice

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, num_experts=4, moe_top_k=2,
           moe_capacity_factor=1.25)
REL = 1e-5
LR = 1e-4
B, S = 2, 16


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _jmodel(seed, **over):
    paddle.seed(seed)
    return JGPT(JConfig(use_flash_attention=False, **dict(CFG, **over)))


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port(state, **over):
    tm = GPTForCausalLM(GPTConfig(**dict(CFG, **over)), device="cpu")
    tm.load_numpy_state(state)
    return tm


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _batch(seed=0, n=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (n, B, S)).astype(np.int64),
            rng.integers(0, 64, (n, B, S)).astype(np.int64))


def test_logits_aux_and_grads_match_jax():
    jm = _jmodel(3)
    tm = _port(_state(jm))
    ids, labels = (a[0] for a in _batch())
    jcrit, tcrit = JCrit(), GPTPretrainingCriterion()
    jl = jm(paddle.to_tensor(ids))
    jaux = jm.moe_aux_loss()
    jloss = jcrit(jl, paddle.to_tensor(labels)) + jaux * 0.01
    jloss.backward()
    names = {p.name: n for n, p in jm.named_parameters()}
    jgrads = {names[p.name]: np.asarray(p.grad.numpy())
              for p in jm.parameters()}
    tids = paddle_tpu_torch.to_tensor(ids)
    tl = tm(tids)
    taux = tm.moe_aux_loss()
    assert isinstance(taux, paddle_tpu_torch.Tensor)
    tloss = tcrit(tl, paddle_tpu_torch.to_tensor(labels)) + taux * 0.01
    tloss.backward()
    _close(tl.numpy(), np.asarray(jl.numpy()), "logits")
    assert abs(float(taux.numpy()) - float(jaux.numpy())) <= \
        REL * abs(float(jaux.numpy()))
    assert float(jaux.numpy()) > 0
    for n, p in torch.nn.Module.named_parameters(tm):
        _close(p.grad.numpy(), jgrads[n], "d" + n)
    # the torch route gives a torch aux; a dense model a zero scalar
    tm(torch.from_numpy(ids))
    assert isinstance(tm.moe_aux_loss(), torch.Tensor)
    dense = GPTForCausalLM(GPTConfig(**dict(CFG, num_experts=0)),
                           device="cpu")
    dense(tids)
    assert float(dense.moe_aux_loss().numpy()) == 0.0


def test_parameter_layout_is_jax_stacked_order():
    jm = _jmodel(3)
    tm = _port(_state(jm))
    shapes = {n: tuple(p.shape) for n, p in
              torch.nn.Module.named_parameters(tm)}
    assert shapes["gate_w"] == (2, 32, 4)
    assert shapes["fc1_w"] == (2, 4, 32, 128)
    assert shapes["fc1_b"] == (2, 4, 128)
    assert shapes["fc2_w"] == (2, 4, 128, 32)
    assert shapes["fc2_b"] == (2, 4, 32)
    assert list(tm.decode_state()["lws"])[-1] == "gate_w"
    assert tm._stacked == tuple(jm._stacked())
    for k, v in tm.gather_numpy_state().items():
        np.testing.assert_array_equal(v, _state(jm)[k], err_msg=k)


@pytest.mark.parametrize("moe_every", [1, 3])
def test_every_layer_is_moe_whatever_moe_every(moe_every):
    """The JAX package reads ``moe_every`` nowhere: every layer's FFN is
    an MoE FFN.  The port copies that reference behaviour."""
    jm = _jmodel(3, moe_every=moe_every)
    assert tuple(jm.fc1_w.shape) == (2, 4, 32, 128)
    state = _state(jm)
    ids = _batch()[0][0]
    base = _port(state)
    other = _port(state, moe_every=moe_every)
    assert tuple(other.fc1_w.shape) == (2, 4, 32, 128)
    a, b = base(torch.from_numpy(ids)), other(torch.from_numpy(ids))
    assert torch.equal(a, b)
    assert torch.equal(base.moe_aux_loss(), other.moe_aux_loss())
    _close(b.detach().numpy(), np.asarray(jm(paddle.to_tensor(ids)).numpy()),
           "logits")


def test_adamw_trajectory_matches_jax():
    jm = _jmodel(5)
    state = _state(jm)
    tm = _port(state)
    ids, labels = _batch(1, n=3)
    jcrit = JCrit()
    jopt = paddle.optimizer.AdamW(LR, parameters=jm.parameters())
    jstep = JStep(jm, lambda m, x, y: jcrit(m(x), y)
                  + m.moe_aux_loss() * 0.01, jopt)
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
          for x, y in zip(ids, labels)]
    tcrit = GPTPretrainingCriterion()
    topt = AdamW(LR, parameters=tm.parameters())
    tstep = CompiledTrainStep(tm, lambda m, x, y: tcrit(m(x), y)
                              + 0.01 * m.moe_aux_loss(), topt)
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for x, y in zip(ids, labels)]
    np.testing.assert_allclose(tl, jl, rtol=REL, atol=1e-6)
    got = tm.gather_numpy_state()
    for k, v in _state(jm).items():
        np.testing.assert_allclose(got[k], v, rtol=REL, atol=LR / 20,
                                   err_msg=k)
        if k in ("fc1_w", "fc2_w", "gate_w"):
            assert not np.array_equal(v, state[k])      # the stacks moved


@pytest.mark.parametrize("mode", [True, "selective", "selective_lean"])
def test_recompute_modes_equal_none(mode):
    state = _state(_jmodel(7))
    ids, labels = (torch.from_numpy(a[0]) for a in _batch(2))
    out = []
    for rc in (False, mode):
        tm = _port(state, recompute=rc, dropout=0.1)
        tm.train()
        logits = tm(ids, generator=torch.Generator().manual_seed(0))
        loss = GPTPretrainingCriterion()(logits, labels) \
            + 0.01 * tm.moe_aux_loss()
        loss.backward()
        out.append((loss.detach(), {n: p.grad.clone() for n, p in
                                    torch.nn.Module.named_parameters(tm)}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


# -- serving ------------------------------------------------------------------

SERVE = dict(CFG, initializer_range=0.3)
PAGED = dict(kv_layout="paged", max_slots=3, max_seq_len=32, block_size=4,
             prefill_chunk=8, min_bucket=8)
SLOTS = dict(max_slots=3, max_seq_len=32, min_bucket=4)


@pytest.fixture(scope="module")
def served():
    paddle.seed(21)
    jm = JGPT(JConfig(use_flash_attention=False, **SERVE))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**SERVE), device="cpu")
    tm.load_numpy_state(_state(jm))
    rng = np.random.default_rng(0)
    system = rng.integers(0, 64, 9).tolist()
    specs = [(rng.integers(0, 64, 10).tolist(), 6),
             (system + rng.integers(0, 64, 3).tolist(), 7),
             (rng.integers(0, 64, 5).tolist(), 9),
             (rng.integers(0, 64, 13).tolist(), 5),
             (system + rng.integers(0, 64, 6).tolist(), 8),
             (rng.integers(0, 64, 2).tolist(), 10)]
    return jm, tm, specs


def _serve(eng, specs):
    hs = [eng.add_request(p, max_new_tokens=n) for p, n in specs]
    steps = 0
    while not all(h.is_finished for h in hs):
        eng.step()
        steps += 1
        assert steps < 400, "engine did not converge"
    return [list(map(int, h.tokens)) for h in hs]


def _with_drops(tm, fn):
    """``fn()``'s result and the port's dropped choices by token count."""
    tm.moe_stats = {}
    try:
        out = fn()
        return out, {t: int(v[0]) for t, v in tm.moe_stats.items()}
    finally:
        tm.moe_stats = None


@pytest.mark.parametrize("layout", ["paged", "slots", "paged_int8"])
def test_engine_greedy_tokens_match_jax_with_drops(served, layout):
    jm, tm, specs = served
    kw = {"paged": PAGED, "slots": SLOTS,
          "paged_int8": dict(PAGED, kv_dtype="int8",
                             weight_dtype="int8")}[layout]
    want = _serve(JEngine(jm, **kw), specs)
    got, drops = _with_drops(tm, lambda: _serve(LLMEngine(tm, **kw), specs))
    assert got == want
    assert drops[3] > 0          # decode steps (3 rows) dropped choices
    assert len({t for toks in got for t in toks}) >= 5


def test_generate_matches_jax_with_drops(served):
    jm, tm, _ = served
    ids = np.random.default_rng(4).integers(0, 64, (3, 6)).astype(np.int32)
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=8).numpy())
    got, drops = _with_drops(tm, lambda: tm.generate(ids, max_new_tokens=8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert drops[3] > 0


def test_speculative_with_moe_target_matches_jax(served):
    jm, tm, specs = served
    paddle.seed(8)
    jd = JGPT(JConfig(use_flash_attention=False,
                      **dict(SERVE, num_layers=1, num_experts=0)))
    jd.eval()
    td = GPTForCausalLM(GPTConfig(**dict(SERVE, num_layers=1,
                                         num_experts=0)), device="cpu")
    td.load_numpy_state(_state(jd))
    kw = dict(PAGED, spec_k=3, n_blocks=2 * 3 * 8 + 1)
    want = _serve(JEngine(jm, draft_model=jd, **kw), specs)
    got, drops = _with_drops(tm, lambda: _serve(
        LLMEngine(tm, draft_model=td, **kw), specs))
    assert got == want
    assert drops[3 * 4] > 0      # verify passes: 3 rows x (k + 1)


def test_int8_ptq_leaves_expert_stacks_as_jax():
    from paddle_tpu.quantization import ptq_int8_decode_state as jptq
    from paddle_tpu_torch.quantization import ptq_int8_decode_state
    jm = _jmodel(3)
    tm = _port(_state(jm))
    jw, tw = jptq(jm), ptq_int8_decode_state(tm)
    assert sorted(tw["lws"]) == sorted(jw["lws"])
    for k, v in tw["lws"].items():
        want = np.asarray(jw["lws"][k])
        assert str(v.dtype).split(".")[-1] == str(want.dtype), k
        if k in ("fc1_w", "fc1_b", "fc2_w", "fc2_b", "gate_w"):
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.detach().numpy(), want,
                                          err_msg=k)
    assert "fc1_w__scale" not in tw["lws"]
    assert "qkv_w__scale" in tw["lws"]
