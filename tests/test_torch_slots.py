"""The slot layout and ``generate`` of the PyTorch port against the JAX
package.

Both packages get the same weights (the JAX model's ``state_dict`` as
numpy arrays, loaded by ``load_numpy_state``) and the same numpy inputs.

* ``prefill_slot`` and ``decode_slots`` give the JAX logits and K/V in
  fp32 (``TOL``: atol and rtol 1e-4, two fp32 implementations of one
  2-layer model that sum in different orders), with and without RoPE.
* bf16: each package is also run in fp32 on the same bf16 weights and
  inputs, and the port's bf16 result is held to the JAX package's within
  twice the JAX package's own distance (max abs) from its fp32 run — the
  reference's bf16 rounding noise, measured per case — plus ``TOL`` at
  the case's scale (``_bf16_within_fp32_distance``).  The bound does not
  grow with the port's own error; measured, the port's distance is at
  most 1.72 times the reference's.  Greedy tokens must be equal.
* The slot ``LLMEngine`` gives the JAX slot engine's greedy tokens and
  finish reasons, request for request, with staggered arrivals, eos,
  deadline, cancellation and slot reuse, and JAX ``generate``'s tokens.
  The weights use ``initializer_range=0.3``: at 0.02 the tiny model
  repeats one token and a token test would prove little.
* The port's ``generate`` gives JAX ``generate``'s greedy tokens (eos
  fill included); a sampled batch-1 ``generate`` gives the port's slot
  engine's tokens for the same seed (the two packages' random streams
  differ, so sampling is never compared across them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch.profiler import counters as tcounters

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3)
ENGINE = dict(max_slots=3, max_seq_len=32, min_bucket=4)
L, NH, HD = 2, 4, 8


def _weights(seed, use_rope, round_bf16=False):
    paddle.seed(seed)
    jm = JGPT(JConfig(use_flash_attention=False, use_rope=use_rope, **CFG))
    w = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    if round_bf16:
        w = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
             for k, v in w.items()}
    return w


def _pair(w, use_rope=False, dtype="float32"):
    jm = JGPT(JConfig(use_flash_attention=False, use_rope=use_rope,
                      dtype=dtype, **CFG))
    jm.set_state_dict(w)
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(use_rope=use_rope, dtype=dtype, **CFG),
                        device="cpu")
    tm.load_numpy_state(w)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(_weights(21, False))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _slot_steps(jm, tm, dtype, use_rope):
    """prefill_slot of a 5-token prompt in an 8-token bucket into a
    12-position row that holds garbage, then one decode_slots step over
    a 3-row arena (rows at positions 5 and 11, one idle row at 0).
    Returns ``{name: (port, jax)}`` as fp32 numpy."""
    rng = np.random.default_rng(3 + use_rope)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jw, tw = jm.decode_state(), tm.decode_state()
    ids = np.zeros((1, 8), np.int32)
    ids[0, :5] = rng.integers(0, 64, 5)
    jk, jv, jl = jm.prefill_slot(jw, jnp.asarray(ids), 5)
    row_k = torch.full((L, 1, 12, NH, HD), 7.0, dtype=tdt)
    row_v = torch.full((L, 1, 12, NH, HD), -3.0, dtype=tdt)
    tl = tm.prefill_slot(tw, torch.from_numpy(ids).long(), 5, row_k, row_v)
    out = {"prefill_logits": (tl, jl), "prefill_k": (row_k[:, :, :8], jk),
           "prefill_v": (row_v[:, :, :8], jv)}
    assert not row_k[:, :, 5:].any() and not row_v[:, :, 5:].any()

    arena = [rng.standard_normal((L, 3, 16, NH, HD)).astype(np.float32)
             for _ in "kv"]
    tok = np.array([ids[0, 4], 9, 0], np.int32)
    pos = np.array([5, 11, 0], np.int32)
    jl, jk, jv = jm.decode_slots(jw, jnp.asarray(tok), jnp.asarray(pos),
                                 *(jnp.asarray(a, dtype) for a in arena))
    tk, tv = (torch.from_numpy(a).to(tdt) for a in arena)
    tl = tm.decode_slots(tw, torch.from_numpy(tok), torch.from_numpy(pos),
                         tk, tv)
    out.update(decode_logits=(tl, jl), decode_k=(tk, jk), decode_v=(tv, jv))
    return {k: (_f32(a), _f32(b)) for k, (a, b) in out.items()}


@pytest.mark.parametrize("use_rope", [False, True])
def test_prefill_slot_and_decode_slots_match_jax(use_rope):
    jm, tm = _pair(_weights(5, use_rope), use_rope)
    for name, (got, want) in _slot_steps(jm, tm, "float32", use_rope).items():
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def _bf16_within_fp32_distance(runs, argmax_of=()):
    """``runs[dtype][name] = (port, jax)``: the port's bf16 result is held
    to the JAX package's within twice the JAX package's own distance (max
    abs) from its fp32 result plus ``TOL`` at the fp32 result's scale;
    the argmax of each name in ``argmax_of`` (greedy tokens) must be
    equal."""
    worst = {}
    for name, (tb, jb) in runs["bfloat16"].items():
        jf = runs["float32"][name][1]
        noise = np.abs(jb - jf).max()
        err = np.abs(tb - jb).max()
        tol = 2 * noise + TOL["atol"] + TOL["rtol"] * np.abs(jf).max()
        worst[name] = (err, noise)
        assert noise > 0 and err <= tol, (name, err, noise)
        if name in argmax_of:
            np.testing.assert_array_equal(tb.argmax(-1), jb.argmax(-1))
    return worst


@pytest.mark.parametrize("use_rope", [False, True])
def test_slot_steps_bf16_within_fp32_distance(use_rope):
    w = _weights(6, use_rope, round_bf16=True)
    runs = {d: _slot_steps(*_pair(w, use_rope, d), d, use_rope)
            for d in ("float32", "bfloat16")}
    _bf16_within_fp32_distance(runs, ("prefill_logits", "decode_logits"))


def _serve(eng, counters, specs, schedule=None):
    """Run ``specs`` through ``eng``; ``schedule`` maps a step number to
    a callback (late arrivals, cancellations) given the handles."""
    before = counters.snapshot()
    handles = [eng.add_request(p, **kw) for p, kw in specs]
    steps = 0
    while not all(h.is_finished for h in handles) or (
            schedule and steps <= max(schedule)):
        if schedule and steps in schedule:
            schedule[steps](eng, handles)
        eng.step()
        steps += 1
        assert steps < 300, "engine did not converge"
    return handles, counters.delta(before)


def _jax_generate(jm, prompts, n, **kw):
    out = jm.generate(paddle.to_tensor(np.asarray(prompts, np.int32)),
                      max_new_tokens=n, **kw)
    return np.asarray(out.numpy())[:, len(prompts[0]):].tolist()


@pytest.mark.parametrize("use_rope", [False, True])
def test_greedy_slot_engine_matches_jax_engine_and_generate(use_rope):
    jm, tm = _pair(_weights(31, use_rope), use_rope)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n).tolist() for n in (5, 3, 9, 6, 11)]
    specs = [(p, dict(max_new_tokens=6)) for p in prompts]
    th, _ = _serve(LLMEngine(tm, **ENGINE), tcounters, specs)
    jh, _ = _serve(JEngine(jm, **ENGINE), jcounters, specs)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert all(h.finish_reason == "length" for h in th)
    assert len({t for h in th for t in h.tokens}) >= 5       # tokens vary
    assert th[0].tokens == _jax_generate(jm, [prompts[0]], 6)[0]


def test_staggered_eos_deadline_cancel_and_slot_reuse(models):
    """Seven requests through two slots: late arrivals join mid-flight
    decodes, one stops at eos, one expires in the queue, one is
    cancelled while decoding and one while queued; every slot is handed
    out again.  Tokens, finish reasons and eviction counters equal the
    JAX slot engine's."""
    jm, tm = models
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, n).tolist() for n in (6, 4, 8, 5, 7, 3, 9)]
    eos = _jax_generate(jm, [prompts[1]], 8)[0][2]
    specs = [(prompts[0], dict(max_new_tokens=6)),
             (prompts[1], dict(max_new_tokens=8, eos_token_id=eos)),
             (prompts[2], dict(max_new_tokens=5, deadline_s=0.0)),
             (prompts[3], dict(max_new_tokens=12)),
             (prompts[4], dict(max_new_tokens=4))]
    late = [(prompts[5], dict(max_new_tokens=5)),
            (prompts[6], dict(max_new_tokens=6))]

    def arrive(eng, handles):
        handles += [eng.add_request(p, **kw) for p, kw in late]

    def cancel(eng, handles):
        handles[3].cancel()     # decoding by now
        handles[6].cancel()     # still queued

    moved = {}
    for name, eng, ctr in (("torch", LLMEngine(tm, **dict(ENGINE,
                                                         max_slots=2)),
                            tcounters),
                           ("jax", JEngine(jm, **dict(ENGINE, max_slots=2)),
                            jcounters)):
        hs, d = _serve(eng, ctr, specs, {2: arrive, 6: cancel})
        moved[name] = ([h.tokens for h in hs], [h.finish_reason for h in hs],
                       [d.get(f"serving.evictions.{r}", 0) for r in
                        ("length", "eos", "deadline", "cancelled")])
        assert eng.stats()["free_slots"] == 2
    assert moved["torch"] == moved["jax"]
    tokens, reasons, _ = moved["torch"]
    assert reasons == ["length", "eos", "deadline", "cancelled", "length",
                       "length", "cancelled"]
    assert tokens[1][-1] == eos and tokens[2] == [] and tokens[6] == []
    assert 0 < len(tokens[3]) < 12


def test_generate_matches_jax_generate(models):
    jm, tm = models
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 64, (3, 6)).astype(np.int32)
    want = _jax_generate(jm, prompts.tolist(), 7)
    eos = want[1][2]           # fills the rest of row 1 (and others)
    got = tm.generate(prompts, max_new_tokens=7)
    assert got.dtype == torch.int64 and got.shape == (3, 13)
    assert got[:, :6].tolist() == prompts.tolist()
    assert got[:, 6:].tolist() == want
    got = tm.generate(torch.from_numpy(prompts), max_new_tokens=7,
                      eos_token_id=eos)[:, 6:].tolist()
    assert got == _jax_generate(jm, prompts.tolist(), 7, eos_token_id=eos)
    assert got[1][2:] == [eos] * 5


def test_sampled_generate_equals_slot_engine(models):
    """One generator seeded with the request's seed, one draw after the
    prefill and one a step, in both: the same tokens, also beside a
    greedy request in the same batch."""
    _, tm = models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, n).tolist() for n in (4, 7, 11)]
    kw = dict(do_sample=True, temperature=0.8, top_k=8, top_p=0.9)
    want = [tm.generate([p], max_new_tokens=5, seed=100 + i, **kw)[0, len(p):]
            .tolist() for i, p in enumerate(prompts)]
    greedy = tm.generate([prompts[0]], max_new_tokens=5)[0, 4:].tolist()
    eng = LLMEngine(tm, **dict(ENGINE, max_slots=4))
    hs = [eng.add_request(p, max_new_tokens=5, seed=100 + i, **kw)
          for i, p in enumerate(prompts)]
    hg = eng.add_request(prompts[0], max_new_tokens=5)
    while not all(h.is_finished for h in (*hs, hg)):
        eng.step()
    assert [h.tokens for h in hs] == want
    assert hg.tokens == greedy
    assert len({tuple(t) for t in want}) == 3
    # the same seed again repeats itself; another seed moves
    again = tm.generate([prompts[0]], max_new_tokens=5, seed=100, **kw)
    other = tm.generate([prompts[0]], max_new_tokens=5, seed=7, **kw)
    assert again[0, 4:].tolist() == want[0]
    assert other[0, 4:].tolist() != want[0]


def test_generate_validates_lengths():
    _, tm = _pair(_weights(8, False))
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.generate([[1] * 30], max_new_tokens=3)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tm.generate([[1, 2]], max_new_tokens=0)
    _, rope = _pair(_weights(8, True), use_rope=True)
    assert rope.generate([[1] * 30], max_new_tokens=3).shape == (1, 33)


def test_poisoned_request_finishes_with_error(models, monkeypatch):
    """An exception in one request's prefill finishes that request with
    ``finish_reason="error"`` and hands its slot back; the others are
    served."""
    _, tm = models
    eng = LLMEngine(tm, **dict(ENGINE, max_slots=2))
    real = tm.prefill_slot

    def prefill(w, ids, length, *caches):
        if length == 7:
            raise RuntimeError("poisoned prompt")
        return real(w, ids, length, *caches)

    monkeypatch.setattr(tm, "prefill_slot", prefill)
    before = tcounters.snapshot()
    hs = [eng.add_request(list(range(1, n + 1)), max_new_tokens=3)
          for n in (5, 7, 6)]
    while not all(h.is_finished for h in hs):
        eng.step()
    assert [h.finish_reason for h in hs] == ["length", "error", "length"]
    assert isinstance(hs[1].error, RuntimeError) and hs[1].tokens == []
    assert tcounters.delta(before).get("serving.request_errors") == 1
    assert eng.stats()["free_slots"] == 2


def test_slot_engine_is_the_default_layout(models):
    _, tm = models
    eng = LLMEngine(tm, max_slots=3, max_seq_len=24)
    st = eng.stats()
    assert st["kv_layout"] == "slots" and st["free_slots"] == 3
    assert eng._ck.shape == (L, 3, 24, NH, HD)
    assert eng._ck.dtype == tm.wte.dtype and eng._ck.device == tm.device
    assert eng.prefix_peek([1, 2, 3]) == 0
    assert eng.prefix_probe([1, 2, 3]) == (0, 0)
    h = eng.add_request([5, 6, 7, 8, 9], max_new_tokens=6)
    assert list(h) == h.tokens and len(h.tokens) == 6
    assert h.output_ids().tolist() == [5, 6, 7, 8, 9] + h.tokens
    eng.release_kv()
    assert eng._ck is None and eng._cv is None
