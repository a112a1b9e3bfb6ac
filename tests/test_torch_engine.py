"""The PyTorch port's paged ``LLMEngine`` against the JAX package.

Greedy tokens of ``LLMEngine(model, kv_layout="paged")`` must be
identical between the two packages on shared weights, request for
request, with prefix hits and a copy-on-write adoption on the way, and
equal to JAX ``GPT.generate``.  The weights use ``initializer_range=0.3``:
at the default 0.02 the tiny model repeats one token and a token test
would prove little.

The JAX paged engine has a fault the port must not copy: when a prompt's
last prefill chunk is padded past ``max_seq_len`` (``paged.py:1034``),
``_embed``'s ``dynamic_slice_in_dim`` (``gpt.py:556``) clamps the window
start and shifts the position of every token in the chunk.  The port
gathers ``wpe`` per token; its test pins both behaviours.

Sampling is held by distribution (the two packages' random streams
differ), never token by token across packages.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.resilience import faultinject as jfi
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving.sampling import filter_logits as jfilter
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.resilience import faultinject as tfi
from paddle_tpu_torch.serving.sampling import filter_logits, sample_tokens

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3)
ENGINE = dict(kv_layout="paged", max_slots=3, max_seq_len=32, block_size=4,
              prefill_chunk=8, min_bucket=8)
COMPARED = ("serving.kv.prefix_hits", "serving.kv.prefix_hit_tokens",
            "serving.kv.cow_copies", "serving.kv.prefill_chunks",
            "serving.decode_steps", "serving.decode_tokens")


def _pair(seed, **over):
    cfg = dict(CFG, **over)
    paddle.seed(seed)
    jm = JGPT(JConfig(use_flash_attention=False, **cfg))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_numpy_state({k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(21)


def _serve(eng, counters, specs):
    before = counters.snapshot()
    handles = [eng.add_request(p, **kw) for p, kw in specs]
    steps = 0
    while not all(h.is_finished for h in handles):
        eng.step()
        steps += 1
        assert steps < 300, "engine did not converge"
    moved = counters.delta(before)
    return handles, {k: moved.get(k, 0) for k in COMPARED}


def _generate(jm, prompt, n):
    out = jm.generate(paddle.to_tensor(np.asarray([prompt], np.int32)),
                      max_new_tokens=n)
    return np.asarray(out.numpy())[0, len(prompt):].tolist()


def test_greedy_tokens_match_jax_engine_and_generate(models):
    jm, tm = models
    rng = np.random.default_rng(0)
    rand = lambda n: rng.integers(0, 64, n).tolist()  # noqa: E731
    system = rand(9)
    p0 = rand(10)
    specs = [
        (p0, dict(max_new_tokens=1)),      # donates p0, tail block partial
        (system + rand(3), dict(max_new_tokens=6)),
        (rand(5), dict(max_new_tokens=7)),
        (rand(13), dict(max_new_tokens=5)),
        (p0 + rand(5), dict(max_new_tokens=6)),   # full hits + COW of p0
        (system + rand(6), dict(max_new_tokens=6)),
        (rand(2), dict(max_new_tokens=8)),
        (system + rand(2), dict(max_new_tokens=4)),
    ]
    # request 2 stops on an eos that greedy decoding reaches at step <= 4
    gen2 = _generate(jm, specs[2][0], 7)
    specs[2][1]["eos_token_id"] = gen2[3]

    th, tmoved = _serve(LLMEngine(tm, **ENGINE), tcounters, specs)
    jh, jmoved = _serve(JEngine(jm, **ENGINE), jcounters, specs)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert [h.finish_reason for h in th] == [h.finish_reason for h in jh]
    assert th[2].finish_reason == "eos" and th[2].tokens[-1] == gen2[3]
    assert {h.finish_reason for h in th} == {"eos", "length"}
    assert tmoved == jmoved
    assert tmoved["serving.kv.prefix_hits"] > 0
    assert tmoved["serving.kv.cow_copies"] > 0
    assert len({t for h in th for t in h.tokens}) >= 5   # tokens vary

    # and equal to JAX generate, request by request (generate keeps
    # emitting eos after it; the engine stops there)
    for i in (1, 2, 4, 5):
        n = specs[i][1]["max_new_tokens"]
        want = gen2 if i == 2 else _generate(jm, specs[i][0], n)
        assert th[i].tokens == want[:len(th[i].tokens)]


def test_last_chunk_past_max_seq_len():
    """A 33-token prompt with ``prefill_chunk=16`` prefills its last
    token in an 8-token bucket at positions [32, 40), past the 36-row
    position table: the port matches ``generate`` there, the JAX paged
    engine does not (its reference fault, pinned here)."""
    jm, tm = _pair(3, max_seq_len=36)
    prompt = np.random.default_rng(1).integers(0, 64, 33).tolist()
    kw = dict(kv_layout="paged", max_slots=1, max_seq_len=36, block_size=4,
              prefill_chunk=16, min_bucket=8)
    spec = [(prompt, dict(max_new_tokens=3))]
    want = _generate(jm, prompt, 3)
    (th,), _ = _serve(LLMEngine(tm, **kw), tcounters, spec)
    (jh,), _ = _serve(JEngine(jm, **kw), jcounters, spec)
    assert th.tokens == want
    assert jh.tokens != want


def test_prefix_peek_and_probe(models):
    _, tm = models
    eng = LLMEngine(tm, **ENGINE)
    prompt = list(range(1, 11))
    assert eng.prefix_peek(prompt) == 0
    eng.generate([prompt], max_new_tokens=2)
    # donated: prompt + 1 generated token = 11 tokens; a re-sent prompt
    # can reuse all but its last token
    assert eng.prefix_peek(prompt) == 9
    assert eng.prefix_probe(prompt) == (9, 0)


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7), dict(top_k=5), dict(top_p=0.8),
    dict(temperature=1.3, top_k=9, top_p=0.9), dict(top_k=64)])
def test_filter_logits_matches_jax(knobs):
    lg = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    want = np.asarray(jfilter(jnp.asarray(lg), **knobs))
    got = filter_logits(torch.from_numpy(lg), **knobs).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_seeded_request_repeats_itself(models):
    _, tm = models
    eng = LLMEngine(tm, **ENGINE)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.2, top_k=20)
    a = eng.add_request([3, 1, 4, 1, 5], seed=7, **kw)
    b = eng.add_request([3, 1, 4, 1, 5], seed=7, **kw)
    c = eng.add_request([3, 1, 4, 1, 5], seed=8, **kw)
    while not all(h.is_finished for h in (a, b, c)):
        eng.step()
    assert a.tokens == b.tokens
    assert len(c.tokens) == 8


def test_sample_tokens_follow_filtered_softmax():
    """Chi-squared goodness of fit of ``sample_tokens`` draws against
    the softmax of the filtered logits; masked tokens are never drawn."""
    V, n = 16, 6000
    lg = torch.from_numpy(
        np.random.default_rng(3).standard_normal((1, V)).astype(np.float32))
    knobs = dict(temperature=0.9, top_k=10, top_p=0.95)
    probs = torch.softmax(filter_logits(lg, **knobs), -1)[0].numpy()
    gen = torch.Generator().manual_seed(0)
    draws = sample_tokens(lg.expand(n, V), gen, do_sample=True, **knobs)
    counts = np.bincount(draws.numpy(), minlength=V)
    assert counts[probs == 0].sum() == 0
    live = probs > 0
    expected = n * probs[live]
    stat = float((((counts[live] - expected) ** 2) / expected).sum())
    df = int(live.sum()) - 1
    # p=0.001 critical value for df<=63 is < df + 3.1*sqrt(2*df) + 12
    assert stat < df + 3.1 * np.sqrt(2 * df) + 12, (stat, df)


#: what the engine reads of a mesh before it refuses a knob: its size
#: and its axes (serving over a mesh with sep > 1 is a later slice)
_TWO_RANKS = types.SimpleNamespace(size=2, shape={"mp": 1, "sep": 2})


@pytest.mark.parametrize("knob", [
    dict(mesh=_TWO_RANKS, adapter_slots=2),
    dict(mesh=_TWO_RANKS, host_kv_blocks=8),
    dict(mesh=_TWO_RANKS, draft_model="target")])
def test_later_slices_raise_not_implemented(models, knob):
    """On a mesh with sep > 1, the adapter and host-tier knobs and a
    draft model (the speculative engine) raise naming their ROADMAP item
    (A7c: serving over sep; on an ``mp`` mesh they serve,
    ``tests/test_torch_mesh_serving_extras.py``); without the mesh the
    first two construct."""
    _, tm = models
    kw = dict(ENGINE, **knob)
    if kw.get("draft_model") == "target":
        kw["draft_model"] = tm          # self-drafted
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7c"):
        LLMEngine(tm, **kw)
    del kw["mesh"]
    kw.pop("draft_model", None)
    st = LLMEngine(tm, **kw).stats()
    assert (st["adapter_slots"], st["host_tier_capacity"]) == (
        knob.get("adapter_slots", 0), knob.get("host_kv_blocks", 0))


@pytest.mark.parametrize("knob", [
    dict(kv_dtype="int8"), dict(kv_dtype="fp8"), dict(weight_dtype="int8"),
    dict(kv_dtype="int8", weight_dtype="int8")])
def test_quant_knobs_construct(models, knob):
    _, tm = models
    st = LLMEngine(tm, **dict(ENGINE, **knob)).stats()
    assert (st["kv_dtype"], st["weight_dtype"]) == (
        knob.get("kv_dtype"), knob.get("weight_dtype"))


@pytest.mark.parametrize("knob,match", [
    (dict(kv_dtype="int4"), "kv_dtype"),
    (dict(weight_dtype="fp4"), "weight_dtype"),
    (dict(kv_dtype="int8", kv_layout="slots"), "kv_layout='paged'")])
def test_quant_knobs_validate(models, knob, match):
    _, tm = models
    with pytest.raises(ValueError, match=match):
        LLMEngine(tm, **dict(ENGINE, **knob))


def test_pool_exhaustion_and_eviction_match_jax(models):
    """A pool too small for three long requests at once: admission waits
    for blocks (``serving.kv.pool_exhausted``) and reclaims prefix-tree
    blocks (``serving.kv.blocks_evicted``) exactly as the JAX engine."""
    jm, tm = models
    rng = np.random.default_rng(4)
    specs = [(rng.integers(0, 64, n).tolist(), dict(max_new_tokens=6))
             for n in (14, 13, 10, 14, 9, 12)]
    kw = dict(ENGINE, n_blocks=13)
    moved = {}
    for name, eng, ctr in (("torch", LLMEngine(tm, **kw), tcounters),
                           ("jax", JEngine(jm, **kw), jcounters)):
        before = ctr.snapshot()
        handles, _ = _serve(eng, ctr, specs)
        d = ctr.delta(before)
        moved[name] = ([h.tokens for h in handles],
                       [d.get(k, 0) for k in (
                           "serving.kv.pool_exhausted",
                           "serving.kv.blocks_evicted",
                           "serving.kv.prefill_chunks")])
        assert eng.stats()["blocks_used"] <= 12
    assert moved["torch"] == moved["jax"]
    exhausted, evicted, _ = moved["torch"][1]
    assert exhausted > 0 and evicted > 0


def test_cancel_deadline_backpressure_and_drain(models):
    from paddle_tpu_torch.serving import EngineBackpressure, EngineClosed
    _, tm = models
    eng = LLMEngine(tm, queue_size=2, **ENGINE)
    a = eng.add_request([1, 2, 3], max_new_tokens=4)
    b = eng.add_request([4, 5, 6], max_new_tokens=4, deadline_s=0.0)
    with pytest.raises(EngineBackpressure) as ei:
        eng.add_request([7], max_new_tokens=2, block=False)
    assert ei.value.queue_depth == 2
    a.cancel()
    eng.step()
    assert (a.finish_reason, b.finish_reason) == ("cancelled", "deadline")
    c = eng.add_request([7, 8], max_new_tokens=3)
    d = eng.add_request([9], max_new_tokens=5)
    done = eng.drain()
    assert {r.rid for r in done} >= {c.rid, d.rid}
    assert [len(c.tokens), len(d.tokens)] == [3, 5]
    with pytest.raises(EngineClosed):
        eng.add_request([1], max_new_tokens=1)
    st = eng.stats()
    assert st["active"] == st["queued"] == st["outstanding_tokens"] == 0
    assert st["blocks_used"] == st["prefix_nodes"] > 0   # donated to tree


def test_streaming_iterates_tokens(models):
    _, tm = models
    eng = LLMEngine(tm, **ENGINE)
    h = eng.add_request([5, 6, 7, 8, 9], max_new_tokens=6)
    assert list(h) == h.tokens and len(h.tokens) == 6
    assert h.output_ids().tolist() == [5, 6, 7, 8, 9] + h.tokens


@pytest.mark.parametrize("site", ["kv_pool_exhausted", "serving_prefill"])
def test_injected_faults_match_jax(models, site):
    """The engine's fault sites fire as in the JAX package:
    ``kv_pool_exhausted`` at a request's admission defers it (nothing
    allocated) and it later finishes with the same tokens;
    ``serving_prefill`` finishes that request alone with
    ``finish_reason="error"``.  Tokens, reasons and counters equal."""
    jm, tm = models
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 64, n).tolist() for n in (9, 6, 11)]
    out = []
    for Eng, m, ctr, fi in ((LLMEngine, tm, tcounters, tfi),
                            (JEngine, jm, jcounters, jfi)):
        eng = Eng(m, **ENGINE)
        before = ctr.snapshot()
        handles = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        victim = handles[1].rid
        with fi.fault_schedule(f"{site}@{victim}"):
            while not all(h.is_finished for h in handles):
                eng.step()
            fired = list(fi.fired)
        d = ctr.delta(before)
        out.append(([h.tokens for h in handles],
                    [h.finish_reason for h in handles], fired,
                    {k: d.get(k, 0) for k in (
                        "serving.kv.pool_exhausted", "serving.request_errors",
                        "resilience.faults_injected",
                        f"resilience.faults_injected.{site}")}))
    assert out[0] == out[1]
    reasons = out[0][1]
    assert reasons == (["length", "error", "length"]
                       if site == "serving_prefill" else ["length"] * 3)
    assert out[0][3][f"resilience.faults_injected.{site}"] == 1
