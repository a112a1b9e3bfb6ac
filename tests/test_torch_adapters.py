"""Multi-tenant LoRA serving in the PyTorch port against the JAX package.

Both packages serve the same 2-layer model (hidden 32, fp32, weights
carried by ``load_numpy_state``) with the same factors
(``random_lora_factors``, equal ``RandomState`` draws in both):

* base rows are bitwise the adapter-free engine's, in the model
  (``torch.equal``) and token for token in a mixed batch;
* tenant logits are within ``TOL`` (atol and rtol 1e-4: two fp32
  implementations summing in different orders) of the JAX package's, and
  greedy tenant tokens equal JAX's, request for request;
* the arena's bookkeeping (slots, loads, hits, misses, evictions,
  exhaustion, ``adapter_load_drop``) moves exactly as JAX's on the same
  stream;
* in bf16 the port's adapted logits are held to JAX's within twice JAX's
  own distance from its fp32 run plus ``TOL`` at the case's scale.
"""

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
from paddle_tpu.serving import adapters as jad
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.resilience import faultinject as tfi
from paddle_tpu_torch.serving import adapters as tad

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3)
ENGINE = dict(kv_layout="paged", max_slots=3, max_seq_len=32, min_bucket=4,
              block_size=4, prefill_chunk=8)
ADAPTER_COUNTERS = ("serving.adapter.loads", "serving.adapter.hits",
                    "serving.adapter.misses", "serving.adapter.evictions",
                    "serving.adapter.arena_exhausted",
                    "serving.adapter.load_drops", "serving.kv.prefix_hits",
                    "serving.kv.prefix_misses", "serving.kv.prefill_chunks",
                    "serving.decode_steps")


def _weights(seed, round_bf16=False):
    paddle.seed(seed)
    jm = JGPT(JConfig(use_flash_attention=False, **CFG))
    w = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    if round_bf16:
        w = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
             for k, v in w.items()}
    return w


def _pair(w, dtype="float32"):
    jm = JGPT(JConfig(use_flash_attention=False, dtype=dtype, **CFG))
    jm.set_state_dict(w)
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(dtype=dtype, **CFG), device="cpu")
    tm.load_numpy_state(w)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(_weights(31))


def _factors(seed, rank=3):
    # scale 1.0 so every tenant flips the tiny model's greedy argmax
    return tad.random_lora_factors(GPTConfig(**CFG), rank, seed=seed,
                                   scale=1.0)


def _engines(models, tenants=("t1", "t2", "t3"), **kw):
    """(port engine, JAX engine) with the same adapter knobs and the
    tenants registered from the same factors."""
    jm, tm = models
    kw = dict(ENGINE, **kw)
    te, je = LLMEngine(tm, **kw), JEngine(jm, **kw)
    for i, t in enumerate(tenants):
        f = _factors(i + 1)
        te.register_adapter(t, f)
        je.register_adapter(t, f)
    return te, je


def _run(eng, handles, limit=400):
    n = 0
    while not all(h.is_finished for h in handles):
        eng.step()
        n += 1
        assert n < limit, "engine did not converge"
    return [list(map(int, h.tokens)) for h in handles]


def _serve_both(te, je, specs):
    """The same ``(prompt, kwargs)`` stream through both engines: the
    tokens and counter moves of each."""
    out = []
    for eng, ctr in ((te, tcounters), (je, jcounters)):
        before = ctr.snapshot()
        toks = _run(eng, [eng.add_request(p, **kw) for p, kw in specs])
        d = ctr.delta(before)
        out.append((toks, {k: d.get(k, 0) for k in ADAPTER_COUNTERS}))
    return out


def _reconciles(eng):
    st = eng.adapters.stats()
    return (all(r == 0 for r in st["tenants"].values())
            and st["resident"] <= st["slots"])


# -- validation and factors ---------------------------------------------------
def test_adapter_slots_requires_paged_layout(models):
    _, tm = models
    with pytest.raises(ValueError, match="adapter_slots"):
        LLMEngine(tm, kv_layout="slots", max_slots=2, max_seq_len=32,
                  adapter_slots=2)


def test_adapter_request_on_adapter_free_engine_refused(models):
    _, tm = models
    eng = LLMEngine(tm, **ENGINE)
    with pytest.raises(ValueError, match="adapter"):
        eng.add_request([1, 2, 3], max_new_tokens=2, adapter="t1")
    with pytest.raises(ValueError, match="adapter_slots=0"):
        eng.register_adapter("t1", _factors(1))


def test_unregistered_tenant_refused_at_add_request(models):
    _, tm = models
    eng = LLMEngine(tm, **dict(ENGINE, adapter_slots=2, adapter_rank=4))
    with pytest.raises(KeyError):
        eng.add_request([1, 2, 3], max_new_tokens=2, adapter="ghost")


@pytest.mark.parametrize("bad,match", [
    (dict(rank=8), "expects"),
    (dict(extra=True), "unknown factor keys"),
    (dict(half=True), "needs both")])
def test_bad_factors_refused(models, bad, match):
    _, tm = models
    eng = LLMEngine(tm, **dict(ENGINE, adapter_slots=2, adapter_rank=4))
    f = _factors(1, rank=bad.get("rank", 3))
    if bad.get("extra"):
        f["a_lm_head"] = f["a_qkv_w"]
    if bad.get("half"):
        del f["b_fc1_w"]
    with pytest.raises(ValueError, match=match):
        eng.register_adapter("fat", f)
    with pytest.raises(ValueError, match="base model"):
        eng.register_adapter(None, _factors(1))


def test_random_factors_equal_jax_and_cover_all_projections():
    c = GPTConfig(**CFG)
    got = tad.random_lora_factors(c, 3, seed=5, scale=0.5)
    want = jad.random_lora_factors(JConfig(**CFG), 3, seed=5, scale=0.5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    H, F, L = c.hidden_size, c.ffn_hidden_size, c.num_layers
    assert got["a_qkv_w"].shape == (L, H, 3)
    assert got["b_qkv_w"].shape == (L, 3, 3 * H)
    assert got["b_proj_w"].shape == (L, 3, H)
    assert got["b_fc1_w"].shape == (L, 3, F)
    assert got["a_fc2_w"].shape == (L, F, 3)


# -- the model: base passthrough and tenant rows ------------------------------
def _slabs(arena_slot, rank=4, seed=1):
    """fp32 numpy slabs with tenant ``seed``'s factors in row
    ``arena_slot`` (rank padded from 3 to ``rank``), zeros elsewhere."""
    c = GPTConfig(**CFG)
    dims = tad._target_dims(c)
    f = _factors(seed)
    out = {}
    for t in tad.ADAPTER_TARGETS:
        di, do = dims[t]
        a = np.zeros((c.num_layers, 3, di, rank), np.float32)
        b = np.zeros((c.num_layers, 3, rank, do), np.float32)
        a[:, arena_slot, :, :3] = f["a_" + t]
        b[:, arena_slot, :3, :] = f["b_" + t]
        out["a_" + t], out["b_" + t] = a, b
    return out


def _model_step(m, w, step, pools, aids, slabs, torch_side):
    """One prefill chunk (3 rows stacked as 3 calls) or one decode step of
    3 rows over zero pools; returns fp32 numpy logits."""
    conv = (torch.from_numpy if torch_side else jnp.asarray)
    ad = None if slabs is None else {k: conv(v) for k, v in slabs.items()}
    if step == "decode":
        tok = np.array([5, 9, 2], np.int32)
        pos = np.array([3, 7, 1], np.int32)
        bt = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 0, 0, 0]], np.int32)
        args = [conv(a) for a in (tok, pos, bt)]
        kw = {} if ad is None else dict(adapters=ad,
                                        adapter_ids=conv(aids))
        out = m.decode_paged(w, *args, *pools, **kw)
        lg = out if torch_side else out[0]
        return np.asarray(lg.float().numpy() if torch_side else lg,
                          np.float32)
    ids = np.zeros((1, 8), np.int32)
    ids[0, :5] = [1, 2, 3, 4, 5]
    bt = np.array([1, 2, 0, 0], np.int32)
    rows = []
    for a in aids:
        kw = {} if ad is None else dict(
            adapters=ad, adapter_ids=conv(np.array([a], np.int32)))
        if torch_side:
            lg = m.prefill_paged(w, torch.from_numpy(ids.astype(np.int64)),
                                 0, 5, torch.from_numpy(bt), *pools, **kw)
            rows.append(lg.float().numpy()[0])
        else:
            lg = m.prefill_paged(w, jnp.asarray(ids), np.int32(0),
                                 np.int32(5), jnp.asarray(bt), *pools,
                                 **kw)[-1]
            rows.append(np.asarray(lg, np.float32)[0])
    return np.stack(rows)


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_base_rows_bitwise_and_tenant_rows_match_jax(models, step):
    """Row 0 of the slab is the base model: ``adapter_ids == 0`` rows are
    the adapter-free logits THEMSELVES (``torch.equal``), tenant rows
    differ from them and agree with the JAX package within ``TOL``."""
    jm, tm = models
    aids = np.array([0, 2, 0], np.int32)
    slabs = _slabs(2)
    shape = (2, 6, 4, 4, 8)

    def tpools():
        return [torch.zeros(shape) for _ in "kv"]

    plain = _model_step(tm, tm.decode_state(), step, tpools(), aids, None,
                        True)
    mixed = _model_step(tm, tm.decode_state(), step, tpools(), aids, slabs,
                        True)
    jpools = [jnp.zeros(shape, jnp.float32) for _ in "kv"]
    jmixed = _model_step(jm, jm.decode_state(), step, jpools, aids, slabs,
                         False)
    base = aids == 0
    assert np.array_equal(mixed[base], plain[base])       # bits, not close
    assert np.abs(mixed[~base] - plain[~base]).max() > 1e-2
    np.testing.assert_allclose(mixed, jmixed, **TOL)


def test_bf16_adapted_decode_within_fp32_distance():
    """bf16: the port's adapted decode logits are held to the JAX
    package's within twice JAX's own distance from its fp32 run plus
    ``TOL`` at the case's scale (the port's own bf16 error does not widen
    the bound); the greedy tokens agree.  Weights and factors are
    bf16-exact, so both precisions start from the same values."""
    w = _weights(32, round_bf16=True)
    aids = np.array([1, 2, 0], np.int32)
    slabs = {k: np.asarray(jnp.asarray(v + _slabs(2, seed=4)[k],
                                       jnp.bfloat16).astype(jnp.float32))
             for k, v in _slabs(1, seed=3).items()}
    step = [np.array([5, 9, 2], np.int32), np.array([3, 7, 1], np.int32),
            np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 0, 0, 0]], np.int32)]
    shape = (2, 6, 4, 4, 8)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        jm, tm = _pair(w, dtype)
        tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        tl = tm.decode_paged(
            tm.decode_state(), *(torch.from_numpy(a) for a in step),
            *[torch.zeros(shape, dtype=tdt) for _ in "kv"],
            adapters={k: torch.from_numpy(np.array(v)).to(tdt)
                      for k, v in slabs.items()},
            adapter_ids=torch.from_numpy(aids))
        jl = jm.decode_paged(
            jm.decode_state(), *(jnp.asarray(a) for a in step),
            *[jnp.zeros(shape, dtype) for _ in "kv"],
            adapters={k: jnp.asarray(v, dtype) for k, v in slabs.items()},
            adapter_ids=jnp.asarray(aids))[0]
        runs[dtype] = (tl.float().numpy(),
                       np.asarray(jnp.asarray(jl, jnp.float32)))
    jf = runs["float32"][1]
    tb, jb = runs["bfloat16"]
    noise = np.abs(jb - jf).max()
    tol = 2 * noise + TOL["atol"] + TOL["rtol"] * np.abs(jf).max()
    assert 0 < noise and np.abs(tb - jb).max() <= tol
    np.testing.assert_allclose(runs["float32"][0], jf, **TOL)
    np.testing.assert_array_equal(tb.argmax(-1), jb.argmax(-1))


# -- the engine ---------------------------------------------------------------
def test_mixed_tenant_batch_matches_jax_and_base_engine(models):
    """Three tenants and a base row decoding in one batch: every row's
    greedy tokens equal the JAX engine's, the base row equals the
    adapter-free engine's, tenants diverge, and the arena counters move
    as JAX's."""
    te, je = _engines(models, max_slots=4, adapter_slots=3, adapter_rank=4)
    prompt = [1, 2, 3, 4, 5]
    specs = [(prompt, dict(max_new_tokens=6))] + [
        (prompt, dict(max_new_tokens=6, adapter=t)) for t in
        ("t1", "t2", "t3")]
    (tt, tc), (jt, jc) = _serve_both(te, je, specs)
    assert tt == jt and tc == jc
    assert tc["serving.adapter.loads"] == 3
    assert len({tuple(t) for t in tt}) == 4
    assert _reconciles(te)
    _, tm = models
    base = LLMEngine(tm, **ENGINE)
    assert _run(base, [base.add_request(prompt, max_new_tokens=6)]) == \
        [tt[0]]


def test_prefix_cache_never_leaks_kv_across_tenants(models):
    """The same prompt tenant after tenant on one engine: each tenant's
    donated prefix lives in its own key plane (no cross-tenant hit), a
    same-tenant rerun hits warm, and tokens and counters equal JAX's."""
    te, je = _engines(models, tenants=("t1", "t2"), adapter_slots=2,
                      adapter_rank=4)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    out = {}
    for name, eng, ctr in (("torch", te, tcounters), ("jax", je, jcounters)):
        before = ctr.snapshot()
        toks = [_run(eng, [eng.add_request(prompt, max_new_tokens=5,
                                           adapter=t)])[0]
                for t in ("t1", "t2", "t1", None)]
        d = ctr.delta(before)
        out[name] = (toks, d.get("serving.kv.prefix_hits", 0),
                     d.get("serving.kv.prefix_misses", 0),
                     eng.prefix_peek(prompt, tenant="t2"),
                     eng.prefix_peek(prompt), eng.adapter_peek("t1"))
    assert out["torch"] == out["jax"]
    toks, hits, misses, *_ = out["torch"]
    assert toks[2] == toks[0] and toks[0] != toks[1]
    assert (hits, misses) == (1, 3)
    # two tenants' identical prompts share no block
    salted = [te._prefix_key(prompt, t) for t in ("t1", "t2")]
    assert not set(salted[0]) & set(salted[1])
    assert all(isinstance(t, int) and t >= 2 ** 32 for t in salted[0])


def _arena_script(ad):
    log = []
    s1, s2 = ad.acquire("t1"), ad.acquire("t2")
    log.append((s1, s2))
    try:
        ad.acquire("t3")
    except (tad.AdapterArenaExhausted, jad.AdapterArenaExhausted) as e:
        log.append(("exhausted", e.needed, e.free))
    ad.release("t1")
    log.append(("t3", ad.acquire("t3")))
    log.append(("t2 warm", ad.acquire("t2")))
    log.append(dict(ad.stats()["tenants"]))
    ad.release("t2")
    ad.release("t2")
    ad.release("t3")
    try:
        ad.release("t2")
    except ValueError:
        log.append("underflow")
    ad.acquire("t1")
    try:
        ad.register("t1", _factors(7))
    except ValueError:
        log.append("pinned")
    ad.release("t1")
    ad.register("t1", _factors(7))
    log.append(ad.peek("t1"))
    log.append({k: v for k, v in ad.stats().items() if k != "arena_bytes"})
    return log


def test_arena_accounting_matches_jax(models):
    """LRU eviction takes only refcount-0 slots, warm re-acquires hit,
    refcount underflow and re-registering a pinned tenant are refused:
    the same script gives the same slots and stats in both packages."""
    te, je = _engines(models, adapter_slots=2, adapter_rank=4)
    got = _arena_script(te.adapters)
    assert got == _arena_script(je.adapters)
    assert got[2] == ("t3", got[0][0])       # t3 took t1's slot
    # the slabs hold the factors, rank-padded, in each tenant's row
    f = _factors(2)
    slot = te.adapters._resident["t2"]
    sl = te.adapters.slabs()
    np.testing.assert_array_equal(sl["a_fc2_w"][:, slot, :, :3].numpy(),
                                  f["a_fc2_w"])
    assert not sl["a_fc2_w"][:, slot, :, 3:].any()
    assert not sl["b_qkv_w"][:, 0].any()      # row 0: the base model


def test_refcounts_reconcile_after_churn_as_in_jax(models):
    te, je = _engines(models, adapter_slots=2, adapter_rank=4)
    rng = np.random.default_rng(5)
    tenants = [None, "t1", "t2", "t3", "t1", None, "t3", "t2"]
    specs = [(rng.integers(0, 64, size=4).tolist(),
              dict(max_new_tokens=3, adapter=t)) for t in tenants]
    (tt, tc), (jt, jc) = _serve_both(te, je, specs)
    assert tt == jt and tc == jc
    assert tc["serving.adapter.evictions"] >= 1
    assert _reconciles(te) and te.adapters.stats()["loads"] >= 3


def test_arena_exhaustion_defers_like_kv_exhaustion(models):
    """Two tenants through a one-slot arena: the second request waits at
    the queue head with nothing allocated and admits once the first
    finishes, as in JAX, with the same tokens."""
    te, je = _engines(models, tenants=("t1", "t2"), max_slots=2,
                      adapter_slots=1, adapter_rank=4)
    specs = [([1, 2, 3, 4], dict(max_new_tokens=5, adapter=t))
             for t in ("t1", "t2")]
    (tt, tc), (jt, jc) = _serve_both(te, je, specs)
    assert tt == jt and tc == jc
    assert tc["serving.adapter.arena_exhausted"] >= 1
    assert tc["serving.adapter.evictions"] >= 1
    assert _reconciles(te)


def test_injected_load_drop_defers_and_matches_jax(models):
    """``adapter_load_drop`` at one admission: the slot goes back before
    any slab write, the request defers and retries to the same tokens;
    both packages fire it once and count it once."""
    out = []
    for eng, fi, ctr in ((_engines(models, tenants=("t1",), adapter_slots=2,
                                   adapter_rank=4)[0], tfi, tcounters),
                         (_engines(models, tenants=("t1",), adapter_slots=2,
                                   adapter_rank=4)[1], jfi, jcounters)):
        before = ctr.snapshot()
        h0 = eng.add_request([5, 6, 7], max_new_tokens=4, seed=0)
        rid = h0.rid + 1
        with fi.fault_schedule(f"adapter_load_drop@{rid}"):
            h1 = eng.add_request([1, 2, 3, 4], max_new_tokens=4,
                                 adapter="t1")
            toks = _run(eng, [h0, h1])
            fired = ("adapter_load_drop", rid) in fi.fired
        d = ctr.delta(before)
        out.append((toks, fired, d.get("serving.adapter.load_drops", 0),
                    eng.adapters.stats()["load_drops"]))
    assert out[0] == out[1]
    assert out[0][1:] == (True, 1, 1)


def test_int8_weights_compose(models):
    """The LoRA update rides beside the int8 epilogue: base rows equal the
    int8 adapter-free engine's, tenant rows diverge, and every row equals
    the JAX int8 adapter engine's."""
    te, je = _engines(models, tenants=("t1",), adapter_slots=2,
                      adapter_rank=4, weight_dtype="int8")
    prompt = [2, 4, 6, 8, 10]
    specs = [(prompt, dict(max_new_tokens=5)),
             (prompt, dict(max_new_tokens=5, adapter="t1"))]
    (tt, tc), (jt, jc) = _serve_both(te, je, specs)
    assert tt == jt and tc == jc and tt[0] != tt[1]
    _, tm = models
    ref = LLMEngine(tm, **dict(ENGINE, weight_dtype="int8"))
    assert _run(ref, [ref.add_request(prompt, max_new_tokens=5)]) == [tt[0]]


def test_speculative_verify_under_tenant_adapter(models):
    """The draft proposes on the base model, the verify pass scores under
    the row's adapter: greedy tokens equal the non-speculative adapter
    engine's (and so JAX's), for base and tenant rows."""
    jm, tm = models
    draft = GPTForCausalLM(GPTConfig(**dict(CFG, num_layers=1)), device="cpu",
                           generator=torch.Generator().manual_seed(7))
    prompt = [1, 2, 3, 4, 5]
    specs = [(prompt, dict(max_new_tokens=6)),
             (prompt, dict(max_new_tokens=6, adapter="t1"))]
    _, je = _engines(models, tenants=("t1",), adapter_slots=2,
                     adapter_rank=4)
    want = _run(je, [je.add_request(p, **kw) for p, kw in specs])
    spec = LLMEngine(tm, **dict(ENGINE, draft_model=draft, spec_k=3,
                                n_blocks=2 * 3 * 8 + 1, adapter_slots=2,
                                adapter_rank=4))
    spec.register_adapter("t1", _factors(1))
    before = tcounters.snapshot()
    got = _run(spec, [spec.add_request(p, **kw) for p, kw in specs])
    d = tcounters.delta(before)
    assert got == want and want[0] != want[1]
    assert d.get("serving.spec.drafted", 0) > 0
    assert _reconciles(spec)
