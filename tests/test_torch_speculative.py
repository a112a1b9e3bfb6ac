"""Speculative decoding in the PyTorch port: ``verify_paged`` against the
JAX package, ``residual_sample``, the acceptance rule, and
``LLMEngine(model, draft_model=...)``.

* ``verify_paged`` gives the JAX logits and pools in fp32 (``TOL``: atol
  and rtol 1e-4, two fp32 implementations of one 2-layer model that sum
  in different orders), with and without RoPE, and over int8 pools (the
  pools held to one int8 step of the token's scale: both sides quantize
  the same values up to fp32 rounding).  Its column 0 is
  ``decode_paged``'s logits for the same rows.  In bf16 the port is held
  to the JAX package within twice the JAX package's own distance from
  its fp32 run plus ``TOL`` at the case's scale (measured: at most 1.18
  times that distance), with equal greedy tokens.
* Greedy speculative tokens equal the port's paged engine's and JAX
  ``generate``'s for every ``spec_k`` in 1..4, whatever the draft: the
  target (2 layers) and the draft (1 layer, other weights) disagree, so
  rejections and rollbacks happen.
* Sampled output is chi-squared-compatible with the paged engine's over
  the same seeds (modified rejection sampling keeps the target's
  distribution; the streams differ, so tokens are not compared).
* Block accounting: no leak after rejections, draft blocks never in the
  prefix tree, draft starvation degrades to plain decode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.profiler import counters
from paddle_tpu_torch.serving import SpeculativeLLMEngine
from paddle_tpu_torch.serving.kvcache import blocks_for_tokens
from paddle_tpu_torch.serving.sampling import residual_sample
from paddle_tpu_torch.serving.speculative import _acceptance

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3)
L, NH, HD = 2, 4, 8
BS, N_BLOCKS, MAX_BLOCKS = 4, 12, 6


def _weights(seed, use_rope, round_bf16=False, **over):
    paddle.seed(seed)
    jm = JGPT(JConfig(use_flash_attention=False, use_rope=use_rope,
                      **dict(CFG, **over)))
    w = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    if round_bf16:
        w = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
             for k, v in w.items()}
    return w


def _pair(w, use_rope=False, dtype="float32", **over):
    cfg = dict(CFG, **over)
    jm = JGPT(JConfig(use_flash_attention=False, use_rope=use_rope,
                      dtype=dtype, **cfg))
    jm.set_state_dict(w)
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(use_rope=use_rope, dtype=dtype, **cfg),
                        device="cpu")
    tm.load_numpy_state(w)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, port draft): the draft has one layer and
    weights of its own."""
    jm, tm = _pair(_weights(31, False))
    draft = GPTForCausalLM(GPTConfig(**dict(CFG, num_layers=1)), device="cpu",
                           generator=torch.Generator().manual_seed(7))
    return jm, tm, draft


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _verify_case(jm, tm, dtype, kv_dtype=None, seed=0):
    """One verify over three rows: K1 = 4 positions, n_valid 4 / 2 / 1
    (row 2 idle on the trash block), pools holding unit-normal K/V (or
    their int8 quantization).  Returns ``{name: (port, jax)}`` in fp32
    numpy, and the port's inputs."""
    rng = np.random.default_rng(seed)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    shape = (L, N_BLOCKS, BS, NH, HD)
    raw = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    if kv_dtype:
        tpools = [t for x in raw for t in pa.quantize_kv(torch.from_numpy(x),
                                                         kv_dtype)]
        tpools = [tpools[0], tpools[2], tpools[1], tpools[3]]   # k, v, sk, sv
        jpools = [jnp.asarray(t.numpy()) for t in tpools]
    else:
        tpools = [torch.from_numpy(x).to(tdt) for x in raw]
        jpools = [jnp.asarray(x, dtype) for x in raw]
    toks = rng.integers(0, 64, (3, 4)).astype(np.int32)
    pos0 = np.array([5, 10, 0], np.int32)
    nv = np.array([4, 2, 1], np.int32)
    bt = np.zeros((3, MAX_BLOCKS), np.int32)
    bt[0, :3] = [3, 7, 1]
    bt[1, :3] = [2, 5, 9]
    targs = [torch.from_numpy(a) for a in (toks, pos0, nv, bt)]
    jout = jm.verify_paged(jm.decode_state(), *(jnp.asarray(a) for a in
                                                (toks, pos0, nv, bt)),
                           *jpools)
    tl = tm.verify_paged(tm.decode_state(), *targs, *tpools)
    names = ["logits", "pool_k", "pool_v", "scale_k", "scale_v"]
    out = {n: (_f32(t), _f32(j)) for n, t, j in
           zip(names, (tl, *tpools), jout)}
    return out, targs, tpools


@pytest.mark.parametrize("use_rope", [False, True])
def test_verify_paged_matches_jax_and_decode_paged(use_rope):
    jm, tm = _pair(_weights(5, use_rope), use_rope)
    out, (toks, pos0, nv, bt), pools = _verify_case(jm, tm, "float32",
                                                    seed=use_rope)
    for name, (got, want) in out.items():
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    # column 0 is a decode step of the committed tokens over the same
    # rows, once the verify pass has written their K/V
    dl = tm.decode_paged(tm.decode_state(), toks[:, 0], pos0, bt,
                         *[p.clone() for p in pools])
    np.testing.assert_allclose(dl.numpy(), out["logits"][0][:, 0], **TOL)


def test_verify_paged_int8_pools_match_jax():
    jm, tm = _pair(_weights(9, False))
    out, _, _ = _verify_case(jm, tm, "float32", kv_dtype="int8", seed=2)
    np.testing.assert_allclose(*out["logits"], **TOL)
    # int8 tiles: one step of the token's scale apart at a rounding
    # boundary; the values they stand for within one step of the largest
    for p, s in (("pool_k", "scale_k"), ("pool_v", "scale_v")):
        np.testing.assert_allclose(*out[s], rtol=1e-5, atol=0)
        got = out[p][0] * out[s][0][..., None, None]
        want = out[p][1] * out[s][1][..., None, None]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1.001 * out[s][1].max())


def test_verify_paged_bf16_within_fp32_distance():
    w = _weights(6, True, round_bf16=True)
    runs = {}
    for d in ("float32", "bfloat16"):
        runs[d], _, _ = _verify_case(*_pair(w, True, d), d, seed=4)
    for name, (tb, jb) in runs["bfloat16"].items():
        jf = runs["float32"][name][1]
        noise = np.abs(jb - jf).max()
        tol = 2 * noise + TOL["atol"] + TOL["rtol"] * np.abs(jf).max()
        assert 0 < noise and np.abs(tb - jb).max() <= tol, name
    tb, jb = runs["bfloat16"]["logits"]
    np.testing.assert_array_equal(tb.argmax(-1), jb.argmax(-1))


def test_verify_paged_adapters_not_ported(models):
    """``verify_paged(adapters=...)``: rows on adapter slot 0 are the
    adapter-free logits bit for bit, and a tenant row's logits match the
    JAX package's ``verify_paged`` under the same slabs within ``TOL``."""
    jm, tm, _ = models
    rng = np.random.default_rng(3)
    H, F = CFG["hidden_size"], 4 * CFG["hidden_size"]
    dims = {"qkv_w": (H, 3 * H), "proj_w": (H, H), "fc1_w": (H, F),
            "fc2_w": (F, H)}
    slabs = {}
    for t, (di, do) in dims.items():
        slabs["a_" + t] = rng.standard_normal((L, 2, di, 4)).astype(
            np.float32)
        slabs["b_" + t] = rng.standard_normal((L, 2, 4, do)).astype(
            np.float32)
        slabs["a_" + t][:, 0] = 0
        slabs["b_" + t][:, 0] = 0
    aids = np.array([1, 0, 0], np.int32)
    _, targs, tpools = _verify_case(jm, tm, "float32")
    plain = tm.verify_paged(tm.decode_state(), *targs,
                            *[p.clone() for p in tpools])
    got = tm.verify_paged(tm.decode_state(), *targs,
                          *[p.clone() for p in tpools],
                          adapters={k: torch.from_numpy(v)
                                    for k, v in slabs.items()},
                          adapter_ids=torch.from_numpy(aids))
    assert torch.equal(got[1:], plain[1:])
    assert float((got[0] - plain[0]).abs().max()) > 1e-2
    want = jm.verify_paged(
        jm.decode_state(), *(jnp.asarray(t.numpy()) for t in targs),
        *(jnp.asarray(p.numpy()) for p in tpools),
        adapters={k: jnp.asarray(v) for k, v in slabs.items()},
        adapter_ids=jnp.asarray(aids))[0]
    np.testing.assert_allclose(got.numpy(), _f32(want), **TOL)


# -- residual_sample ----------------------------------------------------------
def _draws(p, q, n=4000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p, q = (torch.tensor(x, dtype=torch.float32).expand(n, len(x))
            for x in (p, q))
    return residual_sample(p, q, gen).numpy()


def test_residual_sample_follows_normalised_residual():
    p, q = [0.5, 0.3, 0.15, 0.05], [0.1, 0.6, 0.25, 0.05]
    freq = np.bincount(_draws(p, q), minlength=4) / 4000
    # the residual max(0, p - q) is 0.4 at token 0 and 0 elsewhere
    np.testing.assert_array_equal(freq, [1.0, 0, 0, 0])
    p, q = [0.4, 0.3, 0.2, 0.1], [0.1, 0.1, 0.3, 0.5]
    want = np.array([0.3, 0.2, 0.0, 0.0]) / 0.5
    freq = np.bincount(_draws(p, q, seed=1), minlength=4) / 4000
    # 4000 draws: binomial std <= 0.008 per bin — 0.03 is ~4 sigma
    assert np.abs(freq - want).max() < 0.03, (freq, want)


def test_residual_sample_falls_back_to_p():
    p = [0.7, 0.2, 0.1, 0.0]
    freq = np.bincount(_draws(p, p), minlength=4) / 4000   # residual mass 0
    assert np.abs(freq - np.asarray(p)).max() < 0.03, freq
    assert freq[3] == 0


def test_residual_sample_batched_rows():
    p = torch.tensor([[0.9, 0.1, 0.0], [0.0, 0.2, 0.8]])
    q = torch.tensor([[0.1, 0.9, 0.0], [0.0, 0.8, 0.2]])
    toks = residual_sample(p, q, torch.Generator().manual_seed(1))
    assert toks.tolist() == [0, 2]
    assert residual_sample(p[0], q[0]).shape == ()


class _Req:
    """The knobs and generator ``_acceptance`` reads from a request."""

    def __init__(self, seed, do_sample=True):
        self.do_sample = do_sample
        self.temperature, self.top_k, self.top_p = 1.0, 0, 1.0
        self.generator = torch.Generator().manual_seed(seed)


def test_truncated_round_samples_from_target():
    """Budget exhaustion is not a rejection: a row with ``nv = 1`` (no
    proposal considered) draws its token from ``p``, not from the
    residual, which is 0 at token 0 here (``q > p`` there)."""
    B, K1, V = 2000, 4, 4
    p0 = np.array([0.5, 0.3, 0.15, 0.05])
    q0 = np.array([0.9, 0.05, 0.03, 0.02])
    logits = torch.log(torch.tensor(p0, dtype=torch.float32)).expand(
        B, K1, V).contiguous()
    q = torch.tensor(q0, dtype=torch.float32).expand(B, K1 - 1, V)
    emit, n_emit = _acceptance(logits, torch.zeros(B, K1, dtype=torch.long),
                               q, torch.ones(B, dtype=torch.long),
                               [_Req(i) for i in range(B)])
    assert n_emit.tolist() == [1] * B
    freq = np.bincount(emit[:, 0].numpy(), minlength=V) / B
    # 2000 draws: binomial std <= 0.012 per bin — 0.05 is ~4 sigma
    assert np.abs(freq - p0).max() < 0.05, (freq, p0)


def test_greedy_acceptance_rule():
    """Accept while the proposal equals the target's argmax; the first
    mismatch emits the argmax; a full sweep emits the bonus argmax; the
    budget caps the considered proposals."""
    V = 8
    greedy = torch.tensor([[1, 2, 3, 4], [1, 2, 3, 4], [1, 2, 3, 4]])
    logits = torch.nn.functional.one_hot(greedy, V).float() * 5
    toks = torch.tensor([[0, 1, 2, 3],      # all three accepted
                         [0, 1, 7, 3],      # the second rejected
                         [0, 1, 2, 3]])     # budget: nv = 2
    emit, n_emit = _acceptance(logits, toks, None, torch.tensor([4, 4, 2]),
                               [_Req(0, False)] * 3)
    assert n_emit.tolist() == [4, 2, 2]
    assert emit.tolist() == [[1, 2, 3, 4], [1, 2, 0, 0], [1, 2, 0, 0]]


# -- the engine ---------------------------------------------------------------
def _nb(max_slots=3, max_seq_len=32, block_size=BS):
    """A pool covering both namespaces at every slot's worst case."""
    return 2 * max_slots * blocks_for_tokens(max_seq_len, block_size) + 1


ENGINE = dict(max_slots=3, max_seq_len=32, min_bucket=4, block_size=BS,
              prefill_chunk=8)


def _spec(target, draft, **kw):
    kw = dict(ENGINE, **kw)
    kw.setdefault("spec_k", 3)
    kw.setdefault("n_blocks", _nb(kw["max_slots"]))
    return LLMEngine(target, draft_model=draft, kv_layout="paged", **kw)


def _paged(target, **kw):
    return LLMEngine(target, kv_layout="paged", **dict(ENGINE, **kw))


def _run(eng, handles, limit=400):
    n = 0
    while not all(h.is_finished for h in handles):
        eng.step()
        n += 1
        assert n < limit, "engine did not converge"
    return n


@pytest.fixture(scope="module")
def greedy_refs(models):
    """Prompts, the port's paged engine's greedy tokens and JAX
    ``generate``'s for the first prompt."""
    jm, tm, _ = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n).tolist() for n in (5, 3, 9)]
    base = _paged(tm)
    hs = [base.add_request(p, max_new_tokens=10) for p in prompts]
    _run(base, hs)
    out = jm.generate(paddle.to_tensor(np.asarray([prompts[0]], np.int32)),
                      max_new_tokens=10)
    return prompts, [h.tokens for h in hs], np.asarray(out.numpy())[0, 5:]


@pytest.mark.parametrize("spec_k", [1, 2, 3, 4])
def test_greedy_tokens_equal_paged_engine_and_jax_generate(
        models, greedy_refs, spec_k):
    _, tm, draft = models
    prompts, paged, jax_gen = greedy_refs
    eng = _spec(tm, draft, spec_k=spec_k)
    assert isinstance(eng, SpeculativeLLMEngine)
    before = counters.snapshot()
    hs = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    _run(eng, hs)
    d = counters.delta(before)
    assert [h.tokens for h in hs] == paged
    assert hs[0].tokens == jax_gen.tolist()
    assert all(h.finish_reason == "length" for h in hs)
    assert d.get("serving.spec.rejected", 0) > 0     # the draft disagrees
    # K+1 draft steps and one verify a round; accepted + rejected = drafted
    assert d["serving.spec.draft_steps"] == (spec_k + 1) * \
        d["serving.spec.verify_steps"]
    assert d.get("serving.spec.accepted", 0) + d["serving.spec.rejected"] \
        == d["serving.spec.drafted"]
    assert d["serving.decode_tokens"] == sum(len(h.tokens) - 1 for h in hs)


def test_self_draft_accepts_and_int8_pools_serve(models, greedy_refs):
    """With the target as its own draft nearly every proposal passes and
    rounds yield more than one token; with int8 pools the tokens equal
    the int8 paged engine's."""
    _, tm, draft = models
    prompts, paged, _ = greedy_refs
    eng = _spec(tm, tm, spec_k=4)
    hs = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    _run(eng, hs)
    st = eng.stats()
    assert [h.tokens for h in hs] == paged
    assert st["spec_accepted"] >= 0.9 * st["spec_drafted"] > 0
    assert st["spec_yield_ema"] > 1.5

    base = _paged(tm, kv_dtype="int8")
    bh = [base.add_request(p, max_new_tokens=10) for p in prompts]
    _run(base, bh)
    eng = _spec(tm, draft, kv_dtype="int8")
    assert eng.dpool_k.dtype == torch.int8 and len(eng.dscales) == 2
    hs = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    _run(eng, hs)
    assert [h.tokens for h in hs] == [h.tokens for h in bh]


def test_eos_inside_an_accepted_block(models):
    _, tm, draft = models
    prompt = [2, 7, 2]
    ref = tm.generate([prompt], max_new_tokens=12)[0, 3:].tolist()
    eos = ref[3]
    base = _paged(tm, max_slots=2)
    b = base.add_request(prompt, max_new_tokens=12, eos_token_id=eos)
    _run(base, [b])
    eng = _spec(tm, tm, max_slots=2, spec_k=4)   # whole blocks accepted
    h = eng.add_request(prompt, max_new_tokens=12, eos_token_id=eos)
    _run(eng, [h])
    assert h.tokens == b.tokens and h.tokens[-1] == eos
    assert h.finish_reason == b.finish_reason == "eos"


def test_sampled_output_matches_paged_engine_distribution(models):
    """Two-sample chi-squared over the emitted tokens of 120 seeded
    requests through the paged engine and through the speculative one."""
    _, tm, draft = models
    prompt = [5, 9, 2, 6]
    kw = dict(max_new_tokens=4, do_sample=True, temperature=1.1, top_k=8)
    n = 120

    def harvest(eng):
        counts = np.zeros(64, np.int64)
        pending, live = list(range(n)), []
        while pending or live:
            while pending and len(live) < 4:
                live.append(eng.add_request(prompt, seed=1000 + pending.pop(0),
                                            **kw))
            eng.step()
            for h in [h for h in live if h.is_finished]:
                np.add.at(counts, h.tokens, 1)
            live = [h for h in live if not h.is_finished]
        return counts

    o1 = harvest(_paged(tm, max_slots=4))
    o2 = harvest(_spec(tm, draft, max_slots=4, spec_k=2))
    assert o1.sum() == o2.sum() == n * 4
    both = o1 + o2
    live = both > 0
    stat = float((((o1 - o2) ** 2)[live] / both[live]).sum())
    df = int(live.sum()) - 1
    # p=0.001 critical value for df<=63 is < df + 3.1*sqrt(2*df) + 12
    assert stat < df + 3.1 * np.sqrt(2 * df) + 12, (stat, df)


def test_no_block_leak_and_draft_blocks_never_donated(models):
    _, tm, draft = models
    eng = _spec(tm, draft, prefix_cache=False)
    rng = np.random.default_rng(4)
    before = counters.snapshot()
    for _ in range(2):   # two waves reuse the freed blocks
        hs = [eng.add_request(rng.integers(0, 64, n).tolist(),
                              max_new_tokens=10) for n in (5, 9, 3)]
        _run(eng, hs)
    d = counters.delta(before)
    assert eng.pool.used_blocks == 0
    assert eng.pool.free_blocks == eng.pool.capacity
    assert d.get("serving.spec.rejected", 0) > 0
    assert d.get("serving.spec.rollback_blocks", 0) > 0

    # with the prefix tree on, only target blocks stay behind
    eng = _spec(tm, draft, max_slots=2)
    h = eng.add_request([1, 2, 3, 4, 5, 6], max_new_tokens=8)
    _run(eng, [h])
    assert 0 < eng.pool.used_blocks <= blocks_for_tokens(6 + 8, BS)
    assert eng.pool.used_blocks == eng.stats()["prefix_nodes"]
    assert all(t is None for t in eng._dslot_blocks) and not eng._dbt.any()


def test_missing_draft_table_degrades_to_plain_decode(models, greedy_refs):
    _, tm, draft = models
    prompts, paged, _ = greedy_refs
    eng = _spec(tm, draft, max_slots=2, prefix_cache=False)
    h = eng.add_request(prompts[0], max_new_tokens=10)
    while h.state != "running":
        eng.step()
    s = h.slot
    with eng._cond:
        for b in eng._dslot_blocks[s]:
            eng.pool.release(b)
        eng._dslot_blocks[s] = None
        eng._dbt[s] = 0
    before = counters.snapshot()
    _run(eng, [h])
    assert counters.delta(before).get("serving.spec.draft_starved", 0) > 0
    assert h.tokens == paged[0] and eng.pool.used_blocks == 0


def test_tight_pool_defers_and_cancel_releases_both_namespaces(models):
    _, tm, draft = models
    eng = _spec(tm, draft, max_slots=2, prefix_cache=False,
                n_blocks=2 * blocks_for_tokens(20, BS) + 3)
    hs = [eng.add_request([7] * 5, max_new_tokens=12),
          eng.add_request([9] * 5, max_new_tokens=12)]
    _run(eng, hs)
    assert [len(h.tokens) for h in hs] == [12, 12]
    assert eng.pool.used_blocks == 0

    eng = _spec(tm, draft, max_slots=2, prefix_cache=False)
    live = eng.add_request([1, 2, 3], max_new_tokens=10)
    dead = eng.add_request([4, 5, 6, 7, 8], max_new_tokens=20)
    for _ in range(3):
        eng.step()
    dead.cancel()
    _run(eng, [live, dead])
    assert dead.finish_reason == "cancelled" and len(dead.tokens) < 20
    assert live.finish_reason == "length" and eng.pool.used_blocks == 0


def test_constructor_validation(models):
    _, tm, draft = models
    with pytest.raises(ValueError, match="kv_layout"):
        LLMEngine(tm, draft_model=draft, kv_layout="slots")
    with pytest.raises(ValueError, match="spec_k"):
        _spec(tm, draft, spec_k=0)
    other = GPTForCausalLM(GPTConfig(**dict(CFG, vocab_size=32)),
                           device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        _spec(tm, other)
    short = GPTForCausalLM(GPTConfig(**dict(CFG, max_seq_len=16)),
                           device="cpu")
    with pytest.raises(ValueError, match="draft model"):
        _spec(tm, short)
    with pytest.raises(ValueError, match="both namespaces|each of"):
        _spec(tm, draft, n_blocks=9).add_request([1] * 10, max_new_tokens=10)
