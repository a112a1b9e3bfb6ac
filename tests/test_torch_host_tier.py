"""The host-RAM KV tier of the PyTorch port against the JAX package.

* ``HostKVTier`` unit cases: buffer reuse and the arena gauge, LRU
  overflow returning the dropped keys, ``pop`` of absent keys; the same
  script of keys drops the same keys in both packages.
* ``PrefixCache`` tiering (``spill_victims``, ``mark_spilled``,
  ``host_chain``, ``probe`` with its host run and digest, ``drop_host``,
  ``clear``) gives the same blocks and counts as the JAX tree.
* The engine: an oversubscribed pool serving a stream twice spills on the
  first pass and restores on the second; greedy tokens equal the JAX
  engine's and JAX ``generate``'s, and the tier counters
  (``serving.kv.tier.*``, ``serving.kv.host_buf_reuse``) move exactly as
  JAX's, over fp32 and int8 pools.  A restored block is
  bit-equal to what was spilled, scale rows included.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.resilience import faultinject as jfi
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import kvcache as jkv
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.resilience import faultinject as tfi
from paddle_tpu_torch.serving import kvcache as tkv

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3)
ENGINE = dict(kv_layout="paged", max_slots=2, max_seq_len=32, min_bucket=4,
              block_size=4, prefill_chunk=8, n_blocks=10, host_kv_blocks=32)
TIER = ("serving.kv.tier.spilled_blocks", "serving.kv.tier.restored_blocks",
        "serving.kv.tier.spill_drops", "serving.kv.tier.readopted",
        "serving.kv.host_buf_reuse", "serving.kv.prefix_hits",
        "serving.kv.prefix_misses", "serving.kv.blocks_evicted",
        "serving.kv.pool_exhausted", "serving.kv.prefill_chunks")


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = JGPT(JConfig(use_flash_attention=False, **CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_numpy_state({k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


def _run(eng, handles, limit=300):
    n = 0
    while not all(h.is_finished for h in handles):
        eng.step()
        n += 1
        assert n < limit, "engine did not converge"
    return [list(map(int, h.tokens)) for h in handles]


def _pool_reconciles(eng):
    pool = eng.pool
    live = sum(1 for b in range(1, len(pool._ref)) if pool._ref[b] > 0)
    return len(pool._free) + live == pool.capacity


def _generate(jm, prompt, n):
    out = jm.generate(paddle.to_tensor(np.asarray([prompt], np.int32)),
                      max_new_tokens=n)
    return np.asarray(out.numpy())[0, len(prompt):].tolist()


# -- HostKVTier ---------------------------------------------------------------
SPEC = (((2, 4, 2, 8), torch.float32), ((2, 4, 2, 8), torch.float32))


def test_acquire_reuse_and_arena_gauge():
    before = tcounters.snapshot()
    tier = tkv.HostKVTier(4)
    bufs = tier.acquire(SPEC)
    assert len(bufs) == 2 and all(b.shape == (2, 4, 2, 8) for b in bufs)
    assert not any(b.is_pinned() for b in bufs)
    nbytes = sum(b.nbytes for b in bufs)
    assert tier.arena_bytes == nbytes
    tier.put("a", bufs)
    assert tier.pop("a") is True
    again = tier.acquire(SPEC)
    assert tier.arena_bytes == nbytes                 # flat once warm
    d = tcounters.delta(before)
    assert d.get("serving.kv.host_buf_reuse", 0) == 2
    assert tcounters.get("serving.kv.host_arena_bytes") == nbytes
    assert {id(b) for b in again} == {id(b) for b in bufs}
    # another dtype never takes a recycled float32 buffer
    tier.put("b", again)
    tier.pop("b")
    (i8,) = tier.acquire((((2, 4, 2, 8), torch.int8),))
    assert i8.dtype == torch.int8 and tier.arena_bytes > nbytes


def test_put_lru_overflow_drops_the_same_keys_as_jax():
    jspec = tuple((s, np.dtype(np.float32)) for s, _ in SPEC)
    out = []
    for tier, spec in ((tkv.HostKVTier(2), SPEC),
                       (jkv.HostKVTier(2), jspec)):
        log = [tier.put(k, tier.acquire(spec)) for k in ("a", "b")]
        log.append(tier.get("a") is not None)
        log.append(tier.put("c", tier.acquire(spec)))
        log.append((tier.resident, tier.get("b") is None))
        log.append(tier.put("d", tier.acquire(spec)))
        log.append(tier.put("a", tier.acquire(spec)))
        log.append((tier.pop("nope"), tier.pop("d"), tier.resident))
        out.append(log)
    assert out[0] == out[1]
    assert out[0][3] == ["b"]
    with pytest.raises(ValueError):
        tkv.HostKVTier(0)


def _tree_script(kv, counters):
    """Donate two sequences, spill the cold chain, probe and restore, drop
    and clear; returns the observed blocks, counts and counter moves."""
    log = []
    pool = kv.BlockPool(10, 4)
    cache = kv.PrefixCache(pool)
    before = counters.snapshot()
    seq_a = list(range(12))
    seq_b = list(range(8)) + [40, 41, 42, 43, 44]
    a = pool.alloc_n(3)
    cache.insert(seq_a, a)
    b = pool.alloc_n(4)
    cache.insert(seq_b, a[:2] + b[2:])
    for blk in a + b:
        pool.release(blk)
    log.append(("digest",
                cache.digest() == frozenset({hash(tuple(seq_a[:4]))})))
    victims = cache.spill_victims(5)
    log.append(("victims", [v.block for v in victims]))
    for v in victims[:2]:
        cache.mark_spilled(v)
    log.append(("free", pool.free_blocks, cache.nodes))
    for prompt in (seq_a + [1], seq_b, [50] * 12, seq_a[:6]):
        log.append(("probe", cache.probe(prompt, len(prompt) - 1)))
        log.append(("peek", cache.peek(prompt, len(prompt) - 1)))
    chain = cache.host_chain(seq_a + [1], 12)
    log.append(("chain", [n.chunk for n in chain]))
    for n in chain:
        cache.mark_restored(n, pool.alloc())
    log.append(("restored", [n.block for n in chain], pool.free_blocks))
    blocks, cached = cache.match_full(seq_a, 12)
    log.append(("match_full", blocks, cached))
    for blk in blocks:
        pool.release(blk)
    more = cache.spill_victims(5)
    for v in more:
        cache.mark_spilled(v)
    log.append(("spilled_again", len(more), pool.free_blocks))
    log.append(("dropped", cache.drop_host(more[-1])))
    log.append(("evict", cache.evict(10), pool.free_blocks))
    cache.clear()
    log.append(("clear", pool.free_blocks, cache.nodes, cache.digest()))
    d = counters.delta(before)
    log.append(sorted((k, v) for k, v in d.items()
                      if k.startswith("serving.kv.")))
    return log


def test_prefix_tree_tiering_matches_jax():
    assert _tree_script(tkv, tcounters) == _tree_script(jkv, jcounters)


# -- the engine ---------------------------------------------------------------
def _both(models, fn, **kw):
    """Run ``fn(engine, counters, fi)`` on a port and a JAX engine built
    with the same knobs; returns both results with each side's counter
    moves over ``TIER``."""
    jm, tm = models
    out = []
    for Eng, m, ctr, fi in ((LLMEngine, tm, tcounters, tfi),
                            (JEngine, jm, jcounters, jfi)):
        eng = Eng(m, **dict(ENGINE, **kw))
        before = ctr.snapshot()
        res = fn(eng, ctr, fi)
        d = ctr.delta(before)
        out.append((res, {k: d.get(k, 0) for k in TIER}, eng))
    return out


def _two_passes(prompts, **req):
    def fn(eng, ctr, fi):
        toks = []
        for _ in range(2):       # pass 2 restores what pass 1 spilled
            for i, p in enumerate(prompts):
                toks.append(_run(eng, [eng.add_request(
                    p, max_new_tokens=4, seed=i, **req)])[0])
        st = eng.stats()
        return toks, (st["tier_spilled"], st["tier_restored"],
                      st["host_tier_blocks"], st["host_tier_capacity"])
    return fn


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_two_pass_spill_restore_matches_jax(models, kv_dtype):
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, 64, size=9).tolist() for _ in range(6)]
    (t, tc, te), (j, jc, je) = _both(models, _two_passes(prompts),
                                     kv_dtype=kv_dtype)
    assert t == j and tc == jc
    assert tc["serving.kv.tier.spilled_blocks"] > 0
    assert tc["serving.kv.tier.restored_blocks"] > 0
    assert tc["serving.kv.host_buf_reuse"] > 0
    assert _pool_reconciles(te)
    if kv_dtype is None:
        jm, _ = models
        assert t[0][:6] == [_generate(jm, p, 4) for p in prompts]
    te.prefix.clear()
    assert te.pool.free_blocks == te.pool.capacity
    assert te._host_tier.resident == 0


def test_sampled_two_pass_equals_an_ample_pool(models):
    """Sampled requests (the two packages' random streams differ, so the
    port is held to itself): the tiered engine's tokens equal those of a
    pool large enough to spill nothing."""
    _, tm = models
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 64, size=9).tolist() for _ in range(5)]
    kw = dict(do_sample=True, temperature=0.8, top_k=8, top_p=0.9)
    ample = LLMEngine(tm, **dict(ENGINE, n_blocks=64, host_kv_blocks=0))
    refs = [_run(ample, [ample.add_request(p, max_new_tokens=4,
                                           seed=50 + i, **kw)])[0]
            for i, p in enumerate(prompts)]
    eng = LLMEngine(tm, **ENGINE)
    before = tcounters.snapshot()
    for _ in range(2):
        got = [_run(eng, [eng.add_request(p, max_new_tokens=4,
                                          seed=50 + i, **kw)])[0]
               for i, p in enumerate(prompts)]
        assert got == refs
    d = tcounters.delta(before)
    assert d.get("serving.kv.tier.restored_blocks", 0) > 0
    assert _pool_reconciles(eng)


def _spill_then_rerun(fault):
    def fn(eng, ctr, fi):
        p = np.random.default_rng(23).integers(0, 64, size=9).tolist()
        h1 = eng.add_request(p, max_new_tokens=4, seed=0)
        _run(eng, [h1])
        with eng._cond:
            spilled = eng._spill_cold(3)
        resident = eng._host_tier.resident
        probe = eng.prefix_probe(np.asarray(p + [9], np.int32))
        h2 = eng.add_request(p, max_new_tokens=4, seed=0)
        if fault:
            with fi.fault_schedule(f"kv_spill_drop@{h2.rid}"):
                _run(eng, [h2])
                fired = ("kv_spill_drop", h2.rid) in fi.fired
        else:
            _run(eng, [h2])
            fired = False
        return (h1.tokens, h2.tokens, spilled, resident, probe, fired,
                eng._host_tier.resident, _pool_reconciles(eng))
    return fn


@pytest.mark.parametrize("fault", [False, True])
def test_spill_drop_and_readoption_match_jax(models, fault):
    """The whole chain spilled, then the same prompt again: without a
    fault admission restores the two matchable blocks and the donation
    re-adopts the third; with ``kv_spill_drop`` the chain is dropped and
    the prompt re-prefills as a plain miss.  Tokens, probes and counters
    equal JAX's."""
    (t, tc, _), (j, jc, _) = _both(models, _spill_then_rerun(fault))
    assert t == j and tc == jc
    assert t[0] == t[1] and t[2:4] == (3, 3) and t[4] == (0, 8)
    assert t[5] == fault and t[6] == 0 and t[7]
    if fault:
        assert tc["serving.kv.tier.spill_drops"] == 3
        assert tc["serving.kv.tier.restored_blocks"] == 0
    else:
        assert tc["serving.kv.tier.restored_blocks"] == 2
        assert tc["serving.kv.tier.readopted"] == 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_restored_block_bit_equal_to_spilled(models, kv_dtype):
    """One block spilled to the tier and restored into another block is
    bit-equal in every pool, scale rows included."""
    _, tm = models
    eng = LLMEngine(tm, **dict(ENGINE, kv_dtype=kv_dtype))
    _run(eng, [eng.add_request(list(range(1, 14)), max_new_tokens=3)])
    # the first block of the donated sequence, held by the prefix tree
    src = next(iter(eng.prefix._root.children.values())).block
    with eng._cond:
        bufs = eng._spill_block(src)
        dst = eng.pool.alloc()
        eng._restore_block(dst, bufs)
        eng._restores_done()
    pools = eng._pools()
    assert len(pools) == (4 if kv_dtype else 2)
    for pool in pools:
        assert torch.equal(pool[:, dst], pool[:, src])
        assert pool[:, src].any()
