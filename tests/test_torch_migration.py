"""Engine-level KV migration in the PyTorch port against the JAX package.

Both packages' paged engines hand a request off the same way: the source
runs it with ``hold_after_prefill=True``, ``export_request`` snapshots it,
``adopt_migration(mig, src)`` installs it on a destination engine over
the same device and ``finish_migrated`` releases the source.  Over the
same 2-layer fp32 model (weights carried by ``load_numpy_state``):

* the migrated continuation's greedy tokens equal the JAX hand-off's and
  the unmigrated engine's (token-identical, fp32);
* blocks copied and blocks adopted by refcount are JAX's: a prefix the
  destination already caches is shared, only the unshared tail copied;
* a destination that cannot host the table raises ``BlockPoolExhausted``
  with nothing allocated, and the source is intact;
* a held request spilled to the host tier pages back in on export, or
  raises ``HostTierLost`` under ``kv_spill_drop``, counting as JAX;
* int8 pools migrate with their scale rows bit-equal, a partial last
  block included; tenants migrate by name; the speculative engine
  re-prefills its draft namespace (``_adopt_extra``); a sampled request
  carries its generator.
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
from paddle_tpu.serving.kvcache import BlockPoolExhausted as JExhausted
from paddle_tpu.serving.kvcache import HostTierLost as JLost
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.resilience import faultinject as tfi
from paddle_tpu_torch.serving import (BlockPoolExhausted, HostTierLost,
                                      random_lora_factors)
from paddle_tpu_torch.serving.kvcache import TRASH_BLOCK, blocks_for_tokens

BS = 8
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64, initializer_range=0.3)
ENGINE = dict(kv_layout="paged", max_slots=2, max_seq_len=64, min_bucket=4,
              block_size=BS, prefill_chunk=16)
TIER = ("serving.kv.tier.spilled_blocks", "serving.kv.tier.restored_blocks",
        "serving.kv.tier.spill_drops", "serving.kv.host_buf_reuse",
        "serving.kv.pool_exhausted", "serving.kv.prefix_hits")


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = JGPT(JConfig(use_flash_attention=False, **CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_numpy_state({k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


def _sides(models):
    """(name, engine class, model, counters, faultinject, errors)."""
    jm, tm = models
    return (("torch", LLMEngine, tm, tcounters, tfi,
             (BlockPoolExhausted, HostTierLost)),
            ("jax", JEngine, jm, jcounters, jfi, (JExhausted, JLost)))


def _reconciles(eng):
    pool = eng.pool
    live = sum(1 for b in range(1, len(pool._ref)) if pool._ref[b] > 0)
    return len(pool._free) + live == pool.capacity


def _finish(eng, req, limit=200):
    n = 0
    while not req.is_finished:
        eng.step()
        n += 1
        assert n < limit, "engine did not converge"
    return list(map(int, req.tokens))


def _held(eng, prompt, steps=None, **kw):
    req = eng.add_request(prompt, max_new_tokens=kw.pop("max_new_tokens", 6),
                          seed=kw.pop("seed", 5), hold_after_prefill=True,
                          **kw)
    if steps is None:
        while req.state != "held":
            eng.step()
    else:
        for _ in range(steps):
            eng.step()
    return req


def _migrate(src, dst, req):
    mig = src.export_request(req)
    new, info = dst.adopt_migration(mig, src)
    src.finish_migrated(req)
    return mig, new, info


def _prompt(seed, n=27):
    return np.random.default_rng(seed).integers(1, 64, size=n).tolist()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_handoff_token_identical_to_jax_and_unmigrated(models, kv_dtype):
    prompt = _prompt(30)
    out = {}
    for name, Eng, m, ctr, _, _ in _sides(models):
        kw = dict(ENGINE, kv_dtype=kv_dtype)
        src, dst, ref = Eng(m, **kw), Eng(m, **kw), Eng(m, **kw)
        req = _held(src, prompt)
        first = list(req.tokens)
        _, new, info = _migrate(src, dst, req)
        assert new.state == "running" and req.finish_reason == "migrated"
        toks = _finish(dst, new)
        want = _finish(ref, ref.add_request(prompt, max_new_tokens=6,
                                            seed=5))
        out[name] = (toks, first, info, want,
                     _reconciles(src) and _reconciles(dst))
    assert out["torch"] == out["jax"]
    toks, first, info, want, ok = out["torch"]
    assert toks == want and toks[:1] == first and ok
    n_data = blocks_for_tokens(len(prompt), BS)
    assert info == {"blocks_copied": n_data, "blocks_shared": 0,
                    "tokens": len(prompt),
                    "blocks_total": blocks_for_tokens(len(prompt) + 5, BS)}


def test_shared_prefix_blocks_adopted_not_copied(models):
    """Two prompts with a common 16-token prefix migrate to one
    destination: the second adopts the two prefix blocks the first left
    in the destination's tree and copies only its tail, as in JAX; the
    migrated prefix is shareable there at once."""
    system = _prompt(31, 16)
    prompts = [system + _prompt(32 + i, 11) for i in range(2)]
    out = {}
    for name, Eng, m, _, _, _ in _sides(models):
        src, dst = Eng(m, **ENGINE), Eng(m, **ENGINE)
        infos, toks = [], []
        for p in prompts:
            _, new, info = _migrate(src, dst, _held(src, p))
            infos.append(info)
            peek = dst.prefix_peek(np.asarray(p, np.int32))
            toks.append((_finish(dst, new), peek))
        out[name] = (infos, toks)
    assert out["torch"] == out["jax"]
    infos, toks = out["torch"]
    assert infos[1]["blocks_shared"] == 2
    assert infos[1]["blocks_copied"] == blocks_for_tokens(27, BS) - 2
    assert toks[0][1] == (27 // BS) * BS


def test_destination_exhausted_tears_nothing(models):
    prompt = _prompt(33)
    out = {}
    for name, Eng, m, ctr, _, errs in _sides(models):
        src = Eng(m, **ENGINE)
        tiny = Eng(m, **dict(ENGINE, n_blocks=3, prefix_cache=False))
        req = _held(src, prompt)
        mig = src.export_request(req)
        before = ctr.snapshot()
        free = tiny.pool.free_blocks
        with pytest.raises(errs[0]):
            tiny.adopt_migration(mig, src)
        torn = (tiny.pool.free_blocks != free
                or any(r is not None for r in tiny._slots))
        moved = ctr.delta(before).get("serving.kv.pool_exhausted", 0)
        # the source never moved: the same export adopts cleanly
        dst = Eng(m, **ENGINE)
        new, _ = dst.adopt_migration(mig, src)
        src.finish_migrated(req)
        out[name] = (torn, moved, _finish(dst, new))
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (False, 1)


def test_idle_spill_then_export_restores_and_migrates(models):
    """A held request idle past ``spill_idle_steps`` spills its blocks to
    the host tier; export pages them back in, then it migrates."""
    prompt = _prompt(34)
    n_data = blocks_for_tokens(len(prompt), BS)
    out = {}
    for name, Eng, m, ctr, _, _ in _sides(models):
        src = Eng(m, **dict(ENGINE, host_kv_blocks=16, spill_idle_steps=2))
        dst = Eng(m, **ENGINE)
        before = ctr.snapshot()
        req = _held(src, prompt, steps=8)
        table = list(src._slot_blocks[req.slot])
        spilled = (req.state, all(b == TRASH_BLOCK
                                  for b in table[:n_data]),
                   src._host_tier.resident)
        mig, new, info = _migrate(src, dst, req)
        d = ctr.delta(before)
        out[name] = (spilled, all(b != TRASH_BLOCK
                                  for b in mig["table"][:n_data]),
                     info, _finish(dst, new),
                     {k: d.get(k, 0) for k in TIER},
                     _reconciles(src) and _reconciles(dst))
    assert out["torch"] == out["jax"]
    spilled, back, info, _, moved, ok = out["torch"]
    assert spilled == ("held", True, n_data) and back and ok
    assert moved["serving.kv.tier.spilled_blocks"] == n_data
    assert moved["serving.kv.tier.restored_blocks"] == n_data


def test_kv_spill_drop_on_export_raises_host_tier_lost(models):
    prompt = _prompt(35)
    out = {}
    for name, Eng, m, ctr, fi, errs in _sides(models):
        src = Eng(m, **dict(ENGINE, host_kv_blocks=16, spill_idle_steps=2))
        req = _held(src, prompt, steps=8)
        before = ctr.snapshot()
        free = src.pool.free_blocks
        with fi.fault_schedule(f"kv_spill_drop@{req.rid}"):
            with pytest.raises(errs[1]):
                src.export_request(req)
            fired = ("kv_spill_drop", req.rid) in fi.fired
        d = ctr.delta(before)
        state = (fired, src._host_tier.resident, src.pool.free_blocks - free,
                 {k: d.get(k, 0) for k in TIER})
        src._finish(req, "dropped", [])
        src.prefix.clear()
        out[name] = (state, src.pool.free_blocks == src.pool.capacity)
    assert out["torch"] == out["jax"]
    (fired, resident, freed, moved), clean = out["torch"]
    assert fired and resident == 0 and freed == 0 and clean
    assert moved["serving.kv.tier.spill_drops"] == \
        blocks_for_tokens(len(prompt), BS)


def test_int8_partial_block_scale_rows_survive_tier_and_migration(models):
    """int8 pools: a held request whose last block is partial round-trips
    through the host tier and migrates; the destination's tiles and scale
    rows equal the source's bit for bit, and the tokens equal JAX's."""
    prompt = _prompt(36)
    n_data = blocks_for_tokens(len(prompt), BS)
    out = {}
    for name, Eng, m, _, _, _ in _sides(models):
        src = Eng(m, **dict(ENGINE, kv_dtype="int8", host_kv_blocks=16,
                            spill_idle_steps=2))
        dst = Eng(m, **dict(ENGINE, kv_dtype="int8"))
        req = _held(src, prompt, steps=8)
        resident = src._host_tier.resident
        mig = src.export_request(req)
        new, _ = dst.adopt_migration(mig, src)
        if name == "torch":
            dtable = dst._slot_blocks[new.slot]
            for sp, dp in zip(src._pools(), dst._pools()):
                for i in range(n_data):
                    valid = min(BS, len(prompt) - i * BS)
                    assert torch.equal(sp[:, mig["table"][i], :valid],
                                       dp[:, dtable[i], :valid]), i
        src.finish_migrated(req)
        out[name] = (resident, _finish(dst, new))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == n_data


def test_tenant_migrates_by_name(models):
    """A tenant's held request migrates to an engine that has the same
    tenant registered: the destination re-acquires the adapter by name,
    re-enters the prefix in the tenant's key plane, and the tokens equal
    JAX's; an adapter-free destination refuses it."""
    prompt = _prompt(37)
    f = random_lora_factors(GPTConfig(**CFG), 3, seed=1, scale=1.0)
    out = {}
    for name, Eng, m, _, _, _ in _sides(models):
        kw = dict(ENGINE, adapter_slots=2, adapter_rank=4)
        src, dst, plain = Eng(m, **kw), Eng(m, **kw), Eng(m, **ENGINE)
        for e in (src, dst):
            e.register_adapter("t1", f)
        req = _held(src, prompt, adapter="t1")
        mig = src.export_request(req)
        with pytest.raises(ValueError, match="adapter_slots=0"):
            plain.adopt_migration(mig, src)
        new, info = dst.adopt_migration(mig, src)
        src.finish_migrated(req)
        out[name] = (info, _finish(dst, new),
                     dst.prefix_peek(np.asarray(prompt, np.int32)),
                     dst.prefix_peek(np.asarray(prompt, np.int32),
                                     tenant="t1"),
                     dst.adapters.stats()["tenants"])
    assert out["torch"] == out["jax"]
    assert out["torch"][2:] == (0, (len(prompt) // BS) * BS, {"t1": 0})


def test_speculative_destination_reprefills_its_draft(models):
    """``_adopt_extra``: a speculative destination re-prefills the
    migrated sequence into its draft pools, then decodes speculatively to
    the tokens of the JAX hand-off (greedy identity)."""
    jm, tm = models
    prompt = _prompt(38)
    jsrc, jdst = JEngine(jm, **ENGINE), JEngine(jm, **ENGINE)
    _, jnew, _ = _migrate(jsrc, jdst, _held(jsrc, prompt))
    want = _finish(jdst, jnew)
    draft = GPTForCausalLM(GPTConfig(**dict(CFG, num_layers=1)), device="cpu",
                           generator=torch.Generator().manual_seed(7))
    src = LLMEngine(tm, **ENGINE)
    dst = LLMEngine(tm, **dict(ENGINE, draft_model=draft, spec_k=3,
                               n_blocks=2 * 2 * 8 + 1))
    req = _held(src, prompt)
    before = tcounters.snapshot()
    _, new, _ = _migrate(src, dst, req)
    assert dst._dslot_blocks[new.slot] == [
        int(b) for b in dst._dbt[new.slot, :blocks_for_tokens(27, BS)]]
    d = tcounters.delta(before)
    assert d.get("serving.spec.draft_prefill_chunks", 0) == 2   # 27 / 16
    assert _finish(dst, new) == want
    d = tcounters.delta(before)
    assert d.get("serving.spec.drafted", 0) > 0
    assert _reconciles(src)


def test_sampled_request_carries_its_generator(models):
    """A sampled request's stream continues on the destination: its
    tokens equal the same request served without migration (the two
    packages' random streams differ, so the port is held to itself)."""
    _, tm = models
    prompt = _prompt(39)
    kw = dict(max_new_tokens=8, seed=11, do_sample=True, temperature=0.9,
              top_k=20)
    ref = LLMEngine(tm, **ENGINE)
    want = _finish(ref, ref.add_request(prompt, **kw))
    src, dst = LLMEngine(tm, **ENGINE), LLMEngine(tm, **ENGINE)
    req = _held(src, prompt, **kw)
    mig, new, _ = _migrate(src, dst, req)
    assert mig["generator_state"] is not None
    assert _finish(dst, new) == want


def test_tenant_adopt_under_an_active_fault_schedule(models):
    """A reference fault the port does not copy: the JAX adopt acquires a
    migrated tenant with ``rid=None`` and its ``adapter_load_drop`` check
    takes ``int(None)`` whenever any fault schedule is active
    (``paddle_tpu/serving/adapters.py:280``, reached from
    ``paddle_tpu/serving/paged.py:1290``), raising ``TypeError``; the port
    checks the fault only for an admission's request id and adopts."""
    prompt = _prompt(40, 12)
    f = random_lora_factors(GPTConfig(**CFG), 3, seed=2, scale=1.0)
    out = {}
    for name, Eng, m, _, fi, _ in _sides(models):
        kw = dict(ENGINE, adapter_slots=2, adapter_rank=4)
        src, dst = Eng(m, **kw), Eng(m, **kw)
        for e in (src, dst):
            e.register_adapter("t2", f)
        req = _held(src, prompt, adapter="t2")
        mig = src.export_request(req)
        with fi.fault_schedule("kv_pool_exhausted@999"):
            try:
                new, _ = dst.adopt_migration(mig, src)
                out[name] = _finish(dst, new)
            except TypeError as e:
                out[name] = repr(e)
    assert "TypeError" in out["jax"]
    assert isinstance(out["torch"], list) and len(out["torch"]) == 6
