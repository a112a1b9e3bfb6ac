"""The serving extras on a tensor-parallel mesh: speculative decoding,
multi-tenant LoRA, the host-RAM KV tier, KV migration and the fleet,
each held against the JAX package's engines (``tests/test_serving_mesh.py``
and ``tests/test_adapters.py`` pin the JAX behaviour).

The port's mp2 engines run in two spawned gloo ranks
(``tests/_torch_mesh_workers.py`` ``serving_extras_mp2``, one spawn for
the module) on the JAX models' fp32 weights (``load_numpy_state``); the
JAX engines run here on the 8-device virtual mesh, unsharded and over an
``mp`` mesh of two devices, through the same scenario functions
(``extras_*``: both packages' engines take the same arguments).  A mesh
of one rank runs here, in the pytest process, over a one-rank gloo
group.

What is held, with its JAX counterpart:

* greedy tokens at mp2 equal the JAX mp2 engine's and the unsharded
  JAX engine's, request for request: speculative decoding with a
  1-layer 2-head draft (split over ``mp``) and self-drafted (rounds
  accept blocks, so rank 0's broadcast carries their lengths), LoRA
  with two tenants
  beside base rows, the host tier (a stream served twice through a pool
  that spills: pass 2 restores), in fp32 and int8 KV, migration (every
  request exported by one engine and adopted by another) and a fleet of
  one replica and of one prefill + one decode replica (pumped, and
  threaded: one scheduler thread);
* seeded sampling (speculative, LoRA) is held to the port's own
  unsharded engine: the port draws from ``torch.Generator`` streams, not
  JAX keys;
* a draft with 3 heads over mp 2 degrades to replicated
  (``serving.mesh.spec_degraded``) and keeps the tokens (the JAX
  contract of ``tests/test_serving_mesh.py``'s indivisible heads);
* the LoRA update under ``TensorParallel`` equals the unsharded
  ``_mm_lora`` for a column-parallel (qkv) and a row-parallel (proj)
  weight, and each rank's LoRA arena holds only its cut of the slabs;
* a threaded mp2 fleet whose replica stalls while the caller submits
  (rank 0's stall verdict, applied on every rank) serves every request
  with the tokens of a fleet that did not stall;
* a mesh of one rank is bit-identical to no mesh, with the serving
  counters equal, the autoscaler's included.

The fleet's control plane at mp2 (faults, crash respawn, the autoscaler,
deadlines and cancels) is held in
``tests/test_torch_mesh_fleet_control.py``.
"""

import datetime

import numpy as np
import pytest
import torch

import _torch_mesh_workers as W

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3, use_flash_attention=False)
DRAFT = dict(CFG, hidden_size=16, num_layers=1, num_heads=2)
DRAFT3 = dict(DRAFT, hidden_size=24, num_heads=3)
PROMPTS = [[5, 9, 11], [7, 3], [5, 9, 2, 4], [5, 9, 11, 8]]
SAMPLE = dict(do_sample=True, temperature=0.9, top_k=8)
STREAM = np.random.default_rng(20).integers(0, 64, size=(6, 9)).tolist()
KV = {"f32": None, "int8": "int8"}
AUTOSCALE = ("serving.autoscale.decisions", "serving.autoscale.spawns",
             "serving.autoscale.retires", "serving.autoscale.flips.to_prefill",
             "serving.autoscale.flips.to_decode")
PARITY = AUTOSCALE + ("serving.requests", "serving.prefill_batches",
          "serving.decode_steps", "serving.decode_tokens",
          "serving.kv.prefill_chunks", "serving.spec.drafted",
          "serving.spec.accepted", "serving.spec.verify_steps",
          "serving.kv.tier.spilled_blocks", "serving.kv.tier.restored_blocks",
          "serving.adapter.loads", "serving.adapter.hits",
          "serving.fleet.dispatched", "serving.fleet.migrate.requests",
          "serving.fleet.migrate.blocks_copied")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_registries():
    """The JAX engines here fill the JAX package's global registries:
    cleared after the module."""
    yield
    from paddle_tpu.profiler import devicetime, flight, metrics, trace
    metrics.reset_metrics()
    flight.clear()
    trace.clear()
    devicetime.reset()


def _jax_model(cfg, seed):
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    jp.seed(seed)
    m = GPTForCausalLM(GPTConfig(**cfg))
    m.eval()
    return m, {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _factors(cfg):
    from paddle_tpu.models import GPTConfig
    from paddle_tpu.serving.adapters import random_lora_factors
    return {t: random_lora_factors(GPTConfig(**cfg), 4, seed=s, scale=0.3)
            for t, s in (("t1", 1), ("t2", 2))}


def _jax_side(jm, jd, factors, mesh):
    from paddle_tpu.serving import LLMEngine, ServingFleet
    out = {"spec": W.extras_spec(LLMEngine, jm, jd, mesh, PROMPTS)[0],
           "spec_self": W.extras_spec(LLMEngine, jm, jm, mesh, PROMPTS)[0],
           "lora": W.extras_lora(LLMEngine, jm, mesh, PROMPTS, factors)[0]}
    for kv, kvd in KV.items():
        out[f"tier_{kv}"] = W.extras_tier(LLMEngine, jm, mesh, STREAM,
                                          kvd)[:2]
        out[f"migration_{kv}"] = W.extras_migration(LLMEngine, jm, mesh,
                                                    PROMPTS, kvd)[:2]
    for tag, pre in (("fleet", 0), ("fleet_disagg", 1)):
        out[tag] = W.extras_fleet(ServingFleet, jm, mesh, PROMPTS, pre)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import jax
    from jax.sharding import Mesh
    jm, state = _jax_model(CFG, 0)
    jd, dstate = _jax_model(DRAFT, 1)
    _, d3state = _jax_model(DRAFT3, 2)
    factors = _factors(CFG)
    pl = {"cfg": CFG, "state": state, "draft_cfg": DRAFT,
          "draft_state": dstate, "draft3_cfg": DRAFT3,
          "draft3_state": d3state, "prompts": PROMPTS, "sample": SAMPLE,
          "factors": factors, "stream": STREAM}
    ranks = W.spawn("serving_extras_mp2", 2, tmp_path_factory.mktemp("ex"),
                    pl)
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("mp",))
    jax_out = {"mp2": _jax_side(jm, jd, factors, mesh2),
               "single": _jax_side(jm, jd, factors, None)}
    return jax_out, ranks.results()


def _equal_to_jax(served, key, pick=lambda v: v):
    """The port's mp2 result under ``key`` on every rank equals the JAX
    mp2 engine's and the unsharded JAX engine's (``pick`` takes the
    tokens out of a JAX scenario's result)."""
    j, res = served
    want = pick(j["single"][key])
    assert pick(j["mp2"][key]) == want
    for out in res:
        assert out[key] == want


def test_mp2_speculative_greedy_equals_jax(served):
    _equal_to_jax(served, "spec")


def test_mp2_speculative_draft_splits_over_mp(served):
    """The draft's pools and weights hold this rank's head (1 of 2):
    half the unsharded draft pools' bytes; it drafted, and no rank chose
    a proposal or an accepted block apart from rank 0."""
    _, res = served
    for out in res:
        st = out["spec_stats"]
        assert st["draft_shard"] == (1, st["draft_shard"][1], 4, 1, 8)
        assert st["draft_qkv"] == (1, 16, 24)
        assert 2 * st["draft_bytes"] == st["draft_bytes_single"]
        assert st["drafted"] > 0
        assert st["disagreements"] == 0


def test_mp2_self_drafted_rounds_accept_and_equal_jax(served):
    """Drafting with the target itself (its 4 heads split over mp, 2 a
    rank), rounds accept blocks of more than one token: rank 0's
    broadcast decides each block and its length, and the tokens equal
    the JAX engines'.  (The random 1-layer draft above accepts
    nothing.)"""
    _equal_to_jax(served, "spec_self")
    _, res = served
    for out in res:
        st = out["spec_self_stats"]
        assert st["accepted"] > 0 and st["drafted"] > 0
        assert st["draft_heads"] == 2
        assert st["disagreements"] == 0
    assert res[0]["spec_self_stats"] == res[1]["spec_self_stats"]


def test_mp2_speculative_sampled_equals_unsharded_port(served):
    _, res = served
    for out in res:
        assert out["spec_sampled"] == out["spec_sampled_single"]
    assert res[0]["spec_sampled"] == res[1]["spec_sampled"]


def test_draft_with_indivisible_heads_degrades_and_keeps_tokens(served):
    j, res = served
    for out in res:
        st = out["spec3_stats"]
        assert st["degraded"] >= 2
        assert st["draft_shard"][3] == 3       # the draft's heads whole
        assert st["target_shard"][3] == 2      # the target's still split
        assert out["spec3"] == j["single"]["spec"]


def test_mp2_lora_mixed_tenants_equal_jax(served):
    j, res = served
    _equal_to_jax(served, "lora")
    # the tenants' rows are not the base model's
    base = j["single"]["spec"]
    assert j["single"]["lora"][1] != base[1]
    for out in res:
        assert out["lora_stats"]["disagreements"] == 0


def test_mp2_lora_arena_holds_the_ranks_cut(served):
    """Each rank's arena holds B's half of the columns of qkv (per q/k/v
    block) and fc1 and A's half of the rows of proj and fc2; the other
    factors whole."""
    _, res = served
    cut = {"b_qkv_w": -1, "b_fc1_w": -1, "a_proj_w": -2, "a_fc2_w": -2}
    for out in res:
        mine = out["lora_stats"]["slabs"]
        whole = out["lora_stats"]["slabs_single"]
        assert set(mine) == set(whole)
        for n, shape in whole.items():
            want = list(shape)
            if n in cut:
                want[cut[n]] //= 2
            assert list(mine[n]) == want


def test_mp2_lora_sampled_equals_unsharded_port(served):
    _, res = served
    for out in res:
        assert out["lora_sampled"] == out["lora_sampled_single"]


@pytest.mark.parametrize("weight", ["qkv", "proj"])
def test_lora_delta_under_tensor_parallel(served, weight):
    """Column-parallel qkv (the update's columns cut per q/k/v block) and
    row-parallel proj (the rank's rows of A, all-reduced with the
    partial sum) equal the unsharded ``_mm_lora`` in fp32; base rows are
    bitwise the adapter-free product's."""
    _, res = served
    for out in res:
        got, want, base_bitwise = out["lora_tp"][weight]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert base_bitwise


@pytest.mark.parametrize("kv", list(KV))
def test_mp2_host_tier_spill_restore_equals_jax(served, kv):
    j, res = served
    _equal_to_jax(served, f"tier_{kv}", pick=lambda v: v[0])
    spilled, restored = j["single"][f"tier_{kv}"][1]
    for out in res:
        st = out[f"tier_{kv}_stats"]
        assert st["moved"] == (spilled, restored)
        assert spilled > 0 and restored > 0
        assert st["disagreements"] == 0


@pytest.mark.parametrize("kv", list(KV))
def test_mp2_host_tier_holds_the_ranks_head_shard(served, kv):
    """Each rank's host buffers hold its 2 of 4 heads; the int8 scale
    rows (no head axis) stay whole."""
    _, res = served
    for out in res:
        st = out[f"tier_{kv}_stats"]
        mine, whole = st["host_spec"], st["host_spec_single"]
        assert [s[2] for s in mine[:2]] == [2, 2]
        assert [s[2] for s in whole[:2]] == [4, 4]
        assert mine[2:] == whole[2:]
        assert st["host_bytes"] > 0


@pytest.mark.parametrize("kv", list(KV))
def test_mp2_migration_equals_jax(served, kv):
    j, res = served
    _equal_to_jax(served, f"migration_{kv}", pick=lambda v: v[0])
    copied = j["single"][f"migration_{kv}"][1]
    for out in res:
        assert out[f"migration_{kv}_copied"] == copied > 0


def test_migration_across_head_splits_refused(served):
    _, res = served
    for out in res:
        msg = out["migration_refused"]
        assert msg.startswith("ValueError") and "head splits" in msg


@pytest.mark.parametrize("tag", ["fleet", "fleet_disagg"])
def test_mp2_fleet_equals_jax(served, tag):
    """A pumped fleet on the mesh: tokens, and the disaggregated fleet's
    migrations (one a request), equal the JAX fleet's."""
    _equal_to_jax(served, tag)


@pytest.mark.parametrize("tag", ["fleet", "fleet_disagg"])
def test_mp2_threaded_fleet_equals_pumped(served, tag):
    _, res = served
    for out in res:
        assert out[f"{tag}_threaded"] == out[tag]


def test_mp2_threaded_fleet_stall_during_submits(served):
    """Rank 0 alone sees replica 0's heartbeat go stale while both ranks'
    callers submit: the verdict is rank 0's, so both ranks drain and
    respawn the same replica once, the stalled requests replay, and
    every request of both rounds ends with the tokens of a fleet without
    the mesh and without the stall."""
    _, res = served
    for out in res:
        toks, moved = out["fleet_stall"]
        assert toks == 2 * out["fleet_stall_ref"][0]
        assert moved == (1, 1)


# ---------------------------------------------------------------------------
# a mesh of one rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of one rank in this process and whole models built
    without the mesh, destroyed after."""
    from paddle_tpu_torch import distributed as D
    D.init_parallel_env(backend="gloo", rank=0, world_size=1,
                        store=torch.distributed.HashStore(),
                        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = D.build_mesh({"mp": 1})
        D.set_mesh(None)    # a model built under a mesh holds its shards
        models = []
        for cfg, seed in ((CFG, 0), (DRAFT, 1)):
            m = W._gpt(cfg, _jax_model(cfg, seed)[1])
            m.eval()
            models.append(m)
        D.set_mesh(mesh)
        yield mesh, models
    finally:
        D.reset_parallel_env()


def _scenario(what, mesh, model, draft):
    from paddle_tpu_torch.serving import LLMEngine, ServingFleet
    if what == "spec":
        return W.extras_spec(LLMEngine, model, draft, mesh, PROMPTS,
                             SAMPLE)[0]
    if what == "lora":
        return W.extras_lora(LLMEngine, model, mesh, PROMPTS,
                             _factors(CFG), SAMPLE)[0]
    if what.startswith("tier"):
        return W.extras_tier(LLMEngine, model, mesh, STREAM,
                             KV[what.split("_")[1]])[:2]
    if what == "migration":
        return W.extras_migration(LLMEngine, model, mesh, PROMPTS)[:2]
    if what == "fleet_autoscale":
        return _autoscale(ServingFleet, model, mesh)
    return W.extras_fleet(ServingFleet, model, mesh, PROMPTS,
                          prefill_replicas=int(what == "fleet_disagg"))


def _autoscale(Fleet, model, mesh):
    """``tests/test_torch_fleet.py``'s grow-prefill-then-retire pattern:
    a disaggregated fleet with the autoscaler, its health plane ticked
    only here, at t = 0, 1, ..., and fed one TTFT burn before tick 1.
    Tokens, then the firing alerts, roles and replica count after each
    pump, then the autoscaler's actions."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.profiler import health, metrics
    flags.set_flags({"FLAGS_health": True, "FLAGS_health_interval_s": 0.0})
    slo = health.SLO("ttft_burn", ("hist_p95", "serving.ttft_ns"), 1e10,
                     windows=((1.0, 1.0),), min_count=4)
    fleet = Fleet(model, replicas=2, prefill_replicas=1, mesh=mesh,
                  threaded=False, autoscale=True,
                  autoscale_kw=dict(cooldown_ticks=0, ok_streak=2,
                                    max_replicas=3),
                  health_kw=dict(rules=[slo]), **W.EXTRAS_FLEET)
    try:
        fleet.health.maybe_tick = lambda now=None: None  # ticked below
        hs = [fleet.submit(p, max_new_tokens=5, seed=21 + i)
              for i, p in enumerate(PROMPTS)]
        fleet.join(hs)
        trail = []
        for t, burn in enumerate((False, True, False, False, False, False)):
            if burn:
                h = metrics.get_histogram("serving.ttft_ns", "ns")
                for _ in range(40):
                    h.record(1e11)
            fleet.health.tick(now=float(t))
            fleet.pump()
            st = fleet.stats()
            trail.append((sorted(fleet.health.firing_names()), st["roles"],
                          st["alive"]))
        actions = [h["action"] for h in fleet.autoscaler.summary()["history"]]
    finally:
        fleet.drain()
        flags.set_flags({"FLAGS_health": False,
                         "FLAGS_health_interval_s": 1.0})
    return W._tokens(hs), trail, actions


@pytest.mark.parametrize("what", ["spec", "lora", "tier_f32", "tier_int8",
                                  "migration", "fleet", "fleet_disagg",
                                  "fleet_autoscale"])
def test_mesh1_extras_bit_identical_with_counter_parity(one_rank, what):
    """Each extra on a mesh of one rank (its collectives over a group of
    one) gives what no mesh gives: the same tokens, sampled ones
    included, and the same serving counters."""
    from paddle_tpu_torch.profiler import counters
    mesh, (model, draft) = one_rank
    outs = []
    for m in (None, mesh):
        before = counters.snapshot()
        got = _scenario(what, m, model, draft)
        d = counters.delta(before)
        outs.append((got, {k: d.get(k, 0) for k in PARITY},
                     d.get("dist.collective_launches", 0)))
    (t0, c0, n0), (t1, c1, n1) = outs
    assert t0 == t1 and c0 == c1
    assert n0 == 0 and n1 > 0
    if what == "fleet_autoscale":
        # the autoscaler ticked on the mesh as without one
        assert t1[2] == ["grow_prefill", "retire"]
        assert c1["serving.autoscale.spawns"] == 1
