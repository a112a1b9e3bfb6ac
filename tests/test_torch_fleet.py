"""The serving fleet of the PyTorch port against the JAX package's.

Both packages run the same tiny GPT (vocab 64, hidden 32, 2 layers, 4
heads, ``max_seq_len`` 64, fp32, weights carried by
``load_numpy_state``) behind ``ServingFleet`` with block size 8, on one
stream of requests, with ``threaded=False`` and :meth:`pump` so every
schedule reproduces exactly.  Compared exactly (tokens and counters are
integers):

* the Router: least-outstanding-tokens dispatch with its tie-break, the
  ``RetryAfter`` fields of a backpressure refusal and an SLO shed
  (speculative tokens/s re-anchoring included), the health actions
  (critical refuses, degraded tightens, replays pass, role filter with
  unified fallback) over the fakes of ``tests/test_disagg.py``, and the
  ``router_queue`` fault;
* unified, disaggregated (prefill_replicas=1), speculative and int8-KV
  fleets: greedy tokens equal the JAX fleet's, finish reasons and the
  ``serving.fleet.*`` / ``serving.fleet.migrate.*`` counter deltas equal
  JAX's, every pool reconciles (free + live == capacity); sampled
  requests equal one port engine's with the same seeds (the two packages'
  random streams differ);
* chaos: ``replica_crash``, ``decode_stall`` (the stall detector driven by
  setting the hung replica's heartbeat back, not by sleeping),
  ``kv_migrate_drop``, migrations held under decode backpressure and
  ``HostTierLost`` on export give JAX's finish reasons and counters with
  zero lost, and LoRA tenants registered fleet-wide are replayed into a
  respawned replica;
* the autoscaler: ``disaggregate`` on an ITL burn then the alert
  resolves, ``grow_prefill`` spawns then ``retire``, inert with
  ``FLAGS_health`` off — the health plane ticked at explicit times and
  fed latency samples far above anything the CPU produces (100 s against
  a 10 s objective), so only the injected burn can fire;
* one threaded two-replica fleet completes and drains inside a timeout.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.profiler import flight as jflight
from paddle_tpu.profiler import health as jhealth
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.resilience import faultinject as jfi
from paddle_tpu.serving import RetryAfter as JRetryAfter
from paddle_tpu.serving import Router as JRouter
from paddle_tpu.serving import ServingFleet as JFleet
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.profiler import flight as tflight
from paddle_tpu_torch.profiler import health as thealth
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.resilience import faultinject as tfi
from paddle_tpu_torch.serving import (RetryAfter, Router, ServingFleet,
                                      random_lora_factors)

BS = 8
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64, initializer_range=0.3)
DRAFT = dict(CFG, hidden_size=16, num_layers=1, num_heads=2)
SIDES = {"jax": (JFleet, jcounters, jfi, jflags, jhealth, jmetrics,
                 jflight),
         "torch": (ServingFleet, tcounters, tfi, tflags, thealth, tmetrics,
                   tflight)}


def _pair(cfg, seed):
    paddle.seed(seed)
    jm = JGPT(JConfig(use_flash_attention=False, **cfg))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_numpy_state({k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return {"jax": jm, "torch": tm}


@pytest.fixture(scope="module")
def models():
    return _pair(CFG, 31), _pair(DRAFT, 7)


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path):
    for fl in (jflight, tflight):
        fl.configure(directory=str(tmp_path))
    yield
    for fl in (jflight, tflight):
        fl.clear()


def _kw(**kw):
    base = dict(replicas=2, threaded=False, max_slots=2, max_seq_len=64,
                min_bucket=4, queue_size=16, heartbeat_timeout_s=30.0,
                kv_layout="paged", block_size=BS, n_blocks=128,
                prefill_chunk=16)
    base.update(kw)
    return base


def _prompts(seed, sizes=(24, 9, 40, 17)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=n).tolist() for n in sizes]


def _moved(counters, before, prefixes=("serving.fleet.",)):
    """Counter (not gauge) movement under ``prefixes`` since ``before``."""
    return {k: v for k, v in counters.delta(before).items()
            if k.startswith(prefixes) and k not in counters._GAUGES}


def _reconciles(fleet):
    for rep in fleet._alive():
        pool = getattr(rep.engine, "pool", None)
        if pool is None:
            continue                    # slot layout: no block pool
        live = sum(1 for b in range(1, len(pool._ref)) if pool._ref[b] > 0)
        if len(pool._free) + live != pool.capacity:
            return False
    return True


def _serve(side, models, prompts, kw, max_new=8, schedule=None,
           seeds=None, hook=None, tenants=None, **submit_kw):
    """Submit ``prompts`` to a fresh fleet of ``side`` and pump it to the
    end (under ``schedule``); ``hook(fleet, handles, fi)`` runs once after
    the first pump; ``tenants[i]`` names request i's LoRA tenant (each
    registered fleet-wide first).  Returns tokens, finish reasons,
    retries, the fleet counter movement, whether the pools reconcile and
    the fleet."""
    Fleet, counters, fi, *_ = SIDES[side]
    (tm, dm) = models
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft_model"] = dm[side]
    fleet = Fleet(tm[side], **kw)
    tenants = tenants or [None] * len(prompts)
    for i, t in enumerate(sorted({t for t in tenants if t is not None})):
        fleet.register_adapter(t, random_lora_factors(
            GPTConfig(**CFG), 3, seed=i + 1, scale=1.0))
    before = counters.snapshot()
    fi.set_schedule(schedule)
    try:
        hs = [fleet.submit(p, max_new_tokens=max_new,
                           seed=i if seeds is None else seeds[i],
                           adapter=tenants[i], **submit_kw)
              for i, p in enumerate(prompts)]
        fleet.pump()
        if hook is not None:
            hook(fleet, hs, fi)
        fleet.join(hs, timeout_s=120)
        fired = sorted(fi.fired)
    finally:
        fi.clear()
    ok = _reconciles(fleet)
    fleet.drain()
    return {"tokens": [list(map(int, h.tokens)) for h in hs],
            "reasons": [h.finish_reason for h in hs],
            "retries": [h.retries for h in hs],
            "moved": _moved(counters, before),
            "fired": fired, "reconciles": ok}, fleet


def _both(models, prompts, kw, **serve_kw):
    out = {s: _serve(s, models, prompts, kw, **serve_kw)[0] for s in SIDES}
    assert out["torch"] == out["jax"]
    rec = out["torch"]
    assert rec["reconciles"]
    assert rec["moved"].get("serving.fleet.lost", 0) == 0
    return rec


# -- the Router --------------------------------------------------------------
class _FakeHealth:
    def __init__(self, level):
        self.level = level

    def admission_level(self):
        return self.level


class _FakeEngine:
    queue_size = 4

    def __init__(self, outstanding=10, queued=0, tps=1000.0, **extra):
        self.st = dict(closed=False, queued=queued,
                       outstanding_tokens=outstanding, decode_tps_ema=tps,
                       **extra)

    def stats(self):
        return dict(self.st)

    def prefix_peek(self, prompt, tenant=None):
        return 0


class _FakeReplica:
    def __init__(self, idx, role=None, **st):
        self.idx = idx
        self.role = role
        self.engine = _FakeEngine(**st)


@pytest.fixture
def health_on():
    for f in (jflags, tflags):
        f.set_flags({"FLAGS_health": True, "FLAGS_health_interval_s": 0.0})
    yield
    for f in (jflags, tflags):
        f.set_flags({"FLAGS_health": False, "FLAGS_health_interval_s": 1.0})


ROUTERS = {"jax": (JRouter, JRetryAfter, jcounters),
           "torch": (Router, RetryAfter, tcounters)}


def _route(reps, level=None, **pick_kw):
    """Pick on both routers: the chosen index, or the RetryAfter's
    fields, and the shed counters moved."""
    out = {}
    for name, (R, RA, counters) in ROUTERS.items():
        router = R(slo_margin=1.0, degraded_factor=10.0)
        if level is not None:
            router.health = _FakeHealth(level)
        before = counters.snapshot()
        try:
            res = router.pick(reps, **pick_kw).idx
        except RA as e:
            res = (e.reason, e.queue_depth, e.retry_after_hint, str(e))
        out[name] = (res, counters.delta(before))
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_router_least_outstanding_dispatch_and_backpressure():
    reps = [_FakeReplica(0, outstanding=30), _FakeReplica(1, outstanding=10),
            _FakeReplica(2, outstanding=10), _FakeReplica(3, outstanding=50)]
    assert _route(reps, est_tokens=4)[0] == 1          # tie: lowest index
    reps[1].engine.st["queued"] = 4                   # full queue: skipped
    assert _route(reps, est_tokens=4)[0] == 2
    full = [_FakeReplica(i, queued=4, outstanding=40 + i) for i in range(3)]
    res, moved = _route(full, est_tokens=4)
    assert res[:3] == ("backpressure", 4, 0.04) and moved == {}


@pytest.mark.parametrize("extra", [{}, {"spec_acceptance_ema": 0.5,
                                        "spec_yield_ema": 2.0,
                                        "spec_k": 4}])
def test_router_slo_shed_fields(extra):
    reps = [_FakeReplica(0, outstanding=500, tps=100.0, **extra)]
    res, moved = _route(reps, est_tokens=100, deadline_s=1.0)
    assert res[0] == "slo" and moved == {"serving.fleet.shed": 1}
    assert _route(reps, est_tokens=100, deadline_s=60.0)[0] == 0


def test_router_health_actions(health_on):
    rep = [_FakeReplica(0)]
    assert _route(rep, level="critical", est_tokens=4)[0][0] == "health"
    assert _route(rep, level="critical", est_tokens=4, shed=False)[0] == 0
    assert _route(rep, level="ok", est_tokens=10, deadline_s=0.05)[0] == 0
    assert _route(rep, level="degraded", est_tokens=10,
                  deadline_s=0.05)[0][0] == "slo"
    pre, dec, uni = (_FakeReplica(0, "prefill"), _FakeReplica(1, "decode"),
                     _FakeReplica(2))
    assert _route([pre, dec], role="decode")[0] == 1
    assert _route([pre, uni], role="decode")[0] == 2
    assert _route([pre], role="decode")[0] == 0


def test_router_health_off_changes_nothing():
    assert _route([_FakeReplica(0)], level="critical", est_tokens=4)[0] == 0


def test_router_queue_fault_sheds_as_jax(models):
    out = {}
    for side, (Fleet, counters, fi, *_) in SIDES.items():
        fleet = Fleet(models[0][side], **_kw())
        before = counters.snapshot()
        with fi.fault_schedule("router_queue@1"):
            h0 = fleet.submit([1, 2, 3], max_new_tokens=2, seed=0)
            with pytest.raises(RetryAfter if side == "torch"
                               else JRetryAfter) as ei:
                fleet.submit([4, 5, 6], max_new_tokens=2, seed=1)
        fleet.join([h0])
        fleet.drain()
        out[side] = (ei.value.reason, ei.value.retry_after_hint,
                     _moved(counters, before))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == "router_queue"


# -- fleets without faults -----------------------------------------------------
@pytest.mark.parametrize("kind", ["unified", "disagg", "spec", "int8"])
def test_fleet_greedy_equals_jax(models, kind):
    kw = {"unified": _kw(), "disagg": _kw(prefill_replicas=1),
          "spec": _kw(prefill_replicas=1, draft=True, spec_k=3),
          "int8": _kw(prefill_replicas=1, kv_dtype="int8")}[kind]
    rec = _both(models, _prompts(0), kw)
    assert rec["reasons"] == ["length"] * 4
    if kind != "unified":
        assert rec["moved"]["serving.fleet.migrate.requests"] == 4


def test_fleet_migration_blocks_and_stats_equal_jax(models):
    """Blocks copied + shared equal the blocks the requests owned; the
    roll-ups ``stats()`` publishes have JAX's keys and latency counts."""
    prompts = _prompts(2, (24, 24, 17))
    prompts[1][:16] = prompts[0][:16]          # a shared 2-block prefix
    out = {}
    for side in SIDES:
        rec, fleet = _serve(side, models, prompts, _kw(prefill_replicas=1),
                            hook=None)
        st = fleet.stats()
        out[side] = (rec, sorted(st), sorted(st["kv"]), st["roles"],
                     {k: v["count"] for k, v in st["latency"].items()})
    assert out["torch"] == out["jax"]
    moved = out["torch"][0]["moved"]
    owned = sum(-(-len(p) // BS) for p in prompts)
    assert (moved["serving.fleet.migrate.blocks_copied"]
            + moved["serving.fleet.migrate.blocks_shared"]) == owned
    assert moved["serving.fleet.migrate.blocks_shared"] == 2


def test_fleet_sampled_equals_one_port_engine(models):
    """Sampled requests on a disaggregated port fleet (the migration
    carries each request's generator) equal one port engine's with the
    same seeds."""
    prompts = _prompts(1)
    rec, _ = _serve("torch", models, prompts, _kw(prefill_replicas=1),
                    do_sample=True, temperature=0.8, top_k=20)
    eng = LLMEngine(models[0]["torch"], kv_layout="paged", max_slots=2,
                    max_seq_len=64, min_bucket=4, block_size=BS,
                    prefill_chunk=16)
    hs = [eng.add_request(p, max_new_tokens=8, seed=i, do_sample=True,
                          temperature=0.8, top_k=20)
          for i, p in enumerate(prompts)]
    while not all(h.is_finished for h in hs):
        eng.step()
    assert rec["tokens"] == [list(map(int, h.tokens)) for h in hs]


# -- chaos ---------------------------------------------------------------------
def test_replica_crash_and_stall_as_jax(models):
    """One replica crashes on request 0, the other hangs on request 1;
    the stall detector trips once the hung replica's heartbeat is set
    back past the timeout.  Both retry once and finish ``length`` with
    the unfaulted tokens."""
    def stall(fleet, hs, fi):
        fleet.pump()
        hung = [r for r in fleet._alive() if r.hung]
        assert len(hung) == 1
        hung[0].last_beat -= fleet.heartbeat_timeout_s + 1.0

    prompts = _prompts(3, (5, 6))
    kw = _kw(kv_layout="slots", max_slots=1, warm_buckets=(5,))
    clean = _both(models, prompts, kw, max_new=6)
    rec = _both(models, prompts, kw, max_new=6, hook=stall,
                schedule="replica_crash@0;decode_stall@1")
    assert rec["tokens"] == clean["tokens"]
    assert rec["retries"] == [1, 1]
    m = rec["moved"]
    assert (m["serving.fleet.replica_deaths.crash"],
            m["serving.fleet.replica_deaths.stall"],
            m["serving.fleet.respawns"], m["serving.fleet.heartbeat_misses"],
            m["serving.fleet.retried"]) == (1, 1, 2, 1, 2)


def test_crash_on_disaggregated_fleet_as_jax(models):
    rec = _both(models, _prompts(8), _kw(prefill_replicas=1, max_retries=2),
                schedule="replica_crash@0")
    assert rec["moved"]["serving.fleet.replica_deaths"] == 1
    assert rec["reasons"] == ["length"] * 4


def test_adapter_registry_replayed_into_respawn_as_jax(models):
    """Tenant requests on a fleet whose replica crashes: the respawned
    replica gets every fleet-registered tenant before it joins dispatch,
    so the retried tenant requests finish with the unfaulted tokens."""
    prompts = _prompts(6)
    kw = _kw(adapter_slots=2, adapter_rank=3)
    tenants = ["t1", None, "t2", "t1"]
    clean = _both(models, prompts, kw, tenants=tenants)
    rec = _both(models, prompts, kw, tenants=tenants,
                schedule="replica_crash@0")
    assert rec["tokens"] == clean["tokens"]
    assert rec["moved"]["serving.fleet.respawns"] == 1
    assert rec["reasons"] == ["length"] * 4


def test_kv_migrate_drop_replays_as_jax(models):
    prompts = _prompts(7)
    clean = _both(models, prompts, _kw(prefill_replicas=1))
    rec = _both(models, prompts, _kw(prefill_replicas=1, max_retries=2),
                schedule="kv_migrate_drop@0,kv_migrate_drop@2")
    assert rec["tokens"] == clean["tokens"]
    assert rec["moved"]["serving.fleet.migrate.dropped"] == 2
    assert rec["moved"]["serving.fleet.retried"] == 2


def test_held_migrations_deferred_as_jax(models):
    """Six prefilled requests against two decode slots: the overflow
    hand-offs park on the source and complete later, no retry spent."""
    rec = _both(models, _prompts(3, (24, 9, 40, 17, 12, 30)),
                _kw(prefill_replicas=1))
    assert rec["moved"]["serving.fleet.migrate.deferred"] > 0
    assert rec["retries"] == [0] * 6


def test_host_tier_lost_on_export_as_jax(models):
    """Held requests spilled to the prefill replica's host tier while
    their migration waits; ``kv_spill_drop`` on one makes its export
    raise ``HostTierLost``: the migration is dropped and the request
    replays by re-prefill, nothing lost."""
    prompts = _prompts(5, (24, 9, 40, 17, 12, 30))
    kw = _kw(prefill_replicas=1, host_kv_blocks=32, spill_idle_steps=1,
             max_retries=2)
    clean = _both(models, prompts, kw)
    rec = _both(models, prompts, kw, schedule="kv_spill_drop@3")
    assert rec["fired"] == [("kv_spill_drop", 3)]
    assert rec["moved"]["serving.fleet.migrate.dropped"] == 1
    assert rec["tokens"] == clean["tokens"]


# -- the autoscaler -------------------------------------------------------------
def _drive_autoscale(side, models, kw, hist, pattern, submit_at=(0,)):
    """A fleet whose health plane is ticked only here, at t = 0, 1, 2...;
    ``pattern[t]`` says whether to feed 40 samples of 100 s into ``hist``
    before tick t.  Requests are submitted before the ticks in
    ``submit_at`` and served to the end between ticks."""
    Fleet, counters, _, flags, health, metrics, _ = SIDES[side]
    slo = health.SLO(hist.split(".")[1].replace("_ns", "") + "_burn",
                     ("hist_p95", hist), 1e10, windows=((1.0, 1.0),),
                     min_count=4)
    fleet = Fleet(models[0][side], **kw, autoscale=True,
                  health_kw=dict(rules=[slo]))
    fleet.health.maybe_tick = lambda now=None: None   # ticked below only
    before = counters.snapshot()
    prompts = _prompts(9, (24, 9, 17))
    trail, hs = [], []
    for t, burn in enumerate(pattern):
        if t in submit_at:
            hs += [fleet.submit(p, max_new_tokens=6, seed=i)
                   for i, p in enumerate(prompts)]
            fleet.join(hs)
        if burn:
            h = metrics.get_histogram(hist, "ns")
            for _ in range(40):
                h.record(1e11)
        fleet.health.tick(now=float(t))
        fleet.pump()
        st = fleet.stats()
        trail.append((sorted(fleet.health.firing_names()),
                      (st["roles"], st["alive"])))
    fleet.join(hs)
    history = fleet.autoscaler.summary()["history"]
    fleet.drain()
    moved = _moved(counters, before, ("serving.autoscale.", "health.alerts.",
                                      "serving.fleet.lost"))
    return trail, history, moved, [h.finish_reason for h in hs]


def _autoscale_both(models, kw, hist, pattern, **drive_kw):
    out = {s: _drive_autoscale(s, models, kw, hist, pattern, **drive_kw)
           for s in SIDES}
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_autoscaler_disaggregates_on_itl_burn_then_resolves(models,
                                                            health_on):
    trail, history, moved, reasons = _autoscale_both(
        models, _kw(autoscale_kw=dict(cooldown_ticks=1, ok_streak=100)),
        "serving.itl_ns", [False, True, False, False], submit_at=(0, 3))
    assert [h["action"] for h in history] == ["disaggregate"]
    assert trail[1][0] == ["itl_burn"] and trail[-1][0] == []
    assert trail[-1][1][0] == {"prefill": 1, "decode": 1, "unified": 0}
    assert moved["serving.autoscale.flips.to_prefill"] == 1
    assert moved["health.alerts.resolved.itl_burn"] == 1
    assert reasons == ["length"] * 6


def test_autoscaler_grows_prefill_then_retires(models, health_on):
    trail, history, moved, reasons = _autoscale_both(
        models, _kw(prefill_replicas=1,
                    autoscale_kw=dict(cooldown_ticks=0, ok_streak=2,
                                      max_replicas=3)),
        "serving.ttft_ns", [False, True, False, False, False, False])
    assert [h["action"] for h in history] == ["grow_prefill", "retire"]
    assert trail[1][1] == ({"prefill": 2, "decode": 1, "unified": 0}, 3)
    assert trail[-1][1] == ({"prefill": 1, "decode": 1, "unified": 0}, 2)
    assert (moved["serving.autoscale.spawns"],
            moved["serving.autoscale.retires"]) == (1, 1)


def test_autoscaler_inert_with_health_off(models):
    """The burn fires (ticks are forced here), yet with ``FLAGS_health``
    off ``maybe_scale`` acts on nothing: no autoscale counter moves and
    the fleet stays unified."""
    trail, history, moved, _ = _autoscale_both(
        models, _kw(), "serving.itl_ns", [False, True, True])
    assert trail[1][0] == ["itl_burn"]
    assert history == []
    assert not any(k.startswith("serving.autoscale.") for k in moved)
    assert trail[-1][1] == ({"prefill": 0, "decode": 0, "unified": 2}, 2)


# -- threaded ------------------------------------------------------------------
def test_threaded_fleet_completes_and_drains(models):
    """One worker thread per replica plus the monitor: the stream
    completes inside the join's timeout with the unthreaded fleet's
    tokens, and drain stops every thread."""
    prompts = _prompts(4)
    want, _ = _serve("torch", models, prompts, _kw(prefill_replicas=1))
    fleet = ServingFleet(models[0]["torch"],
                         **_kw(prefill_replicas=1, threaded=True))
    before = tcounters.snapshot()
    hs = [fleet.submit(p, max_new_tokens=8, seed=i)
          for i, p in enumerate(prompts)]
    fleet.join(hs, timeout_s=60)
    fleet.drain()
    assert [list(map(int, h.tokens)) for h in hs] == want["tokens"]
    assert not any(r.thread.is_alive() for r in fleet._replicas)
    assert not fleet._monitor_thread.is_alive()
    moved = _moved(tcounters, before)
    assert moved.get("serving.fleet.lost", 0) == 0
    assert moved.get("serving.fleet.monitor_errors", 0) == 0
    assert moved["serving.fleet.migrate.requests"] == 4
