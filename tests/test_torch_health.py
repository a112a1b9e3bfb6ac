"""The port's health plane against the JAX package's.

Both ``HealthMonitor``\\ s are fed the same synthetic windows — counter
movement, gauges, histogram samples, device-time samples and attached
block pools, applied to each package's own registries — and ticked at
the same explicit times (``tick(now=...)``; no test waits on the wall
clock).  After every tick the firing rule names, the admission level and
the ``health.alerts.fired.*`` / ``.resolved.*`` counter movement must be
the same in both, exactly.  The scenarios cover the burn-rate SLOs (both
windows, min_count abstention, the ratio and callable signals), every
default watchdog (the noisy-neighbour rule over per-tenant ITL
histograms, the device-time regression over the ledger; MFU collapse
abstains in both for want of program FLOPs), dedupe while firing, refire
after a resolve, the flight bundle written on a fire, and the plane's
zero-movement off path.
"""

import numpy as np
import pytest

from paddle_tpu.core import flags as jflags
from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.profiler import devicetime as jdevicetime
from paddle_tpu.profiler import flight as jflight
from paddle_tpu.profiler import health as jhealth
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.serving.kvcache import BlockPool as JPool
from paddle_tpu.serving.kvcache import HostKVTier as JTier
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.profiler import devicetime as tdevicetime
from paddle_tpu_torch.profiler import flight as tflight
from paddle_tpu_torch.profiler import health as thealth
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.serving.kvcache import BlockPool as TPool
from paddle_tpu_torch.serving.kvcache import HostKVTier as TTier

SIDES = {"jax": (jflags, jcounters, jmetrics, jhealth, jflight, jdevicetime,
                 JPool, JTier),
         "torch": (tflags, tcounters, tmetrics, thealth, tflight, tdevicetime,
                   TPool, TTier)}


@pytest.fixture(autouse=True)
def _plane(tmp_path):
    for name, (flags, _, _, _, flight, devicetime, *_) in SIDES.items():
        flags.set_flags({"FLAGS_health": True,
                         "FLAGS_health_interval_s": 0.0})
        flight.configure(directory=str(tmp_path / name))
        devicetime.reset()
    yield
    for flags, _, _, _, flight, devicetime, *_ in SIDES.values():
        flags.set_flags({"FLAGS_health": False,
                         "FLAGS_health_interval_s": 1.0})
        flight.clear()
        devicetime.reset()


class _Holder:
    """What a watchdog probes on an attached engine: its pool and tier."""

    def __init__(self, pool, tier=None):
        self.pool = pool
        self._host_tier = tier


def _apply(step, counters, metrics, devicetime, holders):
    for k, v in step.get("inc", {}).items():
        counters.inc(k, v)
    for k, v in step.get("gauge", {}).items():
        counters.set_gauge(k, v)
    for k, vals in step.get("hist", {}).items():
        h = metrics.get_histogram(k, "ns")
        for v in vals:
            h.record(v)
    for k, vals in step.get("dt", {}).items():
        for v in vals:
            devicetime._record_sample(k, v)
    if "pool" in step:
        step["pool"](holders)


def _run(side, rules_of, steps, attach_tier=False):
    """Run ``steps`` (one ``(now, step)`` a tick) on one package; returns
    per tick ``(firing names, admission level, fired/resolved deltas)``
    and the monitor."""
    (_, counters, metrics, health, flight, devicetime, Pool,
     Tier) = SIDES[side]
    holders = {"pool": Pool(n_blocks=8, block_size=4)}
    if attach_tier:
        holders["tier"] = Tier(4)
    mon = health.HealthMonitor(rules=rules_of(health))
    mon.attach(_Holder(holders["pool"], holders.get("tier")))
    trail = []
    for now, step in steps:
        _apply(step, counters, metrics, devicetime, holders)
        before = counters.snapshot()
        mon.tick(now=now)
        moved = {k: v for k, v in counters.delta(before).items()
                 if k.startswith("health.alerts.")}
        trail.append((sorted(a.name for a in mon.firing()),
                      mon.admission_level(), moved))
    return trail, mon


def _both(rules_of, steps, **kw):
    out = {s: _run(s, rules_of, steps, **kw)[0] for s in SIDES}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _default(health):
    return health.default_rules()


def _rule(name):
    return lambda health: [r for r in health.default_rules()
                           if r.name == name]


def _tick(t, **step):
    return (float(t), step)


# -- SLOs --------------------------------------------------------------------
def test_itl_burn_fires_dedupes_resolves_and_refires():
    slow = {"serving.itl_ns": [50e6] * 20}       # 3.3x the 15 ms objective
    fast = {"serving.itl_ns": [1e6] * 30}
    steps = ([_tick(0)] + [_tick(t, hist=slow) for t in (1, 2, 3)]
             + [_tick(t, hist=fast) for t in range(4, 80, 5)]
             + [_tick(t, hist=slow) for t in (81, 82)])
    trail = _both(_rule("itl_burn"), steps)
    fired = [t for t, (_, _, m) in enumerate(trail)
             if m.get("health.alerts.fired.itl_burn")]
    resolved = [t for t, (_, _, m) in enumerate(trail)
                if m.get("health.alerts.resolved.itl_burn")]
    assert len(fired) == 2 and len(resolved) == 1    # dedupe, one refire
    assert trail[1][:2] == (["itl_burn"], "critical")
    assert trail[-1][0] == ["itl_burn"]


@pytest.mark.parametrize("hist", ["serving.ttft_ns", "serving.queue_wait_ns"])
def test_latency_slos_need_every_window(hist):
    """A blip burns the fast window only; a sustained burn fires."""
    rule = {"serving.ttft_ns": "ttft_burn",
            "serving.queue_wait_ns": "queue_wait_burn"}[hist]
    clean = {hist: [1e6] * 5}
    steps = ([_tick(t, hist=clean) for t in range(0, 70, 2)]
             + [_tick(71, hist={hist: [2e9] * 5})]
             + [_tick(t, hist={hist: [2e9] * 40}) for t in range(72, 140, 4)])
    trail = _both(_rule(rule), steps)
    assert trail[35][0] == []                  # the blip: slow window clean
    assert trail[-1][0] == [rule]


def test_shed_and_error_rate_slos():
    steps = [_tick(0),
             _tick(1, inc={"serving.fleet.dispatched": 100,
                           "serving.fleet.shed": 2,
                           "serving.requests": 100}),
             _tick(2, inc={"serving.fleet.dispatched": 50,
                           "serving.fleet.shed": 40,
                           "serving.requests": 50,
                           "serving.request_errors": 9}),
             _tick(70, inc={"serving.fleet.dispatched": 500,
                            "serving.requests": 500}),
             _tick(140, inc={"serving.fleet.dispatched": 500,
                             "serving.requests": 500})]
    trail = _both(lambda h: [r for r in h.default_rules()
                             if r.name in ("shed_rate", "error_rate")],
                  steps)
    assert trail[2][0] == ["error_rate", "shed_rate"]
    assert trail[-1][0] == []


# -- watchdogs ---------------------------------------------------------------
def _corrupt_pool(holders):
    b = holders["pool"].alloc()
    holders["pool"]._free.append(b)


def _fill_tier(holders):
    tier = holders["tier"]
    for i in range(4):
        tier.put(("k", i), [np.zeros(2, np.float32)])


@pytest.mark.parametrize("rule,steps,fires_at", [
    ("retrace_storm", [_tick(0), _tick(1),
                       _tick(2, inc={"serving.retraces": 1}),
                       _tick(30)], 2),
    ("kv_conservation", [_tick(0), _tick(1), _tick(2, pool=_corrupt_pool)],
     2),
    ("kv_backpressure", [_tick(0), _tick(1),
                         _tick(2, inc={"serving.kv.pool_exhausted": 1}),
                         _tick(30)], 2),
    ("kv_spill_burn", [_tick(0),
                       _tick(1, inc={"serving.kv.tier.spilled_blocks": 4}),
                       _tick(3, inc={"serving.kv.tier.spilled_blocks": 12}),
                       _tick(60)], 2),
    ("kv_tier_occupancy", [_tick(0), _tick(1), _tick(2, pool=_fill_tier)],
     2),
    ("goodput_accounted", [_tick(0, gauge={"goodput.wall_ns": 0,
                                           "goodput.accounted": 0.5}),
                           _tick(1),
                           _tick(2, gauge={"goodput.wall_ns": 1e9,
                                           "goodput.accounted": 0.999}),
                           _tick(3, gauge={"goodput.accounted": 0.5}),
                           _tick(4, gauge={"goodput.wall_ns": 0})], 3),
    ("spec_acceptance", [_tick(0, gauge={"serving.spec.acceptance": 0.01}),
                         _tick(1),
                         _tick(2, inc={"serving.spec.drafted": 32}),
                         _tick(3, gauge={"serving.spec.acceptance": 0.8},
                               inc={"serving.spec.drafted": 32})], 2),
    ("prefetch_stall", [_tick(0), _tick(10, inc={"io.prefetch_stall_ns": 1e9}),
                        _tick(20, inc={"io.prefetch_stall_ns": 13e9}),
                        _tick(60)], 2),
    ("noisy_neighbor", [_tick(0),
                        _tick(1, hist={"serving.itl_ns.tenant.t1": [1e6] * 10,
                                       "serving.itl_ns.tenant.t2": [1e6] * 10,
                                       "serving.itl_ns.tenant.base":
                                       [1e6] * 10}),
                        _tick(2, hist={"serving.itl_ns.tenant.t1": [1e6] * 10,
                                       "serving.itl_ns.tenant.t2":
                                       [40e6] * 10,
                                       "serving.itl_ns.tenant.base":
                                       [1e6] * 10}),
                        _tick(40)], 2),
    ("device_time_regression", [
        _tick(0),
        _tick(1, dt={"serving.decode_paged": [1e-3] * 12}),
        _tick(2, dt={"serving.decode_paged": [5e-3] * 8}),
        _tick(3)], 2),
    ("mfu_collapse", [_tick(0),
                      _tick(1, dt={"serving.decode_paged": [1e-3] * 12}),
                      _tick(2)], None),
])
def test_watchdog_fires_and_resolves_as_jax(rule, steps, fires_at):
    trail = _both(_rule(rule), steps, attach_tier=rule == "kv_tier_occupancy")
    firing = [t for t, (names, _, _) in enumerate(trail) if names]
    if fires_at is None:
        assert firing == []
    else:
        assert firing and firing[0] == fires_at
        assert trail[fires_at][2].get(f"health.alerts.fired.{rule}") == 1


def test_default_rules_levels_and_flight_bundle(tmp_path):
    """The whole default rule set over one mixed scenario: the same
    levels tick by tick, and each side's flight bundle names the rule."""
    steps = [_tick(0),
             _tick(1, inc={"serving.kv.pool_exhausted": 2}),
             _tick(2, hist={"serving.itl_ns": [90e6] * 10}),
             _tick(40), _tick(100)]
    trail = _both(_default, steps)
    assert [lvl for _, lvl, _ in trail] == [
        "ok", "degraded", "critical", "ok", "ok"]
    for name, (*_, flight, _, _, _) in SIDES.items():
        bundles = sorted((tmp_path / name).glob("flight-health_*.json"))
        reasons = {flight.load(p)["reason"] for p in bundles}
        assert {"health_kv_backpressure", "health_itl_burn"} <= reasons


def test_health_off_moves_nothing():
    out = {}
    for name, (flags, counters, _, health, *_) in SIDES.items():
        flags.set_flags({"FLAGS_health": False})
        mon = health.HealthMonitor()
        before = counters.snapshot()
        out[name] = (mon.maybe_tick(now=5.0), mon.summary(),
                     counters.delta(before))
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == {}


def test_maybe_tick_cadence_and_summary():
    out = {}
    for name, (_, _, _, health, *_) in SIDES.items():
        mon = health.HealthMonitor(rules=[], interval_s=2.0)
        ticks = [mon.maybe_tick(now=t) is not None
                 for t in (0.0, 1.0, 2.5, 3.0, 4.6)]
        out[name] = (ticks, mon.summary(), mon.window(1.0).seconds,
                     sorted(mon.signals()))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [True, False, True, False, True]
