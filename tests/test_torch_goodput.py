"""The port's goodput ledger (``profiler.goodput``) against the JAX
package's, on a scripted clock: each ledger reads
``time.perf_counter_ns`` from the same list of instants, runs the same
nesting of buckets, and must report the same buckets, fractions and
gauges, exactly (integers of nanoseconds; the fractions are the same
float divisions).  Then each package's ``goodput_accounted`` watchdog is
fed by its own ledger's published gauges and must fire and abstain at
the same ticks.  Both registries' ``goodput.*`` gauges are reset at the
end (the JAX health tests read the same names).
"""

import time

import pytest

from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.profiler import flight as jflight
from paddle_tpu.profiler import goodput as jgoodput
from paddle_tpu.profiler import health as jhealth
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.profiler import flight as tflight
from paddle_tpu_torch.profiler import goodput as tgoodput
from paddle_tpu_torch.profiler import health as thealth

SIDES = {"jax": (jgoodput, jcounters, jhealth, jflight),
         "torch": (tgoodput, tcounters, thealth, tflight)}


@pytest.fixture(autouse=True)
def _gauges(tmp_path):
    for name, (_, _, _, flight) in SIDES.items():
        flight.configure(directory=str(tmp_path / name))
    yield
    for _, counters, _, flight in SIDES.values():
        for k in [k for k in counters.snapshot() if k.startswith("goodput.")]:
            counters.set_gauge(k, 0)
        flight.clear()


def _scripted(monkeypatch, instants):
    it = iter(instants)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(it))


def _scenario(goodput, idle_gap):
    """start, compile 100, a step of 50 with a nested ckpt_sync of 30,
    an added restore_replay of 7, a custom bucket of 5, ``idle_gap`` ns
    unattributed, stop."""
    led = goodput.GoodputLedger().start()            # t = 0
    with led.bucket("compile"):                      # 0 .. 100
        pass
    with led.bucket("step"):                         # 100 .. 180
        with led.bucket("ckpt_sync"):                # 120 .. 150
            pass
    led.add("restore_replay", 7)
    with led.bucket("custom"):                       # 180 .. 185
        pass
    led.stop()                                       # 185 + idle_gap
    return led


def _instants(idle_gap):
    return [0, 0, 100, 100, 120, 150, 180, 180, 185, 185 + idle_gap]


@pytest.mark.parametrize("idle_gap", [0, 1, 400])
def test_ledger_buckets_and_gauges_equal_jax(monkeypatch, idle_gap):
    out = {}
    for name, (goodput, counters, _, _) in SIDES.items():
        _scripted(monkeypatch, _instants(idle_gap) + [10 ** 6])
        led = _scenario(goodput, idle_gap)
        report = led.report(publish=True)
        gauges = {k: v for k, v in counters.snapshot().items()
                  if k.startswith("goodput.")}
        out[name] = (report, gauges, repr(led))
    assert out["torch"] == out["jax"]
    report = out["torch"][0]
    assert report["buckets_ns"]["step"] == 50      # the child is excluded
    assert report["buckets_ns"]["ckpt_sync"] == 30
    assert report["buckets_ns"]["custom"] == 5
    # attributed 192 ns (the added 7 included) against a wall of 185 +
    # idle_gap: unattributed time, if any, is folded into idle
    assert report["accounted"] == min(1.0, 192 / (185 + idle_gap))
    assert report["buckets_ns"]["idle"] == max(0, idle_gap - 7)
    assert report["goodput"] == 50 / (185 + idle_gap)


def test_unstarted_ledger_as_jax():
    out = {name: (repr(g.GoodputLedger()), g.GoodputLedger().wall_ns(),
                  g.BUCKETS)
           for name, (g, *_) in SIDES.items()}
    assert out["torch"] == out["jax"]


def test_goodput_watchdog_reads_the_ledger_as_jax(monkeypatch):
    """Abstains before any report, stays quiet on a closed ledger (idle
    gap 1: everything attributed), fires on a leaky one (gap 400: 192 of
    585 ns attributed), and resolves when a closed report comes back."""
    trails = {}
    for name, (goodput, counters, health, _) in SIDES.items():
        counters.set_gauge("goodput.wall_ns", 0)
        mon = health.HealthMonitor(rules=[
            r for r in health.default_rules()
            if r.name == "goodput_accounted"])
        trail = []
        for t, gap in enumerate((None, 1, 400, 1)):
            if gap is not None:
                _scripted(monkeypatch, _instants(gap) + [10 ** 6])
                _scenario(goodput, gap).report(publish=True)
            before = counters.snapshot()
            mon.tick(now=float(t))
            trail.append((sorted(a.name for a in mon.firing()),
                          {k: v for k, v in counters.delta(before).items()
                           if k.startswith("health.alerts.")}))
        trails[name] = trail
    assert trails["torch"] == trails["jax"]
    assert [names for names, _ in trails["torch"]] == [
        [], [], ["goodput_accounted"], []]
