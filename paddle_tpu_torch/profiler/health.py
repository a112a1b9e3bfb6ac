"""Health plane: windowed telemetry signals, SLO burn-rate alerting and
live invariant watchdogs (port of ``paddle_tpu/profiler/health.py``).

* :class:`HealthMonitor` takes periodic immutable :class:`Snapshot`\\ s
  of the counter, gauge and histogram registries into a bounded ring and
  derives windowed deltas, rates and percentiles from any two of them
  (:class:`Window`; a histogram window is bucket-wise subtraction,
  :meth:`metrics.Histogram.delta`).
* :class:`SLO` — a multi-window burn-rate objective: it fires only when
  the signal exceeds ``burn x target`` over the fast window AND the slow
  one.  The defaults cover TTFT / inter-token / queue-wait p95, the shed
  rate and the error rate.
* :class:`Watchdog` — a live invariant: retrace storm, KV block
  conservation, pool-exhaustion backpressure, goodput accounting,
  speculative-acceptance collapse, host-tier spill burn and occupancy,
  noisy neighbour (per-tenant ITL), prefetch stall, MFU collapse and
  device-time regression (the last two read the device-time ledger and
  abstain while sampling is off).
* Alerts fire and resolve with dedupe (a firing rule never re-fires),
  tick ``health.*`` counters, write a flight-recorder bundle on each
  0->1 transition, and fold into one ``admission_level`` (``ok`` /
  ``degraded`` / ``critical``) that ``ServingFleet.stats()["health"]``
  and ``Router.stats()["health"]`` expose.  This module takes no action:
  the Router sheds on the level and the ``FleetAutoscaler`` flips and
  grows replica roles on the burn alerts.

``ServingFleet`` owns a monitor and ticks it from its monitor thread (or
every :meth:`pump` when not threaded); elsewhere::

    mon = HealthMonitor().attach(engine)
    mon.maybe_tick()        # from any periodic loop

On a serving fleet over a mesh of more than one rank, the monitor of
mesh rank 0 decides: it ticks inside the fleet's decision of each tick,
and its alerts feed the router's health actions (the pick is rank 0's)
and the autoscaler (rank 0 evaluates the policy, every rank applies its
action).  A rank above 0 ticks its own monitor for its own counters and
decides nothing from it.

With ``FLAGS_health`` off ``maybe_tick`` is one cached-bool check: no
snapshot, no ``health.*`` counter.  Time is the caller's: ``tick(now=)``
and ``maybe_tick(now=)`` take it explicitly (``time.monotonic()`` by
default).
"""

from __future__ import annotations

import collections
import threading
import time

from .. import flags as _flags
from . import counters as _counters
from . import flight as _flight
from . import metrics as _metrics

__all__ = ["SLO", "Watchdog", "Alert", "Snapshot", "Window",
           "HealthMonitor", "default_slos", "default_watchdogs",
           "default_rules", "enabled"]

# admission recommendation ladder (gauge value in parentheses)
LEVELS = ("ok", "degraded", "critical")

_ENABLED = [False]          # cached FLAGS_health — the one-bool off gate
_ACTIVE = [None]            # most recently ticked monitor (flight provider)


def enabled() -> bool:
    """Cached ``FLAGS_health`` value (one list-index read)."""
    return _ENABLED[0]


class Snapshot:
    """One immutable point-in-time copy of the telemetry registries."""

    __slots__ = ("ts", "tick", "counters", "hists")

    def __init__(self, ts, tick, counters, hists):
        self.ts = ts            # monotonic seconds
        self.tick = tick        # monitor tick index at capture
        self.counters = counters
        self.hists = hists      # {name: Histogram copy}


def take_snapshot(now=None, tick=0) -> Snapshot:
    if now is None:
        now = time.monotonic()
    return Snapshot(now, tick, _counters.snapshot(), _metrics.histograms())


class Window:
    """Derived movement between two snapshots of the same process.

    ``delta`` is counter-reset safe: a counter that shrank between the
    snapshots (``counters.reset`` ran) restarts its accounting from zero,
    so the window reports the post-reset value instead of a negative."""

    __slots__ = ("start", "end")

    def __init__(self, start: Snapshot, end: Snapshot):
        self.start = start
        self.end = end

    @property
    def seconds(self) -> float:
        return max(1e-9, self.end.ts - self.start.ts)

    def delta(self, name) -> float:
        after = self.end.counters.get(name, 0)
        d = after - self.start.counters.get(name, 0)
        return after if d < 0 else d

    def rate(self, name) -> float:
        """Counter movement per second over the window."""
        return self.delta(name) / self.seconds

    def gauge(self, name, default=None):
        """The gauge's value at the END of the window (point-in-time)."""
        return self.end.counters.get(name, default)

    def hist_delta(self, name):
        """Element-wise bucket movement of one histogram over the window
        (a fresh :class:`metrics.Histogram`), or None if never recorded."""
        cur = self.end.hists.get(name)
        if cur is None:
            return None
        prev = self.start.hists.get(name)
        if prev is None:
            return cur.copy()
        return cur.delta(prev)

    def percentile(self, name, q):
        """Windowed percentile of one histogram (None: no new samples)."""
        h = self.hist_delta(name)
        if h is None or h.count <= 0:
            return None
        return h.percentile(q)

    def summary(self) -> dict:
        """JSON-safe view of everything that moved (flight/alert context)."""
        moved = {}
        for k, v in self.end.counters.items():
            d = self.delta(k)
            if d:
                moved[k] = d
        p95 = {}
        for name in self.end.hists:
            h = self.hist_delta(name)
            if h is not None and h.count > 0:
                p95[name] = h.percentile(95)
        return {"seconds": self.seconds, "start_tick": self.start.tick,
                "end_tick": self.end.tick, "delta": moved, "p95": p95}


class Alert:
    """One rule's firing/resolved lifecycle record."""

    __slots__ = ("name", "kind", "severity", "state", "since", "last",
                 "resolved_at", "detail", "fired_count")

    def __init__(self, name, kind, severity, now, detail):
        self.name = name
        self.kind = kind
        self.severity = severity
        self.state = "firing"
        self.since = now
        self.last = now
        self.resolved_at = None
        self.detail = detail
        self.fired_count = 1

    def to_dict(self):
        return {"name": self.name, "kind": self.kind,
                "severity": self.severity, "state": self.state,
                "since": self.since, "last": self.last,
                "resolved_at": self.resolved_at,
                "fired_count": self.fired_count, "detail": self.detail}


class SLO:
    """Multi-window burn-rate objective over one windowed signal.

    ``signal`` is either a spec tuple —

    * ``("hist_p95", name)`` — p95 of the histogram's windowed delta
      (requires ``min_count`` new samples, else the window abstains);
    * ``("ratio", numerator, denominator)`` — counter-delta ratio, e.g.
      shed rate = shed / (dispatched + shed);
    * ``("rate", name)`` — counter movement per second;

    — or any callable ``f(window) -> float | None`` (None = abstain).

    ``target`` is the objective for the signal; the per-window **burn**
    is ``measured / target``.  ``windows`` is a tuple of
    ``(seconds, burn_threshold)`` pairs, fast first; the alert fires only
    when EVERY window's burn exceeds its threshold (the fast window says
    it is still happening, the slow window says it is sustained).  When
    the ring does not yet span a requested window the widest available
    span is used — a fresh monitor degrades to single-window alerting
    rather than staying blind."""

    kind = "slo"

    def __init__(self, name, signal, target,
                 windows=((5.0, 1.0), (60.0, 1.0)),
                 severity="critical", min_count=4):
        self.name = name
        self.signal = signal
        self.target = float(target)
        self.windows = tuple((float(s), float(b)) for s, b in windows)
        self.severity = severity
        self.min_count = int(min_count)

    def _measure(self, w: Window):
        sig = self.signal
        if callable(sig):
            return sig(w)
        kind = sig[0]
        if kind == "hist_p95":
            h = w.hist_delta(sig[1])
            if h is None or h.count < self.min_count:
                return None
            return h.percentile(95)
        if kind == "ratio":
            den = w.delta(sig[2])
            if den <= 0:
                return None
            return w.delta(sig[1]) / den
        if kind == "rate":
            return w.rate(sig[1])
        raise ValueError(f"unknown SLO signal spec {sig!r}")

    def status(self, monitor) -> dict:
        wins = []
        for seconds, burn_thr in self.windows:
            w = monitor.window(seconds)
            if w is None:
                wins.append({"seconds": seconds, "span_s": 0.0,
                             "value": None, "burn": None,
                             "threshold": burn_thr, "burning": False})
                continue
            val = self._measure(w)
            burn = None if val is None else val / self.target
            wins.append({"seconds": seconds, "span_s": w.seconds,
                         "value": val, "burn": burn,
                         "threshold": burn_thr,
                         "burning": burn is not None and burn > burn_thr})
        return {"name": self.name, "kind": self.kind,
                "signal": (self.signal if not callable(self.signal)
                           else getattr(self.signal, "__name__", "fn")),
                "target": self.target, "severity": self.severity,
                "windows": wins,
                "firing": bool(wins) and all(x["burning"] for x in wins)}

    def evaluate(self, monitor):
        st = self.status(monitor)
        return st["firing"], {"windows": st["windows"],
                              "target": self.target}


class Watchdog:
    """A live invariant: ``fn(window, monitor) -> (firing, detail)``.

    The window handed to ``fn`` spans ``window_s`` seconds best-effort
    (the widest available span when the ring is younger)."""

    kind = "watchdog"

    def __init__(self, name, fn, window_s=15.0, severity="degraded"):
        self.name = name
        self.fn = fn
        self.window_s = float(window_s)
        self.severity = severity

    def evaluate(self, monitor):
        w = monitor.window(self.window_s)
        if w is None:
            return False, {}
        return self.fn(w, monitor)


# -- default rule set --------------------------------------------------------
def _wd_retrace_storm(w, monitor):
    """Warm retrace storm: any ``serving.retraces`` / ``jit.traces``
    movement inside a window (the JAX package's program compiles; the
    port compiles no programs and moves neither, so the rule abstains
    there unless another component ticks them)."""
    retraces = w.delta("serving.retraces") + w.delta("jit.traces")
    return retraces > 0, {"retraces": retraces,
                          "window_s": w.seconds}


def _wd_kv_conservation(w, monitor):
    """Block conservation over every attached/fleet paged engine:
    ``free + live_refcounted == capacity`` and no block may sit on the
    free list while still holding references."""
    for eng in monitor._pools():
        pool = getattr(eng, "pool", None)
        if pool is None:
            continue
        try:
            refs = list(pool._ref)
            free = list(pool._free)
        except Exception:
            continue
        live = sum(1 for b in range(1, len(refs)) if refs[b] > 0)
        freed_live = sum(1 for b in free if refs[b] > 0)
        if len(free) + live != pool.capacity or freed_live:
            return True, {"free": len(free), "live": live,
                          "capacity": pool.capacity,
                          "free_with_refs": freed_live}
    return False, {}


def _wd_kv_backpressure(w, monitor):
    """Admissions refused because the block pool could not cover the
    worst-case reservation — the live form of the pool-exhaustion gate."""
    n = w.delta("serving.kv.pool_exhausted")
    return n > 0, {"pool_exhausted": n, "window_s": w.seconds}


def _wd_goodput_accounted(w, monitor):
    """The goodput ledger (``profiler.goodput``, published by a
    ``FaultTolerantTrainer``'s ``goodput.report()``) must attribute
    >= 99% of wall-clock to some bucket; abstains until a report has set
    ``goodput.wall_ns``."""
    if not w.gauge("goodput.wall_ns", 0):
        return False, {}
    acc = w.gauge("goodput.accounted")
    return (acc is not None and acc < 0.99), {"accounted": acc}


def _wd_spec_acceptance(w, monitor):
    """Speculative acceptance collapse: the draft model proposes tokens
    the target almost never accepts — every round burns K+1 draft
    launches for ~1 emitted token.  Needs real draft volume in the
    window before it may fire."""
    drafted = w.delta("serving.spec.drafted")
    acc = w.gauge("serving.spec.acceptance")
    firing = drafted >= 16 and acc is not None and acc < 0.05
    return firing, {"drafted": drafted, "acceptance": acc}


def _wd_kv_spill_burn(w, monitor):
    """Sustained host-tier spill traffic: the device pool is
    oversubscribed enough that cold-block demotion runs on the admission
    path every window.  Needs real volume (>= 8 blocks) AND a sustained
    rate (> 1 block/s) before firing, so a one-off burst when a big
    prompt lands does not flap; the autoscaler answers with
    ``grow_decode`` (more HBM beats paging churn)."""
    spilled = w.delta("serving.kv.tier.spilled_blocks")
    rate = w.rate("serving.kv.tier.spilled_blocks")
    return (spilled >= 8 and rate > 1.0), {"spilled": spilled,
                                           "rate": rate,
                                           "window_s": w.seconds}


def _wd_kv_tier_occupancy(w, monitor):
    """Host tier nearly full (>= 90% of capacity on any engine): the
    next spills will LRU-discard resident entries, turning demotions
    into data loss (replay-by-prefill).  Live early warning that the
    tier itself needs resizing."""
    for eng in monitor._pools():
        tier = getattr(eng, "_host_tier", None)
        if tier is None:
            continue
        if tier.resident >= 0.9 * tier.capacity:
            return True, {"resident": tier.resident,
                          "capacity": tier.capacity}
    return False, {}


def _wd_mfu_collapse(w, monitor):
    """A dominant program is burning device time at near-zero MFU: the
    roofline says the chip is idle inside the launch (degenerate shapes,
    a silent fallback kernel, host-bound dispatch).  Gated on real
    sampling activity in the window (the ledger only moves when
    FLAGS_device_time_sample > 0) and on sample volume per program, so a
    cold first sample cannot flap it."""
    if w.delta("jit.devicetime.sampled_syncs") <= 0:
        return False, {}
    from . import devicetime as _devicetime
    for row in _devicetime.snapshot(top=8)["programs"]:
        mfu = row.get("mfu")
        share = row.get("share") or 0.0
        if (mfu is not None and row["sampled"] >= 4 and share >= 0.25
                and mfu < 0.05):
            return True, {"program": row["name"], "mfu": mfu,
                          "share": share, "sampled": row["sampled"]}
    return False, {}


def _wd_device_time_regression(w, monitor):
    """A program's trailing-window mean device time blew past its own
    baseline (>= 2x): a shape drifted into a slower executable, a cache
    went cold, or the accelerator is being stolen.  Fires only for
    programs that carry real share, with enough samples that the
    baseline mean is meaningful."""
    if w.delta("jit.devicetime.sampled_syncs") <= 0:
        return False, {}
    from . import devicetime as _devicetime
    for row in _devicetime.snapshot(top=8)["programs"]:
        reg = row.get("regression")
        share = row.get("share") or 0.0
        if (reg is not None and reg >= 2.0 and row["sampled"] >= 12
                and share >= 0.05):
            return True, {"program": row["name"], "regression": reg,
                          "share": share, "sampled": row["sampled"]}
    return False, {}


def _wd_prefetch_stall(w, monitor):
    """Input pipeline starvation: time blocked on data dominates the
    window."""
    stall = w.delta("io.prefetch_stall_ns")
    ratio = stall / (w.seconds * 1e9)
    return (stall > 0 and ratio > 0.5), {"stall_ns": stall,
                                         "ratio": ratio}


def _wd_noisy_neighbor(w, monitor):
    """Multi-tenant isolation: one tenant bucket's windowed ITL p95 is a
    multiple of the other buckets' median — a neighbor's burn is sinking
    its SLO.  Reads the ``serving.itl_ns.tenant.<bucket>`` histograms the
    adapter-serving engine feeds per emitted token; needs >= 2 buckets
    with real traffic (>= 8 samples each) in the window, so single-tenant
    or idle fleets can never flap it."""
    p95s = {}
    for name in w.end.hists:
        if not name.startswith("serving.itl_ns.tenant."):
            continue
        h = w.hist_delta(name)
        if h is None or h.count < 8:
            continue
        p95s[name.rsplit(".", 1)[-1]] = h.percentile(95)
    if len(p95s) < 2:
        return False, {}
    worst_bucket = max(p95s, key=p95s.get)
    worst = p95s[worst_bucket]
    rest = sorted(v for k, v in p95s.items() if k != worst_bucket)
    med = rest[len(rest) // 2]
    firing = med > 0 and worst >= 4.0 * med
    return firing, {"worst_bucket": worst_bucket,
                    "worst_p95_ns": worst,
                    "median_other_p95_ns": med,
                    "buckets": len(p95s)}


def default_slos():
    """The serving SLO objectives (targets sized for the CPU test scale
    the repo's gates run at; production deployments pass their own)."""
    return [
        SLO("itl_burn", ("hist_p95", "serving.itl_ns"), 15e6),
        SLO("ttft_burn", ("hist_p95", "serving.ttft_ns"), 500e6),
        SLO("queue_wait_burn", ("hist_p95", "serving.queue_wait_ns"),
            500e6),
        SLO("shed_rate",
            lambda w: ((w.delta("serving.fleet.shed")
                        / max(1.0, w.delta("serving.fleet.dispatched")
                              + w.delta("serving.fleet.shed")))
                       if (w.delta("serving.fleet.dispatched")
                           + w.delta("serving.fleet.shed")) > 0 else None),
            0.05),
        SLO("error_rate", ("ratio", "serving.request_errors",
                           "serving.requests"), 0.01),
    ]


def default_watchdogs():
    return [
        Watchdog("retrace_storm", _wd_retrace_storm),
        Watchdog("kv_conservation", _wd_kv_conservation,
                 severity="critical"),
        Watchdog("kv_backpressure", _wd_kv_backpressure),
        Watchdog("kv_spill_burn", _wd_kv_spill_burn),
        Watchdog("kv_tier_occupancy", _wd_kv_tier_occupancy),
        Watchdog("goodput_accounted", _wd_goodput_accounted),
        Watchdog("spec_acceptance", _wd_spec_acceptance),
        Watchdog("noisy_neighbor", _wd_noisy_neighbor),
        Watchdog("prefetch_stall", _wd_prefetch_stall),
        Watchdog("mfu_collapse", _wd_mfu_collapse),
        Watchdog("device_time_regression", _wd_device_time_regression),
    ]


def default_rules():
    return default_slos() + default_watchdogs()


class HealthMonitor:
    """Snapshot ring + rule evaluation + alert lifecycle; see the module
    docstring.  Construction is cheap (no snapshot is taken) so owners
    like ``ServingFleet`` create one unconditionally and let
    :meth:`maybe_tick` gate everything on ``FLAGS_health``."""

    def __init__(self, rules=None, fleet=None, ring=256, interval_s=None,
                 signal_window_s=15.0):
        self.rules = list(rules) if rules is not None else default_rules()
        self.fleet = fleet
        self.interval_s = interval_s   # None: FLAGS_health_interval_s
        self.signal_window_s = float(signal_window_s)
        self.ticks = 0
        self._ring: collections.deque = collections.deque(
            maxlen=int(ring))
        self._alerts: dict[str, Alert] = {}
        self._attached: list = []
        self._lock = threading.Lock()
        self._last_tick_ts = None

    # -- wiring --------------------------------------------------------------
    def attach(self, obj):
        """Register an engine / trainer / fleet whose internals the
        watchdogs may probe (paged engines contribute their block pool to
        the conservation rule).  Returns self for chaining."""
        with self._lock:
            if obj is not None and obj not in self._attached:
                self._attached.append(obj)
        return self

    def _pools(self):
        """Every object that may own a paged block pool: attachments plus
        the live replica engines of an owning fleet."""
        with self._lock:
            objs = list(self._attached)
        if self.fleet is not None:
            try:
                objs.extend(rep.engine for rep in self.fleet._alive())
            except Exception:
                pass
        return objs

    # -- ticking -------------------------------------------------------------
    def maybe_tick(self, now=None):
        """Tick if the plane is on and the cadence interval elapsed; the
        OFF path is one cached-bool check and touches no registry."""
        if not _ENABLED[0]:
            return None
        if now is None:
            now = time.monotonic()
        interval = (self.interval_s if self.interval_s is not None
                    else float(_flags.flag("FLAGS_health_interval_s")))
        if (self._last_tick_ts is not None
                and now - self._last_tick_ts < interval):
            return None
        return self.tick(now)

    def tick(self, now=None):
        """Take one snapshot, evaluate every rule, update alert states,
        publish the admission level.  Returns the new snapshot."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            snap = take_snapshot(now, self.ticks)
            self._ring.append(snap)
            self.ticks += 1
            self._last_tick_ts = now
        _ACTIVE[0] = self
        _counters.inc("health.ticks")
        for rule in self.rules:
            try:
                firing, detail = rule.evaluate(self)
            except Exception as e:   # a broken rule must not kill the owner
                firing, detail = False, {"rule_error": repr(e)}
            self._transition(rule, firing, detail, now)
        level = self.admission_level()
        _counters.set_gauge("health.admission_level", LEVELS.index(level))
        return snap

    def _transition(self, rule, firing, detail, now):
        with self._lock:
            alert = self._alerts.get(rule.name)
            if firing:
                if alert is not None and alert.state == "firing":
                    alert.last = now          # dedupe: already firing
                    alert.detail = detail
                    return
                if alert is None:
                    alert = Alert(rule.name, rule.kind, rule.severity,
                                  now, detail)
                    self._alerts[rule.name] = alert
                else:                          # refire after a resolve
                    alert.state = "firing"
                    alert.since = alert.last = now
                    alert.resolved_at = None
                    alert.detail = detail
                    alert.fired_count += 1
                window = self._last_window_locked()
            else:
                if alert is None or alert.state != "firing":
                    return
                alert.state = "resolved"
                alert.resolved_at = now
                _counters.inc("health.alerts.resolved")
                _counters.inc(f"health.alerts.resolved.{rule.name}")
                _flight.record("health.alert.resolved", rule=rule.name)
                return
        # 0 -> 1 transition (outside the lock: dump() serialises on the
        # flight lock and snapshots the registries itself)
        _counters.inc("health.alerts.fired")
        _counters.inc(f"health.alerts.fired.{rule.name}")
        _flight.record("health.alert.fired", rule=rule.name,
                       rule_kind=rule.kind, severity=rule.severity)
        try:
            _flight.dump(f"health_{rule.name}", context={
                "rule": rule.name, "kind": rule.kind,
                "severity": rule.severity, "detail": detail,
                "window": window.summary() if window else None})
        except Exception:
            pass

    # -- windows -------------------------------------------------------------
    def _last_window_locked(self):
        if len(self._ring) < 2:
            return None
        return Window(self._ring[-2], self._ring[-1])

    def window(self, seconds, now=None):
        """The window ending at the latest snapshot whose span covers
        ``seconds`` — or the widest available span when the ring is
        younger than that.  None until two snapshots exist."""
        with self._lock:
            snaps = list(self._ring)
        if len(snaps) < 2:
            return None
        end = snaps[-1]
        start = snaps[0]
        for s in reversed(snaps[:-1]):
            if end.ts - s.ts >= seconds:
                start = s
                break
        return Window(start, end)

    # -- alert / status surfaces ---------------------------------------------
    def firing(self):
        with self._lock:
            return [a for a in self._alerts.values()
                    if a.state == "firing"]

    def firing_names(self):
        """Set of currently-firing rule names — the autoscaler's decision
        predicate reads this instead of re-walking Alert objects."""
        return {a.name for a in self.firing()}

    def alert_firing(self, name) -> bool:
        """True while the named rule's alert is in the firing state."""
        with self._lock:
            a = self._alerts.get(name)
            return a is not None and a.state == "firing"

    def alerts_state(self):
        """JSON-safe list of every alert ever raised, firing first."""
        with self._lock:
            alerts = sorted(self._alerts.values(),
                            key=lambda a: (a.state != "firing", a.name))
            return [a.to_dict() for a in alerts]

    def admission_level(self) -> str:
        """The single recommendation the autoscaler consumes: ``ok`` (no
        alert firing), ``degraded`` (some alert firing), ``critical``
        (a critical-severity alert firing — shed / stop admitting)."""
        firing = self.firing()
        if not firing:
            return "ok"
        if any(a.severity == "critical" for a in firing):
            return "critical"
        return "degraded"

    def slo_status(self):
        """Per-SLO burn-rate detail for every objective (``GET /slo``)."""
        return [r.status(self) for r in self.rules
                if isinstance(r, SLO)]

    def signals(self):
        """The derived windowed signals (``GET /signals``): counter rates
        for everything that moved, windowed histogram p95s, and the
        current gauge values."""
        w = self.window(self.signal_window_s)
        if w is None:
            return {"window_s": 0.0, "rates_per_s": {}, "p95": {},
                    "gauges": {}}
        rates = {}
        for k in w.end.counters:
            d = w.delta(k)
            if d:
                rates[k] = d / w.seconds
        p95 = {}
        for name in w.end.hists:
            v = w.percentile(name, 95)
            if v is not None:
                p95[name] = v
        gauges = {k: v for k, v in w.end.counters.items()
                  if k in getattr(_counters, "_GAUGES", {})}
        return {"window_s": w.seconds, "rates_per_s": rates, "p95": p95,
                "gauges": gauges}

    def summary(self):
        """The compact block ``ServingFleet.stats()['health']`` /
        ``Router.stats()['health']`` embed.  Cheap when off."""
        if not _ENABLED[0]:
            return {"enabled": False, "admission_level": "ok",
                    "alerts": [], "ticks": self.ticks}
        return {"enabled": True,
                "admission_level": self.admission_level(),
                "alerts": [a.name for a in self.firing()],
                "ticks": self.ticks}

    def flight_state(self):
        """What the flight recorder embeds into every postmortem bundle:
        the alert set and the last window's movement."""
        with self._lock:
            window = self._last_window_locked()
        return {"admission_level": self.admission_level(),
                "alerts": self.alerts_state(),
                "window": window.summary() if window else None}


def _flight_health_provider():
    mon = _ACTIVE[0]
    if mon is None or not _ENABLED[0]:
        return None
    return mon.flight_state()


_flight.set_health_provider(_flight_health_provider)

def _on_health(v):
    _ENABLED[0] = bool(v)


_flags.register_flag_observer("FLAGS_health", _on_health, call_now=True)
