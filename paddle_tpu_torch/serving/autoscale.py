"""Telemetry-driven prefill/decode autoscaler for the serving fleet
(port of ``paddle_tpu/serving/autoscale.py``).

The health plane turns counter and histogram windows into burn-rate
alerts; :meth:`FleetAutoscaler.maybe_scale` — called from the fleet's
scheduler (``pump()``, or the monitor thread of a threaded fleet) —
turns those alerts into topology actions on the ``ServingFleet``:

* ``itl_burn`` on a **unified** fleet → ``disaggregate``: the
  least-loaded replica takes the ``"prefill"`` role, the rest
  ``"decode"``, so long prompts stop stealing decode iterations.
* ``itl_burn`` on a **disaggregated** fleet → ``grow_decode``: flip a
  surplus prefill replica to decode, else spawn a decode replica (up to
  ``max_replicas``).
* ``ttft_burn`` / ``queue_wait_burn`` → ``grow_prefill``, the mirror.
* ``kv_spill_burn`` → ``grow_decode`` (disaggregate first when unified).
* ``ok_streak`` clean evaluations → ``retire`` an idle replica this
  autoscaler spawned (never one the operator sized the fleet with).

Each action is followed by ``cooldown_ticks`` held-off evaluations.

An evaluation is split in two: :meth:`FleetAutoscaler.plan` reads the
health plane and the fleet and returns a decision (the action, the
replica indices and roles it names, the policy's new cooldown and
streak), and :meth:`FleetAutoscaler.apply` carries it out through the
fleet's primitives.  :meth:`maybe_scale` does both; on a mesh of more
than one rank the fleet runs :meth:`plan` on rank 0 alone, against rank
0's health plane, and every rank applies rank 0's decision at the same
tick, so the replicas, ``history``, ``serving.autoscale.*`` and the role
gauges are the same on every rank.
Decisions count under ``serving.autoscale.decisions[.<action>]``,
``.flips.to_prefill`` / ``.flips.to_decode``, ``.spawns`` and
``.retires``; the live split is on the ``serving.autoscale.
prefill_replicas`` / ``decode_replicas`` gauges.  With ``FLAGS_health``
off the autoscaler is inert.
"""

from __future__ import annotations

import threading
from collections import deque

from ..profiler import counters
from ..profiler import health as _health

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """See the module docstring for the policy.

    ``cooldown_ticks`` — evaluations skipped after each action;
    ``ok_streak`` — consecutive no-alert evaluations before a retire;
    ``min_prefill`` / ``min_decode`` — role floors a flip may not break;
    ``max_replicas`` — fleet-size ceiling for spawns.
    """

    def __init__(self, fleet, cooldown_ticks=2, ok_streak=8,
                 min_prefill=1, min_decode=1, max_replicas=8):
        self.fleet = fleet
        self.cooldown_ticks = int(cooldown_ticks)
        self.ok_streak = int(ok_streak)
        self.min_prefill = int(min_prefill)
        self.min_decode = int(min_decode)
        self.max_replicas = int(max_replicas)
        self._cooldown = 0
        self._ok = 0
        self._last_ticks = 0          # only evaluate on fresh health ticks
        self._spawned = []            # replicas this autoscaler created
        self._last = None
        self._history = deque(maxlen=32)
        self._lock = threading.Lock()

    # -- evaluation ----------------------------------------------------------
    def maybe_scale(self):
        """One policy evaluation; returns the action taken (``None`` for
        no-op).  Gated on the health plane being enabled AND having
        ticked since the last evaluation — the autoscaler never acts on
        a stale alert view, and with ``FLAGS_health=0`` it is inert."""
        if not self._lock.acquire(blocking=False):
            return None               # monitor thread vs pump(): one wins
        try:
            return self.apply(self.plan())
        finally:
            self._lock.release()

    def plan(self):
        """The policy evaluated against this process's health plane, as
        a decision for :meth:`apply` (None when gated: health off, no
        fresh tick).  Changes neither the fleet nor the autoscaler."""
        fleet = self.fleet
        if fleet._closed or not _health.enabled():
            return None
        ticks = fleet.health.ticks
        if ticks == 0 or ticks == self._last_ticks:
            return None
        dec = {"ticks": ticks, "cooldown": self._cooldown, "ok": self._ok,
               "action": None, "ops": [], "last": None}
        if self._cooldown > 0:
            dec["cooldown"] -= 1
            return dec
        alive = [r for r in fleet._alive() if r.warmed]
        prefill = [r for r in alive if r.role == "prefill"]
        decode = [r for r in alive if r.role == "decode"]
        firing = fleet.health.firing_names()
        disagg = bool(prefill or decode)
        ops = dec["ops"]
        action = None
        if "itl_burn" in firing:
            action = (self._grow("decode", prefill, decode, alive, ops)
                      if disagg else self._disaggregate(alive, ops))
        elif "ttft_burn" in firing or "queue_wait_burn" in firing:
            action = (self._grow("prefill", prefill, decode, alive, ops)
                      if disagg else self._disaggregate(alive, ops))
        elif "kv_spill_burn" in firing:
            # sustained spill-rate burn: device KV is oversubscribed and
            # paging churn is on the admission path — decode HBM is the
            # cheaper fix
            action = (self._grow("decode", prefill, decode, alive, ops)
                      if disagg else self._disaggregate(alive, ops))
        if action is None and not firing:
            dec["ok"] += 1
            action = self._maybe_retire(dec["ok"], ops)
        elif firing:
            dec["ok"] = 0
        if action is not None:
            dec.update(action=action, cooldown=self.cooldown_ticks, ok=0,
                       last={"action": action, "firing": sorted(firing),
                             "tick": ticks})
        return dec

    def apply(self, dec):
        """Carry out a :meth:`plan` decision (None: nothing); returns its
        action.  A replica the decision names that died since is
        skipped."""
        if dec is None:
            return None
        fleet = self.fleet
        for op in dec["ops"]:
            if op[0] == "spawn":
                rep = fleet._spawn_replica(role=op[1])
                if rep is not None:
                    self._spawned.append(rep)
                    counters.inc("serving.autoscale.spawns")
                continue
            rep = fleet._replica(op[1])
            if rep is None:
                continue
            if op[0] == "role":
                fleet._set_role(rep, op[2])
                counters.inc(f"serving.autoscale.flips.to_{op[2]}")
            else:
                if rep in self._spawned:
                    self._spawned.remove(rep)
                fleet._retire_replica(rep)
                counters.inc("serving.autoscale.retires")
        self._last_ticks = dec["ticks"]
        self._cooldown, self._ok = dec["cooldown"], dec["ok"]
        action = dec["action"]
        if action is not None:
            counters.inc("serving.autoscale.decisions")
            counters.inc(f"serving.autoscale.decisions.{action}")
            self._last = dict(dec["last"])
            self._history.append(self._last)
        return action

    # -- actions -------------------------------------------------------------
    def _disaggregate(self, alive, ops):
        """Split a unified fleet: least-loaded replica becomes the
        prefill side (its backlog drains fastest), everyone else takes
        decode.  In-flight requests finish where they run; only new
        admissions see the split."""
        if len(alive) < 2:
            return None
        if self.fleet._engine_kw.get("kv_layout") != "paged":
            return None      # KV migration is block-granular: paged only
        load = sorted(alive, key=lambda r:
                      (r.engine.stats()["outstanding_tokens"], r.idx))
        ops.append(("role", load[0].idx, "prefill"))
        ops.extend(("role", rep.idx, "decode") for rep in load[1:])
        return "disaggregate"

    def _grow(self, role, prefill, decode, alive, ops):
        """Add capacity to ``role``: flip the least-loaded replica of the
        OTHER role when that side has surplus above its floor (free —
        no warmup, the engine is already serving), else spawn a fresh
        warmed replica under the ``max_replicas`` ceiling."""
        donors, floor = ((prefill, self.min_prefill) if role == "decode"
                         else (decode, self.min_decode))
        if len(donors) > floor:
            rep = min(donors, key=lambda r:
                      (r.engine.stats()["outstanding_tokens"], r.idx))
            ops.append(("role", rep.idx, role))
            return f"grow_{role}"
        if len(alive) >= self.max_replicas:
            return None
        ops.append(("spawn", role))
        return f"grow_{role}"

    def _maybe_retire(self, ok, ops):
        """Scale back in after a sustained clean streak (``ok``
        evaluations): retire the most recently self-spawned replica that
        is alive and idle.  Replicas the operator sized the fleet with
        are never retired."""
        if ok < self.ok_streak or not self._spawned:
            return None
        for rep in reversed(self._spawned):
            if rep.alive and not rep.engine.has_work():
                ops.append(("retire", rep.idx))
                return "retire"
        return None

    # -- observability -------------------------------------------------------
    def summary(self):
        """Snapshot for ``ServingFleet.stats()["autoscale"]``."""
        with self._lock:
            return {"cooldown": self._cooldown,
                    "ok_streak": self._ok,
                    "spawned_alive": sum(1 for r in self._spawned
                                         if r.alive),
                    "last": dict(self._last) if self._last else None,
                    "history": [dict(h) for h in self._history]}
