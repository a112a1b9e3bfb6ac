"""Multi-replica serving fleet (port of ``paddle_tpu/serving/fleet.py``):
N ``LLMEngine`` replicas behind an SLO-aware router, with heartbeat
health checks and fault-driven drain and respawn.

* **Dispatch** — :class:`serving.router.Router` routes each request to
  the replica with the fewest outstanding decode tokens (atomic
  per-replica ``stats()``; bounded per-replica queues), and sheds with a
  structured :class:`RetryAfter` a request whose deadline the estimated
  queue delay already blows.
* **Health** — every replica step stamps a heartbeat; the stall detector
  declares a replica dead when it has work but its heartbeat is older
  than ``heartbeat_timeout_s`` (``serving.fleet.heartbeat_misses``).
* **Drain/respawn** — on a replica crash (``faultinject``'s
  ``replica_crash`` site, or any exception out of a step) or a detected
  stall, a replacement replica is built (its warmup requests served
  before it joins dispatch), the dead replica's pools are released, and
  its in-flight requests are requeued with **at-most-once re-prefill**:
  the retry keeps the request id and seed, so it replays the delivered
  tokens (prefix-checked, never delivered twice) and continues.  A
  request whose retry budget is spent, or whose replay diverges,
  finishes ``"retried"`` with its partial tokens.
* **Disaggregated prefill/decode** (``prefill_replicas > 0``, paged KV
  only) — prefill replicas run chunked prefill and park the finished
  request (``hold_after_prefill``); the fleet then migrates its KV to a
  decode replica by block table (``export_request`` →
  ``adopt_migration`` → ``finish_migrated``): prefix blocks the
  destination caches are adopted by refcount, only the unshared tail is
  copied.  A migration severed in flight (``kv_migrate_drop``) costs one
  deterministic re-prefill; a destination without room defers it (the
  request stays held, KV intact).
* **Autoscaling** (``autoscale=True``) — a
  :class:`serving.autoscale.FleetAutoscaler` reads the health plane's
  burn-rate alerts each scheduler tick and rebalances the split.

* **On a mesh** (``mesh=``) every replica builds its engine over the
  same mesh (``LLMEngine(mesh=)``: this rank's shards), and every rank
  builds the same fleet and receives the same calls.  The replicas'
  engines share the mesh's communicators, so ``threaded=True`` runs one
  scheduler thread that ticks the fleet as :meth:`pump` does (no
  monitor thread, no thread per replica): their collectives never
  interleave, and ``submit`` posts its request to the next tick, which
  picks the replica and admits it, and waits for it.

  On a mesh of more than one rank whatever reads a clock, a thread's
  timing, a rank's own health plane or its own fault schedule is
  decided on mesh rank 0 and applied on every rank at the same tick
  (:class:`serving.arena.RankZero`, over the mesh's one gloo group).
  Each replica pick is rank 0's, with its ``RetryAfter``, the
  ``router_queue`` fault, the router's counters and the seed it draws
  when ``submit`` was given none.  Each tick issues one object
  collective (an all-gather) that carries rank 0's decisions and every
  rank's crash reports: how many posted calls to apply (threaded
  submits; cancels, which are always posted there, so a rank's caller
  cancelling at another tick than rank 0's changes nothing; the user's
  ``spawn_replica``, ``retire_replica`` and ``set_role``), the stall
  verdicts, rank 0's fault schedule whenever it is active or moved
  (every rank installs it before it steps, and the sites then fire
  alike on every rank), the autoscaler's action (rank 0 ticks its
  health plane and evaluates the policy; every rank applies the
  action), each replica's deadline verdict (the requests past their
  deadline by rank 0's clock), and whether a closed fleet drained.  A
  replica whose step raised on a rank (an injected ``replica_crash`` or
  any exception out of its step) is reported at the next tick and dies
  on every rank when any rank reports it: drained, respawned (the new
  engine built and warmed on every rank in the same order) and its
  requests replayed at most once, as without a mesh.  A rank that
  raises inside a collective of a step, or whose process dies, is not
  covered here: the other ranks wait in that collective until its
  timeout.  Under the elastic agent (``distributed.elastic``) such a
  mesh fleet restarts whole, every rank's process launched again and
  its requests lost with it; the JAX fleet, one process over every
  device, has no counterpart to copy (ROADMAP.md, limits of the port).

Every replica shares the model's weights; only the pools are per
replica.  All replicas queue their work on the device's current stream
(the default stream of every thread), so a migration's gather from the
source pools and scatter into the destination's run in the order the
host issued them; a replica's ``_step_lock`` keeps a migration adopting
into it from another thread off its host-side tables while it steps.

The invariant the chaos tests gate: **zero lost requests under churn** —
every admitted request terminates with a definite ``finish_reason`` —
and, with no faults injected, the fleet's tokens equal one engine's.

Counters: ``serving.fleet.dispatched / shed / health_shed / retried /
respawns / heartbeat_misses / replica_deaths[.reason] /
completed[.reason] / replayed_tokens / warmup_requests / monitor_errors
/ lost`` and ``serving.fleet.migrate.requests / blocks_copied /
blocks_shared / tokens / deferred / dropped / failed``, with the gauges
``serving.fleet.replicas``, ``serving.fleet.decode_tps`` and
``serving.autoscale.prefill_replicas / decode_replicas``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from ..profiler import counters
from ..profiler import devicetime as _devicetime
from ..profiler import flight
from ..profiler import health as _health
from ..profiler import trace as rtrace
from ..profiler.host_tracer import span
from ..resilience import faultinject
from .arena import RankZero
from .autoscale import FleetAutoscaler
from .engine import (EngineBackpressure, EngineClosed, LLMEngine,
                     bucket_length, prompt_ids)
from .kvcache import BlockPoolExhausted, HostTierLost
from .router import RetryAfter, Router

__all__ = ["FleetRequest", "Replica", "ServingFleet"]

# per-iteration stall applied by the ``slow_decode`` faultinject site: the
# replica holding the scheduled fleet request sleeps this long before its
# decode launch, once per consumed schedule entry ("slow_decode@rid*N"
# stalls N consecutive iterations).  Long enough to dominate the request's
# decode share in its trace; short enough to stay far from the heartbeat
# stall detector.
SLOW_DECODE_STALL_S = 0.02

#: seconds a rank's scheduler waits for its caller to post what rank 0's
#: caller posted (the same program runs on every rank)
POST_WAIT_S = 600.0

#: the counters ``Router.pick`` moves: on a multi-rank mesh the pick is
#: rank 0's, and every other rank moves them by as much
_PICK_COUNTERS = ("serving.fleet.shed", "serving.fleet.health_shed",
                  "serving.fleet.prefix_routed", "serving.fleet.adapter_routed")


class FleetRequest:
    """Stable user handle for one request, across replica retries.

    The fleet-level request outlives any single engine attempt: when the
    replica serving it dies, a fresh engine ``Request`` (same id, same
    seed, same deadline) is created on another replica and this handle
    keeps accumulating tokens.  ``tokens`` is the authoritative delivered
    stream — replayed tokens from a retry are prefix-verified against it,
    never appended twice."""

    __slots__ = ("rid", "prompt", "kw", "seed", "deadline_s", "deadline",
                 "state", "finish_reason", "error", "tokens", "retries",
                 "replica_idx", "trace", "_er", "_lock", "_done", "_cancel",
                 "_fleet")

    def __init__(self, rid, prompt, kw, seed, deadline_s):
        self.rid = rid
        self.prompt = prompt          # np.int32 [T]
        self.kw = kw                  # engine add_request kwargs
        self.seed = seed              # SAME seed every attempt → replayable
        self.deadline_s = deadline_s
        self.deadline = (time.monotonic() + float(deadline_s)
                         if deadline_s is not None else None)
        self.state = "queued"         # queued | running | finished
        # eos | length | deadline | cancelled | error | retried
        self.finish_reason = None
        self.error = None
        self.tokens = []              # authoritative delivered stream
        self.retries = 0
        self.replica_idx = None       # replica of the current attempt
        self.trace = None             # TraceContext, stable across retries
        self._er = None               # current engine Request
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._cancel = False
        self._fleet = None            # a multi-rank mesh fleet: posts cancels

    @property
    def is_finished(self):
        return self.state == "finished"

    def cancel(self):
        """Thread-safe cancellation: flags this handle and the current
        engine attempt; a retry of a cancelled request finishes
        immediately.  On a multi-rank mesh fleet the cancel is posted and
        takes effect at the tick rank 0's count of posted calls reaches
        it, on every rank alike."""
        if self._fleet is not None:
            self._fleet._post_op({"op": "cancel", "freq": self}, wait=False)
            return
        self._apply_cancel()

    def _apply_cancel(self):
        self._cancel = True
        er = self._er
        if er is not None:
            er.cancel()

    def wait(self, timeout=None):
        """Block until terminal (threaded fleets); returns is_finished."""
        return self._done.wait(timeout)

    def output_ids(self):
        """prompt + delivered tokens, as one np.int32 array."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def _on_token(self, er, tok, i):
        """Absorb token ``i`` of the current attempt.  Tokens the fleet
        already delivered (a retry replaying the stream from the same
        PRNG chain) are prefix-checked and skipped; returns False on
        divergence (the attempt must be aborted and the request surfaced
        as ``finish_reason="retried"``).  ``i`` is the event's stamped
        stream index — NOT derivable from ``len(er.tokens)`` here,
        because events are absorbed after the whole engine step and one
        step can emit several tokens (prefill + same-step decode)."""
        with self._lock:
            if self.state == "finished" or er is not self._er:
                return True
            if i < len(self.tokens):
                if self.tokens[i] != int(tok):
                    return False
                counters.inc("serving.fleet.replayed_tokens")
            else:
                self.tokens.append(int(tok))
                self.state = "running"
        return True

    def _finish(self, reason, error=None):
        """Terminal CAS; True if this call made the transition."""
        with self._lock:
            if self.state == "finished":
                return False
            self.state = "finished"
            self.finish_reason = reason
            self.error = error
            self._er = None
        self._done.set()
        counters.inc("serving.fleet.completed")
        counters.inc(f"serving.fleet.completed.{reason}")
        if self.trace is not None:
            # the fleet handle owns trace finalization (not any single
            # engine attempt): it alone sees retries and the true deadline
            breached = (self.deadline is not None
                        and time.monotonic() > self.deadline)
            rtrace.finish(self.trace, reason, breached=breached,
                          retried=self.retries > 0)
        return True

    def __repr__(self):
        return (f"FleetRequest(id={self.rid}, state={self.state!r}, "
                f"reason={self.finish_reason!r}, retries={self.retries}, "
                f"replica={self.replica_idx}, "
                f"delivered={len(self.tokens)})")


class Replica:
    """One ``LLMEngine`` + its health/lifecycle state (and, in threaded
    fleets, its worker thread).

    ``role`` is ``None`` for a unified replica, ``"prefill"`` or
    ``"decode"`` in a disaggregated fleet — it only steers routing and
    the hold-after-prefill flag; the engine itself is role-agnostic.
    ``_step_lock`` serializes this replica's ``engine.step()`` against a
    migration adopting INTO it from another replica's thread: both
    rewrite the destination's host-side block tables and decode
    mirrors."""

    def __init__(self, idx, engine, role=None):
        self.idx = idx
        self.engine = engine
        self.role = role              # None | "prefill" | "decode"
        self.alive = True
        self.warmed = False
        self.hung = False             # decode_stall: stepping stopped
        self.dead_reason = None       # crash | stall | retired
        self.steps = 0
        self.last_beat = time.monotonic()
        self.thread = None
        self._kill = threading.Event()
        self._wake = threading.Event()
        self._step_lock = threading.Lock()

    def __repr__(self):
        return (f"Replica({self.idx}, role={self.role!r}, "
                f"alive={self.alive}, steps={self.steps}, "
                f"dead_reason={self.dead_reason!r})")


class ServingFleet:
    """N replicas behind a router; see the module docstring for design.

    ``threaded=True`` (deployment shape) runs one worker thread per
    replica plus a monitor thread; ``threaded=False`` is the
    deterministic mode the chaos tests drive via :meth:`pump` — one
    health-checked scheduler tick per call, replicas stepped in index
    order in the caller's thread.

    ``warm_buckets`` names prompt lengths each replica serves one
    throwaway request of (two tokens) before it joins dispatch; buckets
    seen at submit time are added, so a respawned replica has paid its
    first-use costs (allocator growth, kernel loads, the first migration
    of a run) for the live traffic mix first
    (``serving.fleet.warmup_requests``).

    ``prefill_replicas=P`` starts the fleet disaggregated: the first P
    replicas take the ``"prefill"`` role, the rest ``"decode"``
    (requires ``kv_layout="paged"`` — migration is block-granular — and
    ``P < replicas`` so at least one decode replica exists).
    ``autoscale=True`` attaches a :class:`FleetAutoscaler`
    (``autoscale_kw`` forwards to its constructor) that rebalances the
    split from the health plane's burn alerts; ``health_kw`` forwards to
    the fleet's :class:`HealthMonitor` (e.g. ``rules=`` / ``interval_s=``
    overrides for test-scale thresholds).
    """

    def __init__(self, model, replicas=2, max_slots=4, max_seq_len=None,
                 queue_size=64, min_bucket=8, eos_token_id=None,
                 threaded=True, heartbeat_timeout_s=10.0, slo_margin=1.0,
                 max_retries=1, warm_buckets=(), router=None,
                 kv_layout="slots", block_size=16, n_blocks=None,
                 prefill_chunk=None, prefix_cache=True, kv_dtype=None,
                 weight_dtype=None, draft_model=None, spec_k=4,
                 prefill_replicas=0, autoscale=False, autoscale_kw=None,
                 health_kw=None, host_kv_blocks=0, spill_idle_steps=0,
                 restore_cost=0.5, mesh=None, shard_rules=None,
                 adapter_slots=0, adapter_rank=8):
        multi = mesh is not None and mesh.size > 1
        self.model = model
        prefill_replicas = int(prefill_replicas)
        if prefill_replicas:
            if kv_layout != "paged":
                raise ValueError(
                    "disaggregated prefill/decode requires "
                    "kv_layout='paged': KV migrates between replicas by "
                    "block table")
            if prefill_replicas >= int(replicas):
                raise ValueError(
                    f"prefill_replicas={prefill_replicas} must leave at "
                    f"least one decode replica (replicas={replicas})")
        self._engine_kw = dict(max_slots=max_slots, max_seq_len=max_seq_len,
                               queue_size=queue_size, min_bucket=min_bucket,
                               eos_token_id=eos_token_id,
                               kv_layout=kv_layout, block_size=block_size,
                               n_blocks=n_blocks,
                               prefill_chunk=prefill_chunk,
                               prefix_cache=prefix_cache,
                               kv_dtype=kv_dtype,
                               weight_dtype=weight_dtype,
                               host_kv_blocks=host_kv_blocks,
                               spill_idle_steps=spill_idle_steps)
        if mesh is not None:
            # every replica builds a mesh engine over the same mesh: its
            # own StateArena keeps this rank's shards of the pools and of
            # the weights
            self._engine_kw.update(mesh=mesh, shard_rules=shard_rules)
        # a multi-rank mesh takes its timing-dependent decisions on rank
        # 0; a threaded mesh fleet ticks from one scheduler thread (the
        # replicas share the mesh's communicators), and submit posts to
        # it; calls posted to the next tick (see _post_op) wait here
        self._rz = RankZero.of(mesh) if multi else None
        self._sched = mesh is not None and bool(threaded)
        self._posted = deque()
        self._posted_cv = threading.Condition()
        # replicas whose step raised on this rank: a multi-rank mesh's
        # next tick gathers every rank's and drains them on every rank
        self._crashed = {}
        self._fi_seen = None     # rank 0's fault-schedule version carried
        self._sched_thread = None
        self._sched_error = None
        if draft_model is not None:
            # every replica runs draft/verify speculative decoding over
            # the one draft model
            self._engine_kw.update(draft_model=draft_model,
                                   spec_k=spec_k)
        if int(adapter_slots or 0) > 0:
            # every replica hosts a multi-tenant LoRA adapter arena; the
            # fleet-level registry below replays tenant registrations
            # into respawned replicas
            self._engine_kw.update(adapter_slots=int(adapter_slots),
                                   adapter_rank=int(adapter_rank))
        self._adapter_reg = {}   # tenant -> factors (respawn replay)
        self.router = (router if router is not None
                       else Router(slo_margin, restore_cost=restore_cost))
        # the health plane: construction is free; every tick is gated on
        # FLAGS_health inside maybe_tick().  The router shares the
        # monitor so Router.stats()["health"] serves the same view.
        self.health = _health.HealthMonitor(fleet=self,
                                            **(health_kw or {}))
        self.router.health = self.health
        self.autoscaler = (FleetAutoscaler(self, **(autoscale_kw or {}))
                           if autoscale else None)
        self.threaded = bool(threaded)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_retries = int(max_retries)
        self._lock = threading.RLock()
        self._replicas: list[Replica] = []
        self._requests: list[FleetRequest] = []   # every admitted request
        self._pending: deque = deque()            # retries awaiting room
        # migrations deferred on decode-side backpressure: the request
        # stays parked ("held") on its source replica, KV intact, and the
        # hand-off retries from the source's scheduler loop
        self._held_migrations: deque = deque()
        self._closed = False
        self._idx = itertools.count()
        self._rid = itertools.count()
        # probe one engine for the resolved S_max (max_seq_len may be None)
        probe = self._engine()
        self._seq_len = probe.max_seq_len
        self._min_bucket = probe.min_bucket
        self._warm_lens = {bucket_length(int(n), self._min_bucket,
                                         self._seq_len)
                           for n in warm_buckets}
        roles = ([None] * int(replicas) if not prefill_replicas
                 else ["prefill"] * prefill_replicas
                 + ["decode"] * (int(replicas) - prefill_replicas))
        first = Replica(next(self._idx), probe, role=roles[0])
        self._warm(first)
        self._install(first)
        for role in roles[1:]:
            self._spawn(role=role)
        self._publish_roles()
        self._monitor_stop = threading.Event()
        self._monitor_thread = None
        if self._sched:
            self._sched_thread = threading.Thread(
                target=self._scheduler_loop, name="fleet-scheduler",
                daemon=True)
            self._sched_thread.start()
        elif self.threaded:
            self._monitor_thread = threading.Thread(
                target=self._monitor_loop, name="fleet-monitor", daemon=True)
            self._monitor_thread.start()

    # -- replica lifecycle ---------------------------------------------------
    def _alive(self):
        with self._lock:
            return [r for r in self._replicas if r.alive]

    def _candidates(self):
        return [r for r in self._alive()
                if r.warmed and r.idx not in self._crashed]

    def _replica(self, idx):
        """The alive replica ``idx``, else None."""
        return next((r for r in self._alive() if r.idx == idx), None)

    def _engine(self):
        eng = LLMEngine(self.model, **self._engine_kw)
        if self._rz is not None:
            # its deadline verdicts ride in the fleet's tick
            eng._fleet_verdict = frozenset()
        return eng

    def _spawn(self, role=None):
        """Create + warm a replica, then let it join dispatch."""
        rep = Replica(next(self._idx), self._engine(), role=role)
        self._replay_adapters(rep)
        self._warm(rep)
        self._install(rep)
        return rep

    def _replay_adapters(self, rep):
        """Re-register every fleet-known tenant on a (re)spawned replica
        BEFORE it joins dispatch, so a retry routed there never sees an
        unregistered tenant."""
        if not self._adapter_reg:
            return
        with self._lock:
            items = list(self._adapter_reg.items())
        for tenant, factors in items:
            rep.engine.register_adapter(tenant, factors)

    def register_adapter(self, tenant, factors):
        """Install one tenant's LoRA factors fleet-wide: staged in the
        fleet registry (respawn replay) and registered on every live
        replica, so routing is free to place the tenant anywhere."""
        if not self._engine_kw.get("adapter_slots"):
            raise ValueError("fleet was built with adapter_slots=0")
        with self._lock:
            self._adapter_reg[tenant] = factors
            reps = [r for r in self._replicas if r.alive]
        for rep in reps:
            rep.engine.register_adapter(tenant, factors)

    def _has_role(self, role):
        with self._lock:
            return any(r.role == role for r in self._replicas
                       if r.alive and r.warmed)

    def _publish_roles(self):
        alive = self._alive()
        counters.set_gauge("serving.autoscale.prefill_replicas",
                           sum(1 for r in alive if r.role == "prefill"))
        counters.set_gauge("serving.autoscale.decode_replicas",
                           sum(1 for r in alive if r.role == "decode"))

    def set_role(self, rep, role):
        """Flip one replica's fleet role (the autoscaler's rebalance
        primitive).  In-flight requests are untouched — they finish where
        they run; only FUTURE routing and hold-after-prefill decisions
        see the new role.  On a multi-rank mesh the call is posted to the
        next tick (:meth:`_post_op`)."""
        if self._rz is not None:
            return self._post_op({"op": "role", "idx": rep.idx,
                                  "role": role})
        return self._set_role(rep, role)

    def _set_role(self, rep, role):
        rep.role = role
        self._publish_roles()

    def spawn_replica(self, role=None):
        """Grow the fleet by one warmed replica (autoscaler/public API).
        On a multi-rank mesh the call is posted to the next tick
        (:meth:`_post_op`): a threaded fleet returns the replica once that
        tick built it on every rank, a pumped one returns None and the
        replica joins at the next :meth:`pump`."""
        if self._rz is not None:
            return self._post_op({"op": "spawn", "role": role})
        return self._spawn_replica(role)

    def _spawn_replica(self, role=None):
        if self._closed:
            return None
        rep = self._spawn(role=role)
        self._publish_roles()
        return rep

    def _install(self, rep):
        rep.warmed = True
        with self._lock:
            self._replicas.append(rep)
        counters.set_gauge("serving.fleet.replicas", len(self._alive()))
        if self.threaded and not self._sched:
            rep.thread = threading.Thread(
                target=self._worker, args=(rep,),
                name=f"fleet-replica-{rep.idx}", daemon=True)
            rep.thread.start()

    def _warm(self, rep):
        """Serve one throwaway request per known prompt bucket (a prefill
        and a decode step) BEFORE the replica joins dispatch, so a
        respawned replica pays its first-use costs off the live
        traffic's SLOs."""
        if not self._warm_lens:
            return
        eng = rep.engine
        with span("serving.fleet.warmup"):
            for b in sorted(self._warm_lens):
                n = min(int(b), self._seq_len - 2)
                r = eng.add_request([0] * n, max_new_tokens=2, block=False)
                while not r.is_finished:
                    eng.step()
                counters.inc("serving.fleet.warmup_requests")

    def _respawn(self, role=None):
        rep = self._spawn(role=role)
        counters.inc("serving.fleet.respawns")
        return rep

    def retire_replica(self, rep):
        """Gracefully shrink the fleet by one replica (autoscaler scale-
        down): the replica leaves dispatch, its engine closes, and any
        work it still held is requeued WITHOUT burning retry budget or
        death counters — a retire is an operator decision, not a fault.
        The autoscaler only retires idle replicas, so the requeue set is
        normally empty.  On a multi-rank mesh the call is posted to the
        next tick (:meth:`_post_op`)."""
        if self._rz is not None:
            return self._post_op({"op": "retire", "idx": rep.idx})
        return self._retire_replica(rep)

    def _retire_replica(self, rep):
        with self._lock:
            if not rep.alive:
                return
            rep.alive = False
            rep.dead_reason = "retired"
        rep._kill.set()
        counters.set_gauge("serving.fleet.replicas", len(self._alive()))
        eng = rep.engine
        with eng._cond:
            eng._closed = True
            stranded = ([r for r in eng._slots if r is not None]
                        + list(eng._queue))
            eng._queue.clear()
            eng._cond.notify_all()
        eng.release_kv()
        for er in stranded:
            freq = er.tag
            er.tag = None
            if freq is None:
                continue
            with freq._lock:
                if freq.state == "finished" or freq._er is not er:
                    continue
                freq._er = None
            self._requeue(freq)
        self._publish_roles()

    def _replica_died(self, rep, reason, exc=None):
        """Drain a dead replica: mark it, respawn a warmed replacement,
        and requeue its in-flight requests (at-most-once re-prefill,
        idempotent by request id — same id, same seed, deterministic
        token replay)."""
        with self._lock:
            if not rep.alive:
                return
            rep.alive = False
            rep.dead_reason = reason
        rep._kill.set()
        counters.inc("serving.fleet.replica_deaths")
        counters.inc(f"serving.fleet.replica_deaths.{reason}")
        counters.set_gauge("serving.fleet.replicas", len(self._alive()))
        eng = rep.engine
        with eng._cond:
            eng._closed = True
            in_flight = [r for r in eng._slots if r is not None]
            queued = list(eng._queue)
            stranded = in_flight + queued
            eng._queue.clear()
            eng._cond.notify_all()
        # stranded traces get the death stamped before the dump snapshots
        # them, so the bundle's span trees name the event that stranded
        # the request (the respawn re-prefill continues the SAME trace_id)
        for er in stranded:
            freq = er.tag
            tr = freq.trace if freq is not None else None
            if tr is not None:
                tr.add_event("replica_died", replica=rep.idx, reason=reason)
        # postmortem bundle BEFORE respawn/requeue mutate anything: names
        # the dead replica and exactly which requests it was holding
        flight.dump("replica_died", {
            "replica": rep.idx,
            "reason": reason,
            "error": repr(exc) if exc is not None else None,
            "steps": rep.steps,
            "in_flight_rids": [r.rid for r in in_flight],
            "queued_rids": [r.rid for r in queued],
            "fleet_rids": [r.tag.rid for r in stranded
                           if r.tag is not None],
            "span_trees": [r.tag.trace.to_dict() for r in stranded
                           if r.tag is not None
                           and r.tag.trace is not None],
        })
        # the KV storage of a dead replica is garbage — slot arena or
        # paged block pool alike; release its device memory now
        eng.release_kv()
        requeue = []
        for er in stranded:
            freq = er.tag
            er.tag = None
            if freq is None:
                continue               # warmup request
            with freq._lock:
                if freq.state == "finished" or freq._er is not er:
                    continue           # stale attempt
                freq._er = None
            requeue.append(freq)
        # replacement first (warmed before joining dispatch), so survivors
        # plus the fresh replica share the requeued load — and so requeue
        # still works when the dead replica was the last one standing.
        # The replacement inherits the dead replica's role: a crash must
        # not silently shrink one side of a disaggregated fleet.
        if not self._closed or requeue:
            self._respawn(role=rep.role)
        self._publish_roles()
        for freq in requeue:
            if freq._cancel:
                freq._finish("cancelled")
            elif freq.retries >= self.max_retries:
                # at-most-once re-prefill: budget exhausted → surface the
                # partial stream instead of replaying again
                freq._finish("retried")
            else:
                freq.retries += 1
                counters.inc("serving.fleet.retried")
                self._requeue(freq)

    # -- dispatch ------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, do_sample=False,
               temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
               seed=None, deadline_s=None, adapter=None):
        """Route one prompt onto the least-loaded replica; returns the
        stable :class:`FleetRequest` handle.  Raises :class:`RetryAfter`
        (with ``queue_depth`` + ``retry_after_hint``) when admission is
        shed — deadline budget already blown by the estimated queue
        delay — or every replica queue is full.  ``adapter`` names a
        fleet-registered tenant (see :meth:`register_adapter`); the
        router's cost model prefers replicas whose arena already holds
        the tenant's factors, and the tenant rides every retry."""
        if self._closed:
            raise EngineClosed("fleet is drained; no new requests")
        ids = prompt_ids(prompt)
        if seed is None and self._rz is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        rid = next(self._rid)
        if self._rz is None:
            # a multi-rank mesh fires this fault in rank 0's pick
            try:
                faultinject.maybe_fault("router_queue", rid)
            except faultinject.InjectedFault as e:
                raise self._queue_fault(rid, e) from e
        kw = dict(max_new_tokens=int(max_new_tokens),
                  do_sample=bool(do_sample), temperature=float(temperature),
                  top_k=int(top_k), top_p=float(top_p),
                  eos_token_id=eos_token_id)
        if adapter is not None:
            if adapter not in self._adapter_reg:
                raise KeyError(f"adapter {adapter!r} is not registered "
                               "on this fleet (register_adapter first)")
            # riding kw means every retry/redispatch carries the tenant
            kw["adapter"] = adapter
        freq = FleetRequest(rid, ids, kw, None if seed is None else int(seed),
                            deadline_s)
        if self._rz is not None:
            freq._fleet = self
        freq.trace = rtrace.new_trace(rid)
        est = int(ids.shape[0]) + int(max_new_tokens)
        t0_tr = (time.perf_counter_ns() if freq.trace is not None else 0)
        # disaggregated fleet: new admissions land on a prefill replica;
        # the KV hand-off routes them to decode afterwards
        pick_kw = dict(est_tokens=est, deadline_s=deadline_s, prompt=ids,
                       role="prefill" if self._has_role("prefill") else None,
                       adapter=adapter)
        try:
            try:
                rep = (self._post_op({"op": "submit", "freq": freq,
                                      "pick_kw": pick_kw})
                       if self._sched else self._admit(freq, pick_kw))
            except faultinject.InjectedFault as e:
                # a multi-rank mesh: rank 0's pick fired router_queue
                raise self._queue_fault(rid, e) from e
        except RetryAfter:
            if freq.trace is not None:
                rtrace.finish(freq.trace, "shed")
            raise
        except EngineBackpressure as e:
            # lost the queue-room race with another submitter
            if freq.trace is not None:
                rtrace.finish(freq.trace, "shed")
            raise RetryAfter(str(e), queue_depth=e.queue_depth,
                             retry_after_hint=e.retry_after_hint,
                             reason="backpressure") from e
        if freq.trace is not None:
            freq.trace.add_span("admission", t0_tr, time.perf_counter_ns(),
                                replica=rep.idx)
        with self._lock:
            self._requests.append(freq)
        counters.inc("serving.fleet.dispatched")
        return freq

    def _queue_fault(self, rid, e):
        """The ``RetryAfter`` of a ``router_queue`` fault."""
        counters.inc("serving.fleet.shed")
        return RetryAfter(f"router queue fault for request {rid}: {e}",
                          queue_depth=sum(r.engine.stats()["queued"]
                                          for r in self._alive()),
                          retry_after_hint=0.0, reason="router_queue")

    def _dispatch(self, freq, rep=None):
        """Hand a fleet request to a replica engine (fresh or retry)."""
        if rep is None:
            rep, _ = self._pick(
                self._candidates(),
                est_tokens=freq.kw["max_new_tokens"] - len(freq.tokens),
                shed=False,    # requeues were admitted: never shed
                prompt=freq.prompt,
                role="prefill" if self._has_role("prefill") else None,
                adapter=freq.kw.get("adapter"))
        left = None
        if freq.deadline is not None:
            left = max(0.0, freq.deadline - time.monotonic())
        # a prefill replica parks the request after its last prefill
        # chunk ("held") and emits the first token; _absorb's "prefilled"
        # event then migrates the KV to a decode replica.  Hold only when
        # a decode replica exists to receive the hand-off — otherwise the
        # request would park forever.
        hold = rep.role == "prefill" and self._has_role("decode")
        er = rep.engine.add_request(freq.prompt, seed=freq.seed,
                                    deadline_s=left, block=False,
                                    trace_ctx=freq.trace,
                                    hold_after_prefill=hold, **freq.kw)
        er.tag = freq
        if freq.trace is not None and freq.retries > 0:
            freq.trace.add_event("redispatch", replica=rep.idx,
                                 retry=freq.retries)
        with freq._lock:
            freq._er = er
            freq.replica_idx = rep.idx
        if freq._cancel:
            er.cancel()
        rep._wake.set()
        return rep

    def _requeue(self, freq):
        try:
            self._dispatch(freq)
        except (RetryAfter, EngineBackpressure, EngineClosed):
            with self._lock:
                self._pending.append(freq)

    def _admit(self, freq, pick_kw):
        """Pick a submitted request's replica (``Router.pick`` with
        ``pick_kw``; a seedless request's seed drawn after it) and hand
        the request to it; returns the replica."""
        rep, drawn = self._pick(self._candidates(),
                                draw_seed=freq.seed is None,
                                fault_rid=freq.rid, **pick_kw)
        if freq.seed is None:
            # a mesh fleet: the seed rank 0 drew, the same on every rank
            freq.seed = drawn
        self._dispatch(freq, rep)
        # a respawn warms this bucket; added on the thread that ticks, so
        # a mesh fleet's ranks warm the same buckets
        self._warm_lens.add(bucket_length(int(freq.prompt.shape[0]),
                                          self._min_bucket, self._seq_len))
        return rep

    def _pick(self, candidates, draw_seed=False, fault_rid=None, **kw):
        """``(replica, seed)``: ``Router.pick`` over ``candidates`` and,
        with ``draw_seed``, a request seed drawn after it (else None); on
        a multi-rank mesh rank 0's, broadcast, with the ``router_queue``
        fault of a submit (``fault_rid``) fired in it and the router's
        counters moved on every rank as on rank 0.  Called only from the
        thread that ticks the fleet when it has a mesh, where every
        rank's replica list is the same."""
        def pick():
            if fault_rid is not None and self._rz is not None:
                faultinject.maybe_fault("router_queue", fault_rid)
            rep = self.router.pick(candidates, **kw)
            if not draw_seed:
                return rep.idx, None
            return rep.idx, int(np.random.randint(0, 2**31 - 1))

        def mirrored():
            before = [counters.get(k) for k in _PICK_COUNTERS]
            try:
                out, err = pick(), None
            except Exception as e:  # noqa: BLE001 - raised on every rank
                out, err = None, e
            return out, err, [counters.get(k) - b for k, b in
                              zip(_PICK_COUNTERS, before)]
        if self._rz is None:
            idx, seed = pick()
        else:
            out, err, moved = self._rz.decide(mirrored)
            if not self._rz.is_src:
                for k, m in zip(_PICK_COUNTERS, moved):
                    if m:
                        counters.inc(k, m)
            if err is not None:
                raise err
            idx, seed = out
        return next(r for r in candidates if r.idx == idx), seed

    def _post_op(self, post, wait=True):
        """Post a call to the next tick: a threaded mesh fleet's submit,
        and on a multi-rank mesh a cancel or the user's ``spawn_replica``,
        ``retire_replica`` or ``set_role``.  The tick applies as many
        posted calls as rank 0's caller has posted, in post order, on
        every rank (:meth:`_apply_posted`).  With ``wait`` on a threaded
        fleet, wait for that tick and return what the call returned there
        (or raise what it raised); else return None."""
        post["done"] = threading.Event()
        with self._posted_cv:
            self._posted.append(post)
            self._posted_cv.notify_all()
        if not (wait and self._sched):
            return None
        while not post["done"].wait(0.05):
            self._check_scheduler()
        if "error" in post:
            raise post["error"]
        return post.get("rep")

    def _apply_posted(self, n):
        """Apply the first ``n`` posted calls (rank 0's count: a threaded
        fleet waits until this rank's caller has posted as many), in post
        order, and wake their callers."""
        if not n:
            return
        deadline = time.monotonic() + POST_WAIT_S
        with self._posted_cv:
            while len(self._posted) < n:
                left = deadline - time.monotonic()
                if not self.threaded or not self._posted_cv.wait(
                        max(0.0, left)):
                    raise RuntimeError(
                        f"fleet: rank 0 applied {n} posted calls, this "
                        f"rank's caller posted {len(self._posted)}"
                        + (f" in {POST_WAIT_S} s"
                           if self.threaded else " before this pump"))
            posts = [self._posted.popleft() for _ in range(n)]
        for post in posts:
            try:
                post["rep"] = self._apply_op(post)
            except Exception as e:  # noqa: BLE001 - raised by its caller
                post["error"] = e
            finally:
                post["done"].set()

    def _apply_op(self, post):
        op = post["op"]
        if op == "submit":
            return self._admit(post["freq"], post["pick_kw"])
        if op == "cancel":
            return post["freq"]._apply_cancel()
        if op == "spawn":
            return self._spawn_replica(post["role"])
        rep = self._replica(post["idx"])
        if rep is None:
            return None
        if op == "retire":
            return self._retire_replica(rep)
        return self._set_role(rep, post["role"])

    def _flush_pending(self, rep):
        """Drain the fleet-level retry overflow into ``rep`` while it has
        queue room (called from the replica's own scheduling loop)."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                freq = self._pending.popleft()
            if freq.is_finished:
                continue
            try:
                self._dispatch(freq, rep)
            except (EngineBackpressure, EngineClosed):
                with self._lock:
                    self._pending.appendleft(freq)
                return

    # -- scheduling / health -------------------------------------------------
    def _inject_faults(self, rep):
        """Chaos hooks, keyed on FLEET request id so a schedule kills the
        same point in the stream whatever replica holds the request."""
        if not faultinject.active():
            return
        for er in list(rep.engine._slots):
            freq = er.tag if er is not None else None
            if freq is None:
                continue
            if faultinject.take("decode_stall", freq.rid):
                rep.hung = True      # heartbeats stop; detector must act
                return
            if faultinject.take("slow_decode", freq.rid):
                # deterministic per-iteration stall: the replica limps but
                # keeps heartbeating, so the request finishes late — the
                # tail sampler must keep its trace naming these spans
                t0 = time.perf_counter_ns()
                time.sleep(SLOW_DECODE_STALL_S)
                if freq.trace is not None:
                    freq.trace.add_span("decode.stall", t0,
                                        time.perf_counter_ns(),
                                        injected=True, replica=rep.idx)
                counters.inc("serving.fleet.slow_decode_stalls")
            faultinject.maybe_fault("replica_crash", freq.rid)

    def _step_replica(self, rep):
        """One health-checked scheduler iteration on one replica.
        Returns True when the replica had work.  Crashes (injected or
        real) propagate to the caller."""
        if rep.hung:
            return True
        self._flush_pending(rep)
        self._retry_migrations(rep)
        eng = rep.engine
        if not eng.has_work():
            rep.last_beat = time.monotonic()   # idle replica is healthy
            return False
        self._inject_faults(rep)
        if rep.hung:
            return True
        # the step lock serializes this replica's step against a
        # migration adopting into it from another thread; it covers ONLY
        # the engine step (not _absorb), so a migration triggered below
        # takes the DESTINATION's lock with no lock held
        with rep._step_lock:
            events = eng.step()
        rep.steps += 1
        rep.last_beat = time.monotonic()       # per-step heartbeat
        self._absorb(rep, events)
        return True

    def _absorb(self, rep, events):
        """Reconcile one step's engine events into the fleet handles."""
        for ev in events:
            er = ev["request"]
            freq = er.tag
            if freq is None:
                continue
            if ev["type"] == "token":
                if not freq._on_token(er, ev["token"], ev["index"]):
                    # replay divergence: abort the attempt, surface the
                    # already-delivered partial stream
                    counters.inc("serving.fleet.replay_divergence")
                    er.tag = None
                    er.cancel()
                    freq._finish("retried")
            elif ev["type"] == "prefilled":
                # disaggregation hand-off: the request finished chunked
                # prefill on this (prefill) replica and is parked; move
                # its KV to a decode replica by block table
                self._migrate(freq, rep, er)
            elif ev["type"] == "finished":
                with freq._lock:
                    stale = freq._er is not er
                if not stale:
                    freq._finish(er.finish_reason, er.error)

    # -- KV migration (disaggregated hand-off) -------------------------------
    def _migrate(self, freq, src, er):
        """Move a held request's KV from ``src`` (prefill role) to a
        decode replica, block-granular:

        1. ``export_request`` snapshots the block table + decode-state
           row on the source (no copies, no mutation — a severed
           migration loses nothing);
        2. the router picks a decode replica (``shed=False``: the request
           is already admitted);
        3. ``adopt_migration`` re-resolves the prompt prefix against the
           destination's radix tree and device-copies ONLY the unshared
           tail blocks (one gather and one scatter a pool, under the
           destination's step lock);
        4. the fleet handle re-points to the new engine request and the
           source releases its copy (``finish_migrated`` donates the
           sequence's blocks to the source prefix tree, so a later
           replay re-prefills as a prefix hit).

        Any failure between export and adopt — the ``kv_migrate_drop``
        chaos site, no decode capacity, destination pool exhausted —
        aborts cleanly: both pools reconcile and the request replays
        from scratch with token identity (same id, same seed)."""
        eng = src.engine
        t0_tr = time.perf_counter_ns()
        try:
            mig = eng.export_request(er)
        except HostTierLost as e:
            # the idle-spilled KV's host copy is gone (kv_spill_drop
            # fault or tier overflow): replay from scratch — same id,
            # same seed, token-identical output
            self._abort_migration(freq, src, er, "dropped", e)
            return
        except EngineBackpressure as e:
            # the source pool cannot host the page-in right now: the KV
            # stays split across tiers (partial restores kept) and the
            # hand-off retries from the source's scheduler loop
            counters.inc("serving.fleet.migrate.deferred")
            if freq.trace is not None:
                freq.trace.add_event("migrate_deferred", error=repr(e))
            with self._lock:
                self._held_migrations.append((freq, src, er))
            return
        except RuntimeError:
            return    # finished/evicted between emit and absorb: not held
        try:
            faultinject.maybe_fault("kv_migrate_drop", freq.rid)
            dest, _ = self._pick(
                [r for r in self._candidates() if r is not src],
                est_tokens=freq.kw["max_new_tokens"] - len(freq.tokens),
                shed=False, role="decode")
            with dest._step_lock:
                new_er, info = dest.engine.adopt_migration(
                    mig, eng, trace_ctx=freq.trace)
        except faultinject.InjectedFault as e:
            self._abort_migration(freq, src, er, "dropped", e)
            return
        except (RetryAfter, EngineBackpressure) as e:
            # transient: no decode slot / every decode queue full RIGHT
            # NOW.  The prefill work is done and the KV is intact on the
            # source — park the hand-off and retry next scheduler tick
            # instead of discarding the prefill into a replay
            counters.inc("serving.fleet.migrate.deferred")
            if freq.trace is not None:
                freq.trace.add_event("migrate_deferred", error=repr(e))
            with self._lock:
                self._held_migrations.append((freq, src, er))
            return
        except (EngineClosed, BlockPoolExhausted) as e:
            self._abort_migration(freq, src, er, "failed", e)
            return
        new_er.tag = freq
        with freq._lock:
            stale = freq.state == "finished" or freq._er is not er
            if not stale:
                freq._er = new_er
                freq.replica_idx = dest.idx
        if stale:
            # the handle moved on while we migrated (death-requeue or a
            # racing cancel finished it): orphan the adopted attempt
            new_er.tag = None
            new_er.cancel()
        try:
            eng.finish_migrated(er)
        except Exception:
            pass    # source died mid-migration; its pool is already gone
        er.tag = None
        if stale:
            dest._wake.set()
            return
        counters.inc("serving.fleet.migrate.requests")
        counters.inc("serving.fleet.migrate.blocks_copied",
                     info["blocks_copied"])
        counters.inc("serving.fleet.migrate.blocks_shared",
                     info["blocks_shared"])
        counters.inc("serving.fleet.migrate.tokens", info["tokens"])
        if freq.trace is not None:
            freq.trace.add_span("kv.migrate", t0_tr,
                                time.perf_counter_ns(),
                                src=src.idx, dest=dest.idx, **info)
        flight.record("serving.fleet.migrate", rid=freq.rid,
                      src=src.idx, dest=dest.idx, **info)
        if freq._cancel:
            new_er.cancel()
        dest._wake.set()

    def _retry_migrations(self, rep):
        """Re-attempt hand-offs parked on decode-side backpressure whose
        SOURCE is ``rep`` — run from rep's own scheduler loop, before its
        engine step, so the source pools are quiescent while the
        migration gather reads them as operands."""
        if not self._held_migrations:
            return
        with self._lock:
            mine = [m for m in self._held_migrations if m[1] is rep]
            if not mine:
                return
            self._held_migrations = deque(
                m for m in self._held_migrations if m[1] is not rep)
        for freq, src, er in mine:
            with freq._lock:
                stale = freq.state == "finished" or freq._er is not er
            if stale or not src.alive:
                continue    # the death/cancel path already owns these
            self._migrate(freq, src, er)

    def _abort_migration(self, freq, src, er, kind, exc):
        """Unwind a migration that failed between export and adopt:
        release the source's copy (block refcounts reconcile — the
        destination either never allocated or already rolled back) and
        requeue the request for a deterministic re-prefill replay.
        ``kind`` is ``"dropped"`` (injected ``kv_migrate_drop``) or
        ``"failed"`` (no decode capacity / destination pool exhausted)."""
        counters.inc(f"serving.fleet.migrate.{kind}")
        if freq.trace is not None:
            freq.trace.add_event("migrate_aborted", kind=kind,
                                 replica=src.idx, error=repr(exc))
        flight.record("serving.fleet.migrate_abort", rid=freq.rid,
                      why=kind, src=src.idx, error=repr(exc))
        try:
            src.engine.finish_migrated(er)
        except Exception:
            pass
        er.tag = None
        with freq._lock:
            if freq.state == "finished" or freq._er is not er:
                return
            freq._er = None
        if freq._cancel:
            freq._finish("cancelled")
        elif freq.retries >= self.max_retries:
            freq._finish("retried")
        else:
            freq.retries += 1
            counters.inc("serving.fleet.retried")
            self._requeue(freq)

    def _stalled(self):
        """Indices of the replicas the stall detector declares dead: with
        outstanding work (or hung) and a heartbeat older than
        ``heartbeat_timeout_s``."""
        now = time.monotonic()
        return [r.idx for r in self._alive()
                if (r.hung or r.engine.has_work())
                and now - r.last_beat > self.heartbeat_timeout_s]

    def _supervise(self, stalled):
        """Drain and replace the ``stalled`` replicas, then tick the
        health plane and the autoscaler."""
        self.check_health(stalled)
        self.health.maybe_tick()
        if self.autoscaler is not None:
            self.autoscaler.maybe_scale()

    def check_health(self, stalled=None):
        """The stall detector: a replica with outstanding work whose
        heartbeat is older than ``heartbeat_timeout_s`` is declared dead
        (``serving.fleet.heartbeat_misses``), drained, and replaced.
        ``stalled``: the verdicts to apply (indices; a multi-rank mesh's
        are rank 0's), by default this rank's (:meth:`_stalled`)."""
        if stalled is None:
            stalled = self._stalled()
        for rep in self._alive():
            if rep.idx in stalled:
                counters.inc("serving.fleet.heartbeat_misses")
                self._replica_died(rep, "stall")

    def pump(self):
        """Synchronous scheduler tick (``threaded=False``): one health
        check, then one step per alive replica in index order —
        deterministic, so chaos schedules reproduce exactly.  Returns
        True while any replica had work.

        Heartbeats of non-hung replicas are stamped up front: in
        synchronous mode a stale beat can only mean the CALLER paused
        between pumps (or a respawn warmup ran long), which must not read
        as a replica stall — only a replica that stopped progressing
        inside the scheduler (``hung``) keeps its old beat and trips the
        detector."""
        self._stamp()
        return self._tick()[0]

    def _stamp(self):
        now = time.monotonic()
        for rep in self._alive():
            if not rep.hung:
                rep.last_beat = now

    def _decide(self):
        """This tick's decisions as this process sees them: how many
        posted calls to apply, the stalled replicas, whether the closed
        fleet has drained.  On a multi-rank mesh (run on rank 0) also the
        health plane's tick, the autoscaler's action, the fault schedule
        (when active or moved since it was last carried) and each
        replica's deadline verdict."""
        with self._posted_cv:
            n = len(self._posted)
        dec = {"n": n, "stalled": self._stalled(),
               "drained": self._closed and n == 0 and not self.has_work()}
        if self._rz is None:
            return dec
        self.health.maybe_tick()
        v = faultinject.version()
        dec.update(
            plan=(self.autoscaler.plan() if self.autoscaler is not None
                  else None),
            faults=(faultinject.state() if faultinject.active()
                    or v != self._fi_seen else None),
            expired={r.idx: e for r in self._alive()
                     for e in (r.engine.expired_rids(),) if e})
        self._fi_seen = v
        return dec

    def _tick(self):
        """The fleet's scheduler tick (:meth:`pump`, and a threaded mesh
        fleet's scheduler thread).  Decides (:meth:`_decide`; on a
        multi-rank mesh rank 0's view with every rank's crash reports,
        one all-gather), applies the decisions — crashed replicas
        drained, posted calls applied, stalled replicas drained, the
        health plane and the autoscaler ticked — then steps every alive
        replica once in index order.  Returns ``(progressed, drained)``."""
        crashed = ()
        if self._rz is None:
            dec = self._decide()
        else:
            dec, reports = self._rz.gather(sorted(self._crashed),
                                           self._decide)
            crashed = sorted(set().union(*reports))
            self._apply_faults(dec["faults"])
            for idx in crashed:
                rep = self._replica(idx)
                exc = self._crashed.pop(idx, None)
                if rep is not None:
                    self._replica_died(rep, "crash", exc)
            self._crashed.clear()
        self._apply_posted(dec["n"])
        if self._rz is None:
            self._supervise(dec["stalled"])
        else:
            self.check_health(dec["stalled"])
            if not self._rz.is_src:
                self.health.maybe_tick()    # this rank's own counters
            if self.autoscaler is not None:
                self.autoscaler.apply(dec["plan"])
            for rep in self._alive():
                rep.engine._fleet_verdict = frozenset(
                    dec["expired"].get(rep.idx, ()))
        progressed = dec["n"] > 0 or bool(crashed)
        for rep in self._alive():
            try:
                progressed |= self._step_replica(rep)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:   # incl. injected SimulatedCrash
                if self._rz is not None:
                    # the next tick's verdict, taken with the other ranks
                    self._crashed[rep.idx] = e
                else:
                    self._replica_died(rep, "crash", e)
                progressed = True
        return progressed, dec["drained"] and not crashed

    def _apply_faults(self, faults):
        """Take rank 0's fault schedule (``faults``: its state, or None
        when rank 0's is empty and unchanged since it was last carried)
        before this tick steps, on a rank above 0."""
        if self._rz.is_src:
            return
        if faults is not None:
            faultinject.install(*faults)
        elif faultinject.active():
            faultinject.install({}, faultinject.state()[1])

    def _scheduler_loop(self):
        """A threaded mesh fleet's one scheduler thread: tick until the
        closed fleet has drained (rank 0's verdict); when idle, wait
        briefly for a post."""
        try:
            while True:
                progressed, drained = self._tick()
                if drained:
                    return
                if not progressed:
                    with self._posted_cv:
                        if not self._posted and not self._closed:
                            self._posted_cv.wait(0.002)
        except Exception as e:  # noqa: BLE001 - surfaced by submit/join
            self._sched_error = e
            counters.inc("serving.fleet.monitor_errors")

    def _check_scheduler(self):
        if self._sched_error is not None:
            raise RuntimeError("the fleet's scheduler thread failed: "
                               f"{self._sched_error!r}") \
                from self._sched_error

    def _worker(self, rep):
        """Threaded replica loop: step while there is work, sleep-wait
        when idle, freeze when hung (stall injection), exit on kill.  Any
        exception — including ``SimulatedCrash`` — is this replica dying,
        and flows through the same drain/respawn path as pump()'s."""
        try:
            while not rep._kill.is_set():
                if rep.hung:
                    rep._kill.wait(0.01)
                    continue
                if not self._step_replica(rep):
                    rep._wake.wait(0.002)
                    rep._wake.clear()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            self._replica_died(rep, "crash", e)

    def _monitor_loop(self):
        tick = max(0.01, min(0.25, self.heartbeat_timeout_s / 4))
        while not self._monitor_stop.wait(tick):
            try:
                self._supervise(self._stalled())
                if self._pending:
                    for rep in self._candidates():
                        self._flush_pending(rep)
            except Exception:
                counters.inc("serving.fleet.monitor_errors")

    # -- conveniences --------------------------------------------------------
    def has_work(self):
        if self._posted or self._crashed:
            return True
        with self._lock:
            if self._pending:
                return True
            reqs = list(self._requests)
        if any(not f.is_finished for f in reqs):
            return True
        return any(r.engine.has_work() for r in self._alive())

    def join(self, handles, timeout_s=300.0):
        """Run/wait until every handle is terminal."""
        t0 = time.monotonic()
        while not all(h.is_finished for h in handles):
            if self.threaded:
                self._check_scheduler()
                time.sleep(0.002)
            else:
                self.pump()
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(
                    f"fleet.join: {sum(not h.is_finished for h in handles)}"
                    f" requests still live after {timeout_s}s")
        return handles

    def generate(self, prompts, seeds=None, **kw):
        """Blocking batch API mirroring ``LLMEngine.generate``: submit
        every prompt (optionally with per-request seeds — required for
        sampled token-identity comparisons), run to completion, return
        the full sequences (prompt + generated) as np.int32 arrays."""
        hs = []
        for i, p in enumerate(prompts):
            seed = None if seeds is None else seeds[i]
            while True:
                try:
                    hs.append(self.submit(p, seed=seed, **kw))
                    break
                except RetryAfter as e:
                    if self.threaded:
                        time.sleep(e.retry_after_hint or 0.002)
                    else:
                        self.pump()
        self.join(hs)
        return [h.output_ids() for h in hs]

    def drain(self):
        """Graceful shutdown: stop admission, run every admitted request
        to a terminal ``finish_reason``, stop workers/monitor, and audit
        the zero-lost invariant (``serving.fleet.lost`` counts any
        admitted request discovered non-terminal — the chaos gate pins it
        at 0).  Returns every FleetRequest ever admitted.  Idempotent."""
        self._closed = True
        t0 = time.monotonic()
        if self._sched_thread is not None:
            # a threaded mesh fleet's scheduler stops at the tick that
            # finds the closed fleet drained
            with self._posted_cv:
                self._posted_cv.notify_all()
            self._sched_thread.join(timeout=600.0)
        if self._sched_thread is None and self._rz is not None:
            # a pumped multi-rank fleet: rank 0's verdict ends the ticks
            # on every rank at once
            while time.monotonic() - t0 <= 600.0:
                self._stamp()
                if self._tick()[1]:
                    break
        while self._sched_thread is None and self.has_work() \
                and self._rz is None:
            if self.threaded:
                time.sleep(0.002)
                self.check_health()
            else:
                self.pump()
            if time.monotonic() - t0 > 600.0:
                break
        self._monitor_stop.set()
        for rep in self._alive():
            rep._kill.set()
            rep._wake.set()
        if self.threaded:
            if self._monitor_thread is not None:
                self._monitor_thread.join(timeout=5.0)
            with self._lock:
                threads = [r.thread for r in self._replicas if r.thread]
            for t in threads:
                t.join(timeout=5.0)
        with self._lock:
            reqs = list(self._requests)
        for f in reqs:
            if not f.is_finished:
                counters.inc("serving.fleet.lost")
                f._finish("error",
                          RuntimeError("request lost at fleet drain"))
        counters.set_gauge("serving.fleet.replicas", 0)
        return reqs

    close = drain

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    def stats(self):
        """Fleet-wide snapshot: per-replica atomic stats (+ health) and
        the aggregated decode tokens/s, published to the
        ``serving.fleet.decode_tps`` gauge."""
        with self._lock:
            replicas = list(self._replicas)
            pending = len(self._pending)
            total = len(self._requests)
        reps, agg = [], 0.0
        for rep in replicas:
            st = rep.engine.stats()
            st.update(idx=rep.idx, alive=rep.alive, hung=rep.hung,
                      steps=rep.steps, dead_reason=rep.dead_reason,
                      role=rep.role)
            reps.append(st)
            if rep.alive:
                agg += st["decode_tps_ema"]
        counters.set_gauge("serving.fleet.decode_tps", agg)
        out = {"replicas": reps,
               "alive": sum(r.alive for r in replicas),
               "roles": {
                   "prefill": sum(1 for r in replicas
                                  if r.alive and r.role == "prefill"),
                   "decode": sum(1 for r in replicas
                                 if r.alive and r.role == "decode"),
                   "unified": sum(1 for r in replicas
                                  if r.alive and r.role is None),
               },
               "migrated": counters.get("serving.fleet.migrate.requests"),
               "decode_tps": agg,
               "latency": self.router.latency_summary(replicas),
               "pending_retries": pending,
               "requests": total,
               "unfinished": sum(1 for f in self._requests
                                 if not f.is_finished),
               "closed": self._closed,
               "health": self.health.summary()}
        paged = [st for st in reps
                 if st.get("kv_layout") == "paged" and st["alive"]]
        if paged:
            # fleet-wide block-pool / prefix-cache roll-up: sums of the
            # per-replica monotonic counters, pooled utilization, and the
            # derived hit rate the capacity dashboards plot
            hits = sum(st["prefix_hits"] for st in paged)
            misses = sum(st["prefix_misses"] for st in paged)
            used = sum(st["blocks_used"] for st in paged)
            tot = sum(st["blocks_total"] for st in paged)
            out["kv"] = {
                "blocks_total": tot,
                "blocks_used": used,
                "block_utilization": used / max(1, tot),
                "prefix_hits": hits,
                "prefix_misses": misses,
                "prefix_hit_rate": hits / max(1, hits + misses),
                "prefix_hit_tokens": sum(st["prefix_hit_tokens"]
                                         for st in paged),
                "cow_copies": sum(st["cow_copies"] for st in paged),
                "blocks_evicted": sum(st["blocks_evicted"]
                                      for st in paged),
                "pool_exhausted": sum(st["pool_exhausted"]
                                      for st in paged),
                "host_tier_capacity": sum(st.get("host_tier_capacity", 0)
                                          for st in paged),
                "host_tier_blocks": sum(st.get("host_tier_blocks", 0)
                                        for st in paged),
                "host_arena_bytes": sum(st.get("host_arena_bytes", 0)
                                        for st in paged),
                "tier_spilled": sum(st.get("tier_spilled", 0)
                                    for st in paged),
                "tier_restored": sum(st.get("tier_restored", 0)
                                     for st in paged),
            }
        adapted = [st for st in reps
                   if st.get("adapters") is not None and st["alive"]]
        if adapted:
            # fleet-wide adapter-arena roll-up: summed monotonic event
            # counts plus the merged per-tenant occupancy (which tenants
            # are resident where, with how many live references)
            tenants = {}
            for st in adapted:
                for t, refs in st["adapters"]["tenants"].items():
                    ent = tenants.setdefault(t, {"replicas": 0, "refs": 0})
                    ent["replicas"] += 1
                    ent["refs"] += refs
            out["adapters"] = {
                "slots": sum(st["adapters"]["slots"] for st in adapted),
                "resident": sum(st["adapters"]["resident"]
                                for st in adapted),
                "registered": max(st["adapters"]["registered"]
                                  for st in adapted),
                "loads": sum(st["adapters"]["loads"] for st in adapted),
                "hits": sum(st["adapters"]["hits"] for st in adapted),
                "misses": sum(st["adapters"]["misses"] for st in adapted),
                "evictions": sum(st["adapters"]["evictions"]
                                 for st in adapted),
                "exhausted": sum(st["adapters"]["exhausted"]
                                 for st in adapted),
                "load_drops": sum(st["adapters"]["load_drops"]
                                  for st in adapted),
                "arena_bytes": sum(st["adapters"]["arena_bytes"]
                                   for st in adapted),
                "routed": counters.get("serving.fleet.adapter_routed"),
                "tenants": tenants,
            }
        spec = [st for st in reps
                if st.get("speculative") and st["alive"]]
        if spec:
            # fleet-wide acceptance: drafted-token-weighted mean across
            # replicas (NOT a mean of EMAs — a replica that drafted 10x
            # the tokens should weigh 10x), published for SLO dashboards
            drafted = sum(st["spec_drafted"] for st in spec)
            accepted = sum(st["spec_accepted"] for st in spec)
            acc = accepted / max(1, drafted)
            out["spec"] = {
                "spec_k": spec[0]["spec_k"],
                "drafted": drafted,
                "accepted": accepted,
                "acceptance": acc,
            }
            counters.set_gauge("serving.fleet.spec_acceptance", acc)
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.summary()
        # device-time & efficiency plane roll-up: the ledger is process-
        # global (all replicas share the dispatch sites), so the fleet
        # view is just its snapshot — present whenever sampling is (or
        # was) on and left rows behind
        dt = _devicetime.snapshot(top=16)
        if dt["programs"] or dt["sample_every"]:
            out["devicetime"] = dt
        return out
