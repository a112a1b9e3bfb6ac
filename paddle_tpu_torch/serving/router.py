"""SLO-aware request router for the serving fleet (port of
``paddle_tpu/serving/router.py``).

Pure policy over per-replica ``LLMEngine.stats()`` snapshots (each one
atomic: one lock acquisition a replica):

* **Least-outstanding-tokens dispatch** — a replica's load is its
  undelivered-token backlog (remaining ``max_new_tokens`` over queued and
  active requests), not its request count.  Ties break toward the lowest
  replica index.
* **Bounded per-replica queues** — a replica whose admission queue is
  full is no candidate; when every queue is full the router refuses with
  a structured :class:`RetryAfter`.
* **SLO-aware admission** — from the chosen replica's decode tokens/s EMA
  the router estimates when the request would complete; one whose
  deadline budget that estimate already blows is shed up front with a
  ``RetryAfter`` hint.  Shedding needs an EMA (a cold fleet admits
  everything).
* **Health actions** — at the health plane's admission level
  ``degraded`` the shed margin tightens, at ``critical`` new admissions
  are refused (replays still route).
* **Roles and affinity** — ``role=`` narrows dispatch to prefill or
  decode replicas; the prompt's prefix held on a replica (device or host
  tier, ``prefix_probe``) and a tenant's resident adapter
  (``adapter_peek``) discount that replica's backlog.
"""

from __future__ import annotations

from ..profiler import counters
from ..profiler.metrics import Histogram
from .engine import EngineBackpressure

__all__ = ["RetryAfter", "Router"]


class RetryAfter(EngineBackpressure):
    """Structured admission refusal from the fleet router.

    ``reason`` is one of:

    * ``"slo"`` — the deadline budget is already blown by the estimated
      queue delay (load shed; counted under ``serving.fleet.shed``);
    * ``"backpressure"`` — every replica's bounded queue is full;
    * ``"health"`` — the health plane's admission level is ``critical``
      and this is a new admission (counted under
      ``serving.fleet.health_shed``; ``shed=False`` replays still pass);
    * ``"router_queue"`` — injected ``router_queue`` fault (chaos tests).

    ``queue_depth`` and ``retry_after_hint`` are inherited from
    :class:`EngineBackpressure`; the hint says how many seconds until the
    fleet expects to have drained enough backlog to admit the request.
    """

    def __init__(self, msg="", queue_depth=0, retry_after_hint=None,
                 reason="slo"):
        super().__init__(msg, queue_depth, retry_after_hint)
        self.reason = reason


class Router:
    """Least-outstanding-tokens dispatch + SLO-aware load shedding.

    ``slo_margin`` scales the estimated completion time before comparing
    it to the deadline budget (>1.0 sheds earlier / more conservatively).
    ``degraded_factor`` further scales that margin while the health
    plane's admission level is ``degraded`` — the router tightens its own
    shed threshold on its own signal (see :meth:`pick`).
    ``restore_cost`` prices host-tier prefix hits for the fleet-global
    prefix economy: a device-resident cached token discounts a
    candidate's backlog by 1.0, a host-resident one by ``1.0 -
    restore_cost`` (it still beats re-prefilling elsewhere, but a page-in
    is not free).  0.0 treats the tiers as equal, 1.0 ignores the host
    tier entirely.
    """

    def __init__(self, slo_margin=1.0, degraded_factor=2.0,
                 restore_cost=0.5):
        self.slo_margin = float(slo_margin)
        self.degraded_factor = float(degraded_factor)
        self.restore_cost = min(1.0, max(0.0, float(restore_cost)))
        # the owning ServingFleet installs its HealthMonitor here; the
        # routing policy ACTS on its admission level (degraded tightens
        # the SLO shed margin, critical refuses new admissions) and
        # stats() exposes the same view
        self.health = None

    def _admission_level(self):
        """Current health-plane admission level, ``"ok"`` when the plane
        is absent or disabled (``FLAGS_health=0`` keeps the router's
        behavior bitwise identical to the pre-health fleet)."""
        if self.health is None:
            return "ok"
        from ..profiler import health as _health
        if not _health.enabled():
            return "ok"
        return self.health.admission_level()

    def stats(self):
        """Router-level observability: the health plane's admission view
        (``{"health": {..., "admission_level": "ok" | "degraded" |
        "critical"}}``).  The routing policy acts on it in :meth:`pick`:
        ``degraded`` multiplies the SLO shed margin by
        ``degraded_factor``, ``critical`` admits only ``shed=False``
        replays (``serving.fleet.health_shed``)."""
        if self.health is None:
            return {"health": {"enabled": False, "admission_level": "ok",
                               "alerts": [], "ticks": 0}}
        return {"health": self.health.summary()}

    @staticmethod
    def aggregate_histograms(replicas):
        """Merge the per-engine latency/occupancy histograms across
        replicas into fleet-wide ``Histogram``s, keyed by metric name
        (``serving.ttft_ns``, ``serving.itl_ns``, ...).  Dead replicas
        merge too: latency a client already experienced counts toward the
        fleet percentiles whatever later happened to the replica."""
        agg = {}
        for rep in replicas:
            for name, h in rep.engine.histogram_snapshot().items():
                if name not in agg:
                    agg[name] = Histogram(name, h.unit)
                agg[name].merge(h)
        return agg

    @staticmethod
    def latency_summary(replicas):
        """``{name: {count, mean, min, max, p50, p95, p99}}`` over the
        merged fleet histograms (the fleet ``stats()`` embeds this)."""
        return {n: h.summary()
                for n, h in Router.aggregate_histograms(replicas).items()}

    @staticmethod
    def observability_summary(replicas):
        """One merged observability view over the fleet: the latency
        summary above plus the kept request-trace stage breakdown (which
        hop — queue / prefill / decode — ate the tail; empty when request
        tracing is off).  The ops endpoint and the bench fleet leg both
        read this instead of re-aggregating per replica."""
        from ..profiler import trace as rtrace
        return {
            "latency": Router.latency_summary(replicas),
            "traces_kept": len(rtrace.kept_ids()),
            "trace_sample_rate": rtrace.sample_rate(),
            "stage_breakdown": rtrace.stage_breakdown(),
        }

    def pick(self, replicas, est_tokens=0, deadline_s=None, shed=True,
             prompt=None, role=None, adapter=None):
        """Choose a replica for a request costing ``est_tokens`` decode
        tokens.  ``replicas`` is the candidate list (alive + warmed).
        Raises :class:`RetryAfter` when every queue is full or — with
        ``shed=True`` and a ``deadline_s`` budget — when the SLO estimate
        says the request cannot finish in time.  Requeued (already
        admitted) requests route with ``shed=False``: they must reach a
        terminal state, never be shed.

        The router acts on its own health signal: at admission level
        ``degraded`` the SLO margin is multiplied by ``degraded_factor``
        (shedding earlier while the fleet burns error budget), at
        ``critical`` every ``shed=True`` admission is refused outright
        with ``reason="health"`` (``serving.fleet.health_shed``, also
        counted under the umbrella ``serving.fleet.shed``) — only
        ``shed=False`` replays, which must reach a terminal state, still
        route.

        ``role`` narrows dispatch to replicas of that fleet role
        (``"prefill"`` / ``"decode"``); unified (role-less) replicas are
        the fallback when no replica of the requested role is alive, and
        the full list is the last resort — a disaggregated fleet
        degrades to unified routing rather than refusing.

        With ``prompt`` (the request's token ids) the score becomes a
        prefix-economy cost model: each candidate's backlog is discounted
        by the prompt tokens its paged radix tree could serve
        (``LLMEngine.prefix_probe``; ``(0, 0)`` under the slot layout) —
        device-resident tokens at full weight, host-tier-resident tokens
        discounted by ``restore_cost`` (they save the prefill FLOPs but
        pay a page-in) — so shared-prompt traffic gravitates to the
        replica already holding the longest prefix on EITHER tier instead
        of re-prefilling it elsewhere.  A pick won on a nonzero discount
        counts ``serving.fleet.prefix_routed``.

        ``adapter`` extends the same cost model with tenant affinity:
        a candidate whose adapter arena already holds the tenant's LoRA
        factors gets an ``LLMEngine.adapter_peek`` token bonus (the cold
        page-in it would not pay), so same-tenant traffic gravitates to
        warm replicas; a pick won on a nonzero adapter bonus counts
        ``serving.fleet.adapter_routed``.
        """
        level = self._admission_level()
        if level == "critical" and shed:
            counters.inc("serving.fleet.health_shed")
            counters.inc("serving.fleet.shed")
            raise RetryAfter(
                "shed: health plane admission level is critical — only "
                "in-flight replays are admitted",
                queue_depth=0, retry_after_hint=None, reason="health")
        if role is not None:
            roled = [r for r in replicas
                     if getattr(r, "role", None) == role]
            if not roled:
                roled = [r for r in replicas
                         if getattr(r, "role", None) is None]
            replicas = roled or replicas
        cands, hints, depths = [], [], []
        for rep in replicas:
            st = rep.engine.stats()     # atomic per-replica snapshot
            if st["closed"]:
                continue
            depths.append(st["queued"])
            if st["decode_tps_ema"] > 0:
                hints.append(st["outstanding_tokens"]
                             / st["decode_tps_ema"])
            if st["queued"] >= rep.engine.queue_size:
                continue                # bounded queue full: not a candidate
            peek = 0.0
            if prompt is not None:
                probe = getattr(rep.engine, "prefix_probe", None)
                if probe is not None:
                    dev, host = probe(prompt, tenant=adapter)
                    peek = dev + (1.0 - self.restore_cost) * host
                else:
                    peek = rep.engine.prefix_peek(prompt, tenant=adapter)
            apeek = 0.0
            if adapter is not None:
                apeek = getattr(rep.engine, "adapter_peek",
                                lambda t: 0)(adapter)
            cands.append((st["outstanding_tokens"] - peek - apeek,
                          rep.idx, rep, st, peek, apeek))
        if not cands:
            raise RetryAfter(
                "every replica queue is full",
                queue_depth=min(depths) if depths else 0,
                retry_after_hint=min(hints) if hints else None,
                reason="backpressure")
        cands.sort(key=lambda t: (t[0], t[1]))
        _, _, rep, st, peek, apeek = cands[0]
        if peek > 0:
            counters.inc("serving.fleet.prefix_routed")
        if apeek > 0:
            counters.inc("serving.fleet.adapter_routed")
        backlog = st["outstanding_tokens"]   # SLO math on the REAL backlog
        if shed and deadline_s is not None and st["decode_tps_ema"] > 0:
            tps = st["decode_tps_ema"]
            acc = st.get("spec_acceptance_ema")
            yld = st.get("spec_yield_ema", 0.0)
            if acc is not None and yld > 0:
                # speculative replica: the tokens/s EMA was measured at
                # the RECENT per-round yield, but the yield a NEW request
                # gets depends on how its drafts fare — re-anchor the
                # throughput estimate from the observed yield to the
                # acceptance-implied expected yield.  Under the per-token
                # acceptance model a round emits 1 + sum_{i=1..k} acc^i
                # tokens in expectation (the prefix geometric sum, NOT
                # 1 + acc*k, which overestimates and would delay
                # shedding), so a yield collapse (adversarial prompts)
                # sheds earlier and a hot draft admits more
                k = st.get("spec_k", 0)
                if acc >= 1.0:
                    exp_yield = 1.0 + float(k)
                else:
                    exp_yield = (1.0 + acc * (1.0 - acc ** k)
                                 / (1.0 - acc))
                tps = tps * exp_yield / max(yld, 1e-6)
            est_done_s = (backlog + est_tokens) / tps
            margin = self.slo_margin * (self.degraded_factor
                                        if level == "degraded" else 1.0)
            if est_done_s * margin > float(deadline_s):
                counters.inc("serving.fleet.shed")
                raise RetryAfter(
                    f"shed: estimated completion {est_done_s:.3f}s exceeds "
                    f"deadline budget {float(deadline_s):.3f}s "
                    f"(backlog {backlog} tokens @ "
                    f"{st['decode_tps_ema']:.1f} tok/s)",
                    queue_depth=st["queued"],
                    retry_after_hint=max(0.0, backlog
                                         / st["decode_tps_ema"]),
                    reason="slo")
        return rep
