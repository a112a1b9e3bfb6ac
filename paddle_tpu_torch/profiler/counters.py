"""Process-global counter/gauge registry (the subset of
``paddle_tpu/profiler/counters.py`` the ported paths tick).

The engine bumps the same ``serving.*`` names as the JAX engine —
``serving.decode_steps``, ``serving.decode_tokens``,
``serving.kv.prefill_chunks``, ``serving.kv.prefix_hits``,
``serving.kv.prefix_hit_tokens``, ``serving.kv.cow_copies``,
``serving.kv.blocks_evicted``, ``serving.kv.pool_exhausted``, and with
quantized KV the counters ``serving.kv.quant.prefill_tokens`` and
``.decode_tokens`` and the gauges ``serving.kv.quant.arena_bytes`` and
``.bytes_saved`` — so a test can diff both registries around the same
traffic.  The speculative engine ticks ``serving.spec.draft_steps``,
``.verify_steps``, ``.drafted``, ``.accepted``, ``.rejected``,
``.rollback_blocks``, ``.draft_starved`` and ``.draft_prefill_chunks``,
and sets the gauges ``serving.spec.acceptance`` and ``.yield`` (EMAs).

Training ticks ``jit.steps`` and ``jit.host.dispatches`` (one each per
``CompiledTrainStep`` call) and ``optimizer.steps`` (one per
``Optimizer.step``), under the JAX names, and
``kernels.flash.reference_fallbacks`` (one per ``flash_attention_fwd``
call that takes ``reference_attention`` because S % 128 != 0).

The fleet (``serving.fleet``) ticks ``serving.fleet.dispatched``,
``.shed``, ``.health_shed``, ``.retried``, ``.respawns``,
``.replica_deaths[.<reason>]``, ``.heartbeat_misses``,
``.completed[.<reason>]``, ``.replayed_tokens``, ``.warmup_requests``,
``.monitor_errors``, ``.replay_divergence``, ``.prefix_routed``,
``.adapter_routed``, ``.slow_decode_stalls``, ``.lost`` (must stay 0) and
``serving.fleet.migrate.requests``, ``.blocks_copied``,
``.blocks_shared``, ``.tokens``, ``.deferred``, ``.dropped``,
``.failed``; gauges ``serving.fleet.replicas``, ``.decode_tps``,
``.spec_acceptance``.  The autoscaler ticks
``serving.autoscale.decisions[.<action>]``, ``.flips.to_prefill``,
``.flips.to_decode``, ``.spawns``, ``.retires`` and sets the gauges
``serving.autoscale.prefill_replicas`` / ``.decode_replicas``.  The
health plane ticks ``health.ticks``, ``health.alerts.fired[.<rule>]``,
``health.alerts.resolved[.<rule>]`` and sets ``health.admission_level``
(0 ok, 1 degraded, 2 critical); the flight recorder ``flight.dumps
[.<reason>]``; request tracing ``trace.started``, ``.finished``,
``.kept``, ``.kept.head``, ``.kept.tail``, ``.dropped``, ``.spans``; the
device-time ledger ``jit.devicetime.dispatches`` and
``jit.devicetime.sampled_syncs``.  All under the JAX names.

:func:`allreduce` sums every rank's registry (every rank calls).
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_COUNTERS: dict[str, float] = {}
_GAUGES: dict[str, float] = {}


def inc(name: str, value=1):
    """Bump a monotonic counter (thread-safe)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def set_gauge(name: str, value):
    """Set a point-in-time gauge (last-write-wins)."""
    with _LOCK:
        _GAUGES[name] = value


def get(name: str, default=0):
    with _LOCK:
        return _COUNTERS.get(name, _GAUGES.get(name, default))


def snapshot() -> dict:
    """Copy of every counter and gauge — the unit of delta accounting."""
    with _LOCK:
        out = dict(_COUNTERS)
        out.update(_GAUGES)
        return out


def delta(before: dict, after: dict | None = None) -> dict:
    """Per-name movement between two snapshots (``after`` defaults to now).
    Names absent from ``before`` count from 0; zero deltas are dropped."""
    if after is None:
        after = snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d != 0:
            out[k] = d
    return out


def allreduce(group=None) -> dict:
    """Every rank's counters and gauges summed name by name (the fleet
    view; every member of ``group``, default the whole world, calls).
    One process, or no process group: :func:`snapshot`."""
    import torch.distributed as dist
    local = snapshot()
    if not (dist.is_available() and dist.is_initialized()):
        return local
    from ..distributed.communication import _nranks, all_gather_object
    if _nranks(group) <= 1:
        return local
    gathered: list = []
    all_gather_object(gathered, local, group=group)
    out: dict = {}
    for snap in gathered:
        for k, v in snap.items():
            out[k] = out.get(k, 0) + v
    return out
