"""Deterministic, flag-driven fault injection for resilience testing (a
copy of ``paddle_tpu/resilience/faultinject.py``; the port's serving
engine fires ``kv_pool_exhausted``, ``serving_prefill``,
``kv_spill_drop`` and ``adapter_load_drop``).

A process-global *schedule* maps ``(site, index)`` to a number of times the
fault should fire.  Instrumented code calls :func:`maybe_fault(site, index)`
at well-known sites; when the schedule has a live entry for that exact
``(site, index)`` pair the site's exception is raised (and the entry's
remaining count decremented), otherwise the call is a near-free no-op —
``maybe_fault`` returns immediately when no schedule is active, so shipping
the hooks in production paths costs one dict truthiness check.

Schedule specs are strings so they can ride in a flag
(``flags.set_flags({"FLAGS_fault_schedule": ...})``)::

    ckpt_write@1*2;preempt@4;nan_loss@7;loader@5

means: the checkpoint write for save ordinal 1 raises a (transient)
``InjectedWriteError`` twice (attempts 1 and 2 fail, attempt 3 succeeds),
training step 4 ends in a :class:`SimulatedPreemption`, the loss of step 7
is poisoned to NaN, and fetching the batch for step 5 raises
``InjectedLoaderError``.  Every fault is keyed on a deterministic ordinal
(save number, global step, request id) so the same schedule reproduces the
same failure sequence run after run.

Well-known sites
----------------

===================  ====================================================
``ckpt_write``       transient IOError inside the checkpoint write;
                     index = save ordinal.  Retried by CheckpointManager.
``ckpt_crash``       hard crash between chunk write and manifest commit;
                     index = save ordinal.  NOT retried — models a writer
                     killed mid-save (atomicity test).
``preempt``          SimulatedPreemption after a training step; index =
                     global step.  The SIGTERM-shaped fault.
``loader``           InjectedLoaderError fetching a batch; index = global
                     step at which the batch would be consumed.
``nan_loss``         poisons the step's batch so the loss goes NaN; index
                     = global step.  Queried via :func:`take` (the trainer
                     poisons the input rather than raising).
``serving_prefill``  per-request failure inside LLMEngine admission;
                     index = request id.
``replica_crash``    SimulatedCrash of the serving-fleet replica that is
                     decoding fleet request ``index`` — fires on the
                     replica's next health-checked step once the request
                     is active, so the same schedule kills the same
                     point in the stream whatever replica holds it.
``decode_stall``     freezes (hangs) the replica decoding fleet request
                     ``index``: heartbeats stop, the fleet's stall
                     detector must notice and respawn.  Queried via
                     :func:`take` (the replica hangs rather than raises).
``router_queue``     failure inside ServingFleet.submit's routing/enqueue
                     path; index = fleet request id.  Surfaced to the
                     caller as a structured ``RetryAfter`` shed.
``kv_pool_exhausted``  deterministic paged-KV block-pool exhaustion at
                     admission of request ``index``: the reservation is
                     refused as if the pool were dry, the request parks
                     at the queue head (no torn block table), and
                     callers see ``EngineBackpressure`` once the bounded
                     queue backs up.  Queried via :func:`take` (the
                     engine defers rather than raises).
``kv_migrate_drop``  severs a prefill→decode KV migration between the
                     source engine's block-table export and the
                     destination's adopt; index = fleet request id.  The
                     fleet must reconcile refcounts on BOTH pools (the
                     source donates the prompt's blocks to its prefix
                     tree, the destination never allocated) and replay
                     the request by deterministic re-prefill with token
                     identity.
``kv_spill_drop``    drops a spilled block's host-tier copy mid-restore;
                     index = request id (engine rid for prefix-chain
                     restores at admission, fleet request id for
                     idle-spilled exports).  Both tiers must reconcile —
                     host buffers recycle, no device block is ever
                     allocated for the lost data — and the request
                     replays by deterministic re-prefill: a dropped
                     prefix chain becomes a plain cache miss (queried
                     via :func:`take`), a dropped request spill raises
                     ``HostTierLost`` so the fleet requeues it.
``slow_decode``      per-iteration stall of the replica decoding fleet
                     request ``index``: the replica sleeps
                     ``fleet.SLOW_DECODE_STALL_S`` before its decode
                     launch (once per scheduled count) but KEEPS
                     heartbeating — the request limps, finishes late,
                     and its trace must name the ``decode.stall`` spans
                     (the tail-sampling chaos site).  Queried via
                     :func:`take` (the replica stalls rather than
                     raises).
``adapter_load_drop``  LoRA adapter page-in fails mid-admission of
                     request ``index`` (engine rid): the slot is handed
                     back BEFORE any slab write — the request can never
                     see another tenant's weights — and admission defers
                     queued-with-backoff exactly like
                     ``kv_pool_exhausted``; arena refcounts reconcile.
                     Queried via :func:`take` (the engine defers rather
                     than raises).
===================  ====================================================

Every fired fault is appended to :data:`fired` (``(site, index)`` tuples)
and counted under ``resilience.faults_injected`` so tests and gates can
assert exactly which faults fired.

On a serving fleet over a mesh of more than one rank the schedule of
mesh rank 0 governs: :func:`version` moves with every change (a new
schedule, a clear, a firing), and whenever rank 0's has moved or is
active the fleet's tick carries :func:`state` and every other rank
installs it (:func:`install`) before it steps, so every rank fires the same
entries at the same point and keeps the same :data:`fired` and
``resilience.faults_injected.*``.  A schedule set on another rank alone
is replaced at the next tick and fires nothing.
"""

from __future__ import annotations

import os
import signal
import threading

from .. import flags as _flags
from ..profiler import counters as _counters

__all__ = [
    "InjectedFault", "InjectedWriteError", "InjectedLoaderError",
    "SimulatedCrash", "SimulatedPreemption",
    "set_schedule", "clear", "active", "maybe_fault", "take", "fired",
    "fault_schedule", "install_sigterm_handler", "version", "state",
    "install",
]


class InjectedFault(Exception):
    """Base class for all injected faults (recoverable by the trainer)."""


class InjectedWriteError(InjectedFault, IOError):
    """Transient checkpoint-write failure (retryable: an IOError)."""


class InjectedLoaderError(InjectedFault):
    """Data loader raised while fetching a batch."""


class SimulatedPreemption(InjectedFault):
    """The SIGTERM-shaped fault: the worker is being preempted."""


class SimulatedCrash(BaseException):
    """Hard kill mid-operation.  Deliberately NOT an ``Exception`` subclass
    so generic ``except Exception`` recovery/retry paths cannot swallow it —
    it models the process dying, and must unwind like ``KeyboardInterrupt``.
    """


_EXC = {
    "ckpt_write": InjectedWriteError,
    "ckpt_crash": SimulatedCrash,
    "preempt": SimulatedPreemption,
    "loader": InjectedLoaderError,
    "serving_prefill": InjectedFault,
    "replica_crash": SimulatedCrash,
    "decode_stall": InjectedFault,   # consumed via take(); never raised
    "router_queue": InjectedFault,
    "kv_pool_exhausted": InjectedFault,   # consumed via take(); never raised
    "kv_migrate_drop": InjectedFault,
    "kv_spill_drop": InjectedFault,       # consumed via take(); never raised
    "slow_decode": InjectedFault,         # consumed via take(); never raised
    "adapter_load_drop": InjectedFault,   # consumed via take(); never raised
}

_LOCK = threading.Lock()
_SCHEDULE: dict = {}   # (site, index) -> remaining fire count
fired: list = []       # (site, index) log of every fault that fired
_VERSION = [0]         # moves with every change of the schedule or fired


def _parse(spec):
    """``"site@index[*count]; ..."`` -> {(site, index): count}."""
    sched = {}
    for entry in str(spec).replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        try:
            site, rest = entry.split("@", 1)
            if "*" in rest:
                idx, count = rest.split("*", 1)
            else:
                idx, count = rest, 1
            sched[(site.strip(), int(idx))] = int(count)
        except ValueError:
            raise ValueError(
                f"bad fault schedule entry {entry!r}; want "
                "'site@index' or 'site@index*count'") from None
    return sched


def set_schedule(spec):
    """Install a fault schedule: a spec string, a ``{(site, index): count}``
    dict, or ``None``/``""`` to clear."""
    global _SCHEDULE
    with _LOCK:
        if not spec:
            _SCHEDULE = {}
        elif isinstance(spec, dict):
            _SCHEDULE = {(str(s), int(i)): int(c)
                         for (s, i), c in spec.items()}
        else:
            _SCHEDULE = _parse(spec)
        del fired[:]
        _VERSION[0] += 1


def clear():
    set_schedule(None)


def active():
    return bool(_SCHEDULE)


def take(site, index):
    """Consume one scheduled firing of ``(site, index)``.  Returns True if
    the fault was scheduled (caller applies the effect itself — e.g. the
    trainer poisoning a batch to NaN), False otherwise."""
    if not _SCHEDULE:
        return False
    key = (str(site), int(index))
    with _LOCK:
        remaining = _SCHEDULE.get(key, 0)
        if remaining <= 0:
            return False
        if remaining == 1:
            del _SCHEDULE[key]
        else:
            _SCHEDULE[key] = remaining - 1
        fired.append(key)
        _VERSION[0] += 1
    _counters.inc("resilience.faults_injected")
    _counters.inc(f"resilience.faults_injected.{site}")
    return True


def version():
    """A number that moves with every change of the schedule or of
    :data:`fired`."""
    return _VERSION[0]


def state():
    """``(schedule, fired)``: copies of what :func:`install` takes."""
    with _LOCK:
        return dict(_SCHEDULE), list(fired)


def install(schedule, fired_by_src):
    """Take another rank's :func:`state`: its schedule, and its
    :data:`fired`; each firing it holds beyond this rank's own is
    counted here too, under ``resilience.faults_injected``."""
    global _SCHEDULE
    with _LOCK:
        _SCHEDULE = dict(schedule)
        mine = list(fired)
        fired[:] = fired_by_src
    for key in fired_by_src:
        if key in mine:
            mine.remove(key)
        else:
            _counters.inc("resilience.faults_injected")
            _counters.inc(f"resilience.faults_injected.{key[0]}")


def maybe_fault(site, index):
    """Raise the site's exception if the schedule says ``(site, index)``
    should fail now; no-op (one dict check) otherwise."""
    if not _SCHEDULE:
        return
    if take(site, index):
        exc = _EXC.get(str(site), InjectedFault)
        raise exc(f"injected fault: {site}@{index}")


class fault_schedule:
    """Context manager installing a schedule for the enclosed block::

        with faultinject.fault_schedule("preempt@4"):
            trainer.run()
    """

    def __init__(self, spec):
        self._spec = spec

    def __enter__(self):
        set_schedule(self._spec)
        return self

    def __exit__(self, *exc):
        clear()
        return False


def install_sigterm_handler():
    """Convert a real SIGTERM into a :class:`SimulatedPreemption` raised in
    the main thread, so a preempting scheduler flows through the same
    recovery path as the injected fault.  Returns the previous handler."""
    def _handler(signum, frame):
        raise SimulatedPreemption(f"SIGTERM received (pid {os.getpid()})")
    return signal.signal(signal.SIGTERM, _handler)


# Flag driven schedule: set_flags({"FLAGS_fault_schedule": "preempt@4"})
_flags.register_flag_observer("FLAGS_fault_schedule",
                              lambda v: set_schedule(v or None))
