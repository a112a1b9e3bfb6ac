"""FaultTolerantTrainer: a training loop that survives faults and
resumes bit for bit (port of ``paddle_tpu/resilience/trainer.py``).

The loop drives a ``jit.CompiledTrainStep`` from a deterministic data
loader (through ``io.DevicePrefetcher``, or ``io.StackingPrefetcher``
for ``fused_steps > 1``, onto the step's device), checkpoints the
complete training state every ``save_every`` steps through a
:class:`~.manager.CheckpointManager`, and on a recoverable fault
(preemption, a loader exception, a non-finite loss, the NaN guard's
``FloatingPointError``) restores the last good checkpoint, replays the
data iterator to the saved offset and continues.  Because the
checkpoint holds the whole state and the replayed batches are the same
(a deterministic loader and ``start_offset``), the resumed losses are
bit for bit the uninterrupted run's.

Determinism contract: ``loader_factory(epoch)`` yields the same batches
in the same order every time it is called with the same epoch (a
``DataLoader`` with ``shuffle=False``, or a seeded per-epoch sampler).

Fault sites (``resilience.faultinject``): ``loader`` (raises fetching
step k's batch), ``preempt`` (``SimulatedPreemption`` after step k),
``nan_loss`` (NaN-fills step k's float batch leaves; integer leaves such
as token ids pass through, so it poisons nothing on a GPT batch).

**Over a mesh** (a step built with ``mesh=``): every rank runs the
trainer on the same loader (the step takes each rank's rows).  The
fault schedules are indexed by step, not by clock, so a fault fires at
the same step on every rank; a non-finite loss is the mean over the
ranks, so every rank sees it.  Every rank restores the step rank 0
chose (``CheckpointManager.restore``), and the manager's saves and
restores are collective, so the ranks stay in step.  A rank process
that dies (a crash, a lost card) is not recovered here: the others wait
in their next collective until its timeout; elastic training is
ROADMAP.md A7h.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..io import DevicePrefetcher, StackingPrefetcher, Window
from ..profiler import counters as _counters
from ..profiler import flight as _flight
from ..profiler import host_tracer as _trace
from ..profiler.goodput import GoodputLedger
from . import faultinject as _fi

__all__ = ["FaultTolerantTrainer", "NonFiniteLossError"]


class NonFiniteLossError(RuntimeError):
    """A training step produced a NaN/Inf loss (poisoned batch)."""


def _poison_leaf(t):
    """NaN-fill floating leaves; integer leaves pass through."""
    data = t._data if isinstance(t, Tensor) else t
    if isinstance(data, torch.Tensor) and data.is_floating_point():
        nan = torch.full_like(data, float("nan"))
        return Tensor._wrap(nan) if isinstance(t, Tensor) else nan
    return t


class FaultTolerantTrainer:
    """Run ``train_step`` over ``loader_factory`` with automatic recovery.

    Parameters
    ----------
    train_step: a ``jit.CompiledTrainStep``.
    loader_factory: ``callable(epoch) -> iterable`` of batches (tuples of
        tensors or numpy arrays), or a re-iterable loader used for every
        epoch.  Must be deterministic per epoch (module docstring).
    manager: a :class:`~.manager.CheckpointManager`.
    scheduler: optional LRScheduler, stepped once a training step after
        the step (a fused window steps it ``k`` times).
    epochs / max_steps: run length (whichever comes first).
    save_every: checkpoint every N global steps (at window ends); the
        manager's ``async_save`` decides whether the write overlaps the
        next window.  A step-0 checkpoint is written first, so a fault
        before the first periodic save can still recover.
    max_recoveries: re-raise after this many recoveries.
    recoverable: exception classes that trigger restore-and-resume; the
        default covers injected faults, the NaN guard
        (``FloatingPointError``) and :class:`NonFiniteLossError`.
        ``faultinject.SimulatedCrash`` is a ``BaseException`` and is
        never caught: a crash kills the process, recovery happens on
        restart.
    """

    def __init__(self, train_step, loader_factory, manager, *,
                 scheduler=None, epochs=1, max_steps=None, save_every=8,
                 max_recoveries=8, prefetch_depth=2, recoverable=None,
                 install_sigterm=False):
        self.step = train_step
        self.loader_factory = loader_factory
        self.manager = manager
        self.scheduler = scheduler
        self.epochs = int(epochs)
        self.max_steps = None if max_steps is None else int(max_steps)
        self.save_every = int(save_every)
        self.max_recoveries = int(max_recoveries)
        self.prefetch_depth = int(prefetch_depth)
        self.recoverable = tuple(recoverable) if recoverable is not None \
            else (_fi.InjectedFault, FloatingPointError, NonFiniteLossError)
        if install_sigterm:
            _fi.install_sigterm_handler()
        self.global_step = 0
        self.losses = {}  # 1-based global step -> float loss
        self.recoveries = 0
        self._epoch = 0
        self._offset = 0  # batches consumed in the current epoch
        self._last_saved = -1
        # wall-clock goodput accounting over run() (profiler.goodput)
        self.goodput = GoodputLedger()
        self._compiled_once = False
        self._prefetchers = []

    @property
    def replayed_batches(self):
        """Batches this trainer's prefetchers pulled from the loader to
        replay to a saved offset (its own share of the process-wide
        ``io.skipped_batches``)."""
        return sum(p.skipped for p in self._prefetchers)

    # -- plumbing ------------------------------------------------------------
    def _make_loader(self, epoch):
        lf = self.loader_factory
        return lf(epoch) if callable(lf) else lf

    def _make_prefetcher(self, loader, offset):
        k = int(getattr(self.step, "fused_steps", 1))
        dev = self.step._device()
        if k > 1:
            pref = StackingPrefetcher(loader, k, device=dev,
                                      start_offset=offset)
            self._prefetchers.append(pref._pref)
        else:
            pref = DevicePrefetcher(loader, depth=self.prefetch_depth,
                                    device=dev, start_offset=offset)
            self._prefetchers.append(pref)
        return pref

    def _save(self, offset, blocking=None):
        self.manager.save(self.step, self.global_step,
                          scheduler=self.scheduler,
                          cursor={"epoch": self._epoch, "offset": offset},
                          blocking=blocking)
        self._last_saved = self.global_step

    def _apply(self, info):
        self.global_step = int(info["step"])
        cur = info["cursor"]
        self._epoch = int(cur.get("epoch", 0))
        self._offset = int(cur.get("offset", 0))
        self._last_saved = self.global_step

    def _recover(self, exc):
        _counters.inc("resilience.recoveries")
        _counters.inc(f"resilience.recovered.{type(exc).__name__}")
        # the postmortem first, while the ring still holds the events
        # leading into the fault (the restore appends its own)
        _flight.dump("trainer_recover", {
            "error": f"{type(exc).__name__}: {exc}",
            "global_step": self.global_step,
            "epoch": self._epoch,
            "offset": self._offset,
            "recoveries": self.recoveries,
        })
        # a failing async save must not mask the recovery: the checkpoint
        # set on disk is what matters now
        self.manager.wait(suppress=True)
        with self.goodput.bucket("restore_replay"):
            info = self.manager.restore(self.step, scheduler=self.scheduler)
        if info is None:
            raise exc
        self._apply(info)

    # -- the loop ------------------------------------------------------------
    def run(self):
        """Train to the end, recovering from faults.  Returns the
        ``{global_step: loss}`` dict (replayed steps overwrite their own
        entries with the same values)."""
        self.goodput.start()
        try:
            # the whole run under "idle" (the buckets inside take their
            # own time out of it), so that what runs between them, such
            # as the unwinding of a faulted window and its prefetcher's
            # teardown, is attributed and the accounting closes however
            # the host schedules the process
            with self.goodput.bucket("idle"):
                self._run()
        finally:
            self.goodput.stop()
        return self.losses

    def _run(self):
        if self.manager.latest() is not None:
            with self.goodput.bucket("restore_replay"):
                info = self.manager.restore(self.step,
                                            scheduler=self.scheduler)
            self._apply(info)
        else:
            with self.goodput.bucket("ckpt_sync"):
                self._save(self._offset, blocking=True)
        while True:
            try:
                self._train()
                break
            except self.recoverable as exc:
                self.recoveries += 1
                if self.recoveries > self.max_recoveries:
                    raise
                with self.goodput.bucket("recovery"):
                    self._recover(exc)
        with self.goodput.bucket("ckpt_sync"):
            self.manager.wait()

    def _done(self):
        return self.max_steps is not None and self.global_step >= self.max_steps

    def _train(self):
        # the loop runs under "idle" so scaffolding is attributed; the
        # work nests in data_wait / compile / step / ckpt_sync
        sentinel = object()
        with self.goodput.bucket("idle"):
            while self._epoch < self.epochs and not self._done():
                loader = self._make_loader(self._epoch)
                pref = self._make_prefetcher(loader, self._offset)
                it = iter(pref)
                while True:
                    with self.goodput.bucket("data_wait"):
                        item = next(it, sentinel)
                    if item is sentinel:
                        break
                    self._one_window(item, pref.consumed)
                    self._offset = pref.consumed
                    if self._done():
                        break
                if not self._done():
                    self._epoch += 1
                    self._offset = 0
            if self.global_step != self._last_saved:
                with self.goodput.bucket("ckpt_sync"):
                    self._save(self._offset, blocking=True)

    def _one_window(self, item, consumed_after):
        gs0 = self.global_step
        # fault site: the loader raised fetching step gs0+1's batch
        _fi.maybe_fault("loader", gs0 + 1)
        k = item.k if isinstance(item, Window) else 1
        if any(_fi.take("nan_loss", gs0 + i + 1) for i in range(k)):
            if isinstance(item, Window):
                item = Window(tuple(_poison_leaf(t) for t in item), item.k)
            else:
                item = tuple(_poison_leaf(t) for t in item)
        bname = "step" if self._compiled_once else "compile"
        with self.goodput.bucket(bname), _trace.span("resilience.window"):
            if isinstance(item, Window):
                losses = self.step(item)
            elif isinstance(item, (tuple, list)):
                losses = self.step(*item)
            else:
                losses = self.step(item)
            vals = np.atleast_1d(losses.detach().float().cpu().numpy())
        self._compiled_once = True
        if not np.all(np.isfinite(vals)):
            raise NonFiniteLossError(
                f"non-finite loss at steps {gs0 + 1}..{gs0 + k}: {vals}")
        for i in range(k):
            self.losses[gs0 + i + 1] = float(vals[i])
        if self.scheduler is not None:
            for _ in range(k):
                self.scheduler.step()
        self.global_step = gs0 + k
        if self.save_every > 0 and \
                self.global_step - self._last_saved >= self.save_every:
            with self.goodput.bucket("ckpt_sync"):
                self._save(consumed_after)
        # fault site: preemption lands after the step (and after any
        # periodic save), like a SIGTERM between steps
        for i in range(k):
            _fi.maybe_fault("preempt", gs0 + i + 1)
