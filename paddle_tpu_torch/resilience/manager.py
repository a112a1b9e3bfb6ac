"""CheckpointManager: complete-training-state snapshots with atomic
commit, async writes, checksums, retry and keep-last-N GC (port of
``paddle_tpu/resilience/manager.py``).

A complete snapshot of a ``jit.CompiledTrainStep`` run is its model's
parameters and persistent buffers, the optimizer's accumulators, fp32
master weights, step count and group lr tensors, the ``GradScaler``
state, the scheduler's position, every device's default generator, the
model's dropout generator and the data-iterator cursor.  The manager
reads it at one counted ``step.sync()`` and restores it so that the
resumed run's losses are bit for bit the uninterrupted run's.

Layout (one directory a save, committed by an atomic directory
rename; the JAX package's)::

    root/
      step-00000004/               <- committed (manifest present)
        MANIFEST.json              <- host scalars + per-array shape/dtype
        0_0.0.distcp.npz           <- chunk data (distributed.checkpoint)
        0.0.metadata.json          <- chunk index with per-chunk crc32
      .tmp-step-00000008/          <- in-flight or crashed save: ignored

Write protocol: stage everything into ``.tmp-step-N`` (the
``distributed.checkpoint`` writer fsyncs its chunk and metadata files),
write ``MANIFEST.json`` through tmp + fsync + rename, then rename the
staging directory to ``step-N``: the commit point.  A writer killed at
any earlier moment leaves only an ignored ``.tmp-`` directory, which
the next successful save removes.  A transient ``OSError`` is retried
with exponential backoff (``resilience.retries``).

The snapshot: the next window updates the same tensors in place, so
``save()`` returns only once every tensor has been copied to the host.
The copies go into pinned host buffers with ``non_blocking=True`` on the
caller's stream (ordered after the step's windows), followed by one
stream synchronize; a save first joins the previous writer, so one set
of buffers serves every save.  With ``async_save`` only the disk work
(crc32, ``np.savez``, fsync, rename) runs on the writer thread.

On restore every chunk's crc32 is checked (a mismatch raises
``CheckpointCorrupt`` naming the chunk, counted under
``resilience.corrupt_detected``) and the manager falls back to the next
older committed checkpoint.  Optimizer entries are keyed ``p<i>`` by the
parameter's position (auto-generated names differ between processes).
A restore writes the parameters in place, drops the accumulators and
masters the checkpoint lacks (as a fresh optimizer has none), and has
the step drop its captured CUDA graphs (``restore_resume_state``).
Random states are saved under port keys (``rng/device/<device>``,
``rng/dropout``); a JAX save's ``rng/*`` keys are not read.

Counters, histograms, flight records and spans under the JAX names:
``resilience.saves``, ``.retries``, ``.save_failures``, ``.gc_removed``,
``.restores``, ``.corrupt_detected``; histograms ``resilience.save_ms``
(the write) and ``resilience.restore_ms``, and the port's
``resilience.snapshot_ms`` (the host copies); flight ``ckpt.save`` and
``ckpt.restore``; spans ``resilience.snapshot``, ``resilience.save``,
``resilience.restore``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

from ..distributed import checkpoint as _dckpt
from ..profiler import counters as _counters
from ..profiler import flight as _flight
from ..profiler import host_tracer as _trace
from ..profiler import metrics as _metrics
from ..tensor import random as _random
from . import faultinject as _fi

CheckpointCorrupt = _dckpt.CheckpointCorrupt

_STEP_DIR = re.compile(r"^step-(\d{8})$")
_TMP_PREFIX = ".tmp-"
_MANIFEST = "MANIFEST.json"


class CheckpointWriteError(RuntimeError):
    """A checkpoint save failed permanently (retries exhausted)."""


class CheckpointLayoutError(RuntimeError):
    """The checkpoint's array layout does not fit the live training state
    (a leaf's shape differs: a different model).  Not a reason to fall
    back to an older checkpoint: every save of the run would mismatch
    alike, so the manager raises at once."""


def model_state(model):
    """The model's parameters and persistent buffers by name (the torch
    tensors themselves, as ``Layer.state_dict`` names them)."""
    out = dict(torch.nn.Module.named_parameters(model))
    for mname, mod in torch.nn.Module.named_modules(model):
        for bname, b in mod._buffers.items():
            if b is not None and bname not in mod._non_persistent_buffers_set:
                out[f"{mname}.{bname}" if mname else bname] = b
    return out


def _dev_key(dev):
    return str(dev).replace(":", "_")


def _live_tensors(train_step):
    """Every device tensor of a snapshot, by checkpoint key."""
    opt = train_step.optimizer
    out = {f"model/{n}": t for n, t in model_state(train_step.model).items()}
    pos = {id(p): f"p{i}" for i, p in enumerate(opt._parameter_list)}
    for acc, store in opt._accumulators.items():
        for pid, t in store.items():
            out[f"opt/acc/{acc}/{pos[pid]}"] = t
    for pid, t in opt._master_weights.items():
        out[f"opt/master/{pos[pid]}"] = t
    for i, t in enumerate(opt._lr_tensors):
        out[f"opt/lr/{i}"] = t
    return out


class CheckpointManager:
    """Snapshot/restore the complete state of a ``jit.CompiledTrainStep``.

    Parameters
    ----------
    root: checkpoint directory (created if missing).
    keep_last: retain this many newest committed checkpoints.
    async_save: default for ``save(blocking=...)``: the disk write runs
        on a background thread, overlapping the next window.
    retries / backoff_s: a transient ``OSError`` write is retried up to
        ``retries`` times, backing off from ``backoff_s`` seconds.
    """

    def __init__(self, root, keep_last=3, async_save=False, retries=3,
                 backoff_s=0.01):
        self.root = str(root)
        self.keep_last = int(keep_last)
        self.async_save = bool(async_save)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        os.makedirs(self.root, exist_ok=True)
        self._thread = None
        self._error = None
        self._save_ordinal = 0  # deterministic index for fault schedules
        self._host = {}         # key -> host (pinned) buffer, reused

    # -- discovery -----------------------------------------------------------
    def _committed(self):
        """Sorted committed save step numbers."""
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.root, name, _MANIFEST)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _dir(self, step_no):
        return os.path.join(self.root, f"step-{step_no:08d}")

    def latest(self):
        """Newest committed checkpoint's global step, or None."""
        steps = self._committed()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, train_step, global_step, *, scheduler=None, cursor=None,
             blocking=None):
        """Snapshot the complete training state at ``global_step``.

        The snapshot (one ``sync()`` and the host copies) happens on the
        calling thread; with ``blocking=False`` the disk write runs on a
        daemon thread (one at a time: a save first joins the previous
        writer).  ``cursor`` is the data-iterator position, e.g.
        ``{"epoch": 0, "offset": 12}`` (``io.DevicePrefetcher.consumed``).
        """
        if blocking is None:
            blocking = not self.async_save
        self.wait()  # one writer at a time; surfaces a prior async failure
        ordinal = self._save_ordinal
        self._save_ordinal += 1
        t0 = time.perf_counter()
        with _trace.span("resilience.snapshot"):
            arrays, manifest = self._snapshot(train_step, int(global_step),
                                              scheduler, cursor)
        _metrics.observe("resilience.snapshot_ms",
                         (time.perf_counter() - t0) * 1000, unit="ms")
        if blocking:
            self._write(arrays, manifest, int(global_step), ordinal)
        else:
            def _guarded():
                try:
                    self._write(arrays, manifest, int(global_step), ordinal)
                except BaseException as e:  # surfaced by wait()/next save
                    self._error = e
            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()

    def _host_copy(self, key, t):
        """``t`` copied (queued) into this key's reused host buffer."""
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._host[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        buf.copy_(t.detach(), non_blocking=True)
        return buf

    def _snapshot(self, train_step, global_step, scheduler, cursor):
        """``(arrays, manifest)``: host tensors by key, and the manifest.
        ``export_resume_state`` is the one counted sync."""
        carry = train_step.export_resume_state()
        opt = train_step.optimizer
        live = _live_tensors(train_step)
        arrays = {k: self._host_copy(k, t) for k, t in live.items()}
        if any(t.is_cuda for t in live.values()):
            torch.cuda.current_stream().synchronize()
        for dev, gen in _random._GENERATORS.items():
            arrays[f"rng/device/{_dev_key(dev)}"] = gen.get_state()
        if len(carry):
            arrays["rng/dropout"] = torch.from_numpy(carry)
        sched = opt._learning_rate
        host = {"global_step": global_step,
                "cursor": dict(cursor or {}),
                "opt_step": int(opt._step_count),
                "lr_scheduler": (sched.state_dict()
                                 if hasattr(sched, "state_dict") else None),
                "scheduler": (scheduler.state_dict()
                              if scheduler is not None else None),
                "scaler": (train_step.scaler.state_dict()
                           if train_step.scaler is not None else None),
                "fused_steps": int(getattr(train_step, "fused_steps", 1)),
                "rng_devices": {_dev_key(d): str(d)
                                for d in _random._GENERATORS}}
        manifest = {"format": 1, "step": global_step, "host": host,
                    "mesh": None,
                    "arrays": {k: {"shape": list(v.shape),
                                   "dtype": _dckpt.dtype_name(v.dtype),
                                   "spec": None}
                               for k, v in arrays.items()}}
        return arrays, manifest

    def _write(self, arrays, manifest, step_no, ordinal):
        final = self._dir(step_no)
        tmp = os.path.join(self.root, f"{_TMP_PREFIX}step-{step_no:08d}")
        t0 = time.perf_counter()
        attempt = 0
        with _trace.span("resilience.save"):
            while True:
                try:
                    _fi.maybe_fault("ckpt_write", ordinal)
                    if os.path.isdir(tmp):
                        shutil.rmtree(tmp)
                    os.makedirs(tmp)
                    _dckpt.save_state_dict(arrays, tmp)
                    # a writer killed HERE (chunks on disk, no manifest, no
                    # rename) leaves only an ignored .tmp dir
                    _fi.maybe_fault("ckpt_crash", ordinal)
                    mtmp = os.path.join(tmp, _MANIFEST + ".tmp")
                    with open(mtmp, "w") as f:
                        json.dump(manifest, f)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(mtmp, os.path.join(tmp, _MANIFEST))
                    if os.path.isdir(final):
                        shutil.rmtree(final)
                    os.replace(tmp, final)  # the commit point
                    break
                except OSError as e:
                    attempt += 1
                    if attempt > self.retries:
                        _counters.inc("resilience.save_failures")
                        raise CheckpointWriteError(
                            f"checkpoint save at step {step_no} failed "
                            f"after {attempt} attempts: {e}") from e
                    _counters.inc("resilience.retries")
                    time.sleep(self.backoff_s * (2 ** (attempt - 1)))
        try:
            dfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dfd)  # persist the rename itself
            finally:
                os.close(dfd)
        except OSError:
            pass
        _counters.inc("resilience.saves")
        save_ms = int((time.perf_counter() - t0) * 1000)
        _metrics.observe("resilience.save_ms", save_ms, unit="ms",
                         sum_counter=True)
        _flight.record("ckpt.save", step=step_no, ms=save_ms)
        self._gc()

    def _gc(self):
        steps = self._committed()
        for step_no in steps[:-self.keep_last] if self.keep_last > 0 else []:
            shutil.rmtree(self._dir(step_no), ignore_errors=True)
            _counters.inc("resilience.gc_removed")
        # stale staging dirs of crashed writers (never the in-flight one:
        # _gc runs on the one writer, after its commit)
        for name in os.listdir(self.root):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def wait(self, suppress=False):
        """Join the in-flight async writer.  Re-raises its error unless
        ``suppress`` (a recovery path: the live state is still good)."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self._error = self._error, None
        if err is not None and not suppress:
            raise err

    # -- restore -------------------------------------------------------------
    def restore(self, train_step, *, scheduler=None):
        """Restore the newest loadable checkpoint into ``train_step``'s
        model, optimizer and scaler and the random generators, falling
        back to older checkpoints on corruption.  Returns ``{"step",
        "cursor", "path", ...}``, or None when there is no checkpoint."""
        self.wait(suppress=True)
        last_exc = None
        for step_no in reversed(self._committed()):
            path = self._dir(step_no)
            try:
                t0 = time.perf_counter()
                with _trace.span("resilience.restore"):
                    info = self._restore_from(path, train_step, scheduler)
                _counters.inc("resilience.restores")
                restore_ms = (time.perf_counter() - t0) * 1000
                _metrics.observe("resilience.restore_ms", restore_ms,
                                 unit="ms")
                _flight.record("ckpt.restore", step=info["step"],
                               ms=int(restore_ms))
                return info
            except (CheckpointCorrupt, ValueError, KeyError, OSError,
                    json.JSONDecodeError) as e:
                if not isinstance(e, CheckpointCorrupt):
                    # crc failures are counted by the reader
                    _counters.inc("resilience.corrupt_detected")
                last_exc = e
                continue
        if last_exc is not None:
            raise CheckpointCorrupt(
                f"no loadable checkpoint under {self.root}; newest failure: "
                f"{type(last_exc).__name__}: {last_exc}") from last_exc
        return None

    def _restore_from(self, path, train_step, scheduler):
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        host = manifest["host"]
        if manifest.get("mesh") is not None:
            raise NotImplementedError(
                f"checkpoint {path} was saved on the mesh "
                f"{manifest['mesh']}: restoring a sharded checkpoint is not "
                "ported yet: ROADMAP.md A7 (distributed)")
        train_step.invalidate()
        opt = train_step.optimizer
        live = model_state(train_step.model)
        targets = {}
        for key, spec in manifest["arrays"].items():
            shape = tuple(spec["shape"])
            if key.startswith("model/"):
                name = key[len("model/"):]
                if name not in live:
                    raise KeyError(f"checkpoint tensor {key!r} has no "
                                   "target in the live model")
                if tuple(live[name].shape) != shape:
                    raise CheckpointLayoutError(
                        f"checkpoint leaf {key!r} has shape {shape}, but "
                        f"the live model tensor is "
                        f"{tuple(live[name].shape)}: a different model; "
                        "refusing to restore")
                targets[key] = live[name]
            elif key.startswith(("opt/", "rng/device/", "rng/dropout")):
                targets[key] = torch.empty(
                    shape, dtype=_dckpt._TORCH_DTYPES[spec["dtype"]])
        _dckpt.load_state_dict(targets, path)  # checks each chunk's crc32
        # the optimizer's state dict, its positional "p<i>" keys turned
        # back into this process's parameter names
        names = opt._param_names

        def pname(tok):
            if not (tok[:1] == "p" and tok[1:].isdigit()
                    and int(tok[1:]) < len(names)):
                raise KeyError(f"checkpoint optimizer entry {tok!r} names "
                               "no parameter position of the optimizer")
            return names[int(tok[1:])]
        opt_sd = {"accumulators": {}, "master_weights": {},
                  "step": int(host.get("opt_step", 0)),
                  "LR_Scheduler": host.get("lr_scheduler") or {}}
        lrs = {}
        for key, t in targets.items():
            if key.startswith("opt/acc/"):
                _, _, acc, tok = key.split("/", 3)
                opt_sd["accumulators"].setdefault(acc, {})[pname(tok)] = t
            elif key.startswith("opt/master/"):
                opt_sd["master_weights"][pname(key.split("/", 2)[2])] = t
            elif key.startswith("opt/lr/"):
                lrs[int(key.split("/", 2)[2])] = t
        if lrs:
            opt_sd["lr"] = [lrs[i] for i in sorted(lrs)]
        # a full-state restore is authoritative: set_state_dict merges, so
        # accumulators and masters the checkpoint lacks (the step-0 save
        # restored onto an optimizer that has stepped) are dropped; the
        # first step makes them as a fresh optimizer would
        opt._accumulators.clear()
        opt._master_weights.clear()
        opt.set_state_dict(opt_sd)
        if train_step.scaler is not None and host.get("scaler"):
            train_step.scaler.load_state_dict(host["scaler"])
        if scheduler is not None and host.get("scheduler"):
            scheduler.set_state_dict(host["scheduler"])
        carry = targets.get("rng/dropout")
        train_step.restore_resume_state(
            None if carry is None else carry.numpy())
        devices = host.get("rng_devices") or {}
        for k, dev in devices.items():
            state = targets.get(f"rng/device/{k}")
            if state is not None and _device_present(dev):
                _random.default_generator(dev).set_state(state)
        return {"step": int(manifest["step"]),
                "cursor": dict(host.get("cursor") or {}),
                "path": path,
                "resharded": False,
                "saved_mesh": None}


def _device_present(dev):
    d = torch.device(dev)
    return d.type == "cpu" or (d.type == "cuda" and torch.cuda.is_available()
                               and (d.index or 0) < torch.cuda.device_count())
