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

**On a mesh** (a step built with ``mesh=``; every rank runs the same
calls).  The manifest records the mesh (its axes and degrees) and each
array's spec, and the shapes are the whole tensors'.  Each rank writes
the chunks of its shards (``jit.mesh.MeshPlan.shard``: the model's
tensor-parallel, expert and pipeline shards, the storage-sharded
optimizer state) into the step's staging directory, each box once;
the ranks agree that every one of them wrote, then rank 0 writes
``MANIFEST.json``, commits by the rename and alone collects old saves,
and the ranks agree once more, so a save has committed on every rank
when it returns.  A rank's own random streams (its device generators,
its dropout generator and its sequence chunks' generators) are saved
under keys that name it, ``rng/rank<r>/device/<device>`` and
``rng/rank<r>/stream/<name>``.  On restore rank 0 picks the step (the
newest committed, falling back past one any rank cannot load) and every
rank restores it.  A restore onto a mesh of other degrees than the
saved one (the JAX package's saves included) is a resharding: each
rank reads its boxes from whatever chunks cover them, it counts
``resilience.resharded_restores``, and the streams, which belong to the
saved layout, stay as they are (``streams_restored`` in the returned
info).  A leaf whose whole shape differs raises
:class:`CheckpointLayoutError`.  The ranks coordinate over a gloo group
of the checkpoint's own (``distributed.checkpoint.coord_group``), so an
async writer's barriers never meet the training collectives.

``rng/carry`` and ``rng/host`` are the JAX package's keys: a port save
writes them as the JAX keys of its dropout and CPU generators' seeds
(the JAX ``PRNGKey``'s words), so the JAX manager restores a port save
too, its random chains starting afresh from them; the port reads
neither.

Counters, histograms, flight records and spans under the JAX names:
``resilience.saves``, ``.retries``, ``.save_failures``, ``.gc_removed``,
``.restores``, ``.corrupt_detected``; histograms ``resilience.save_ms``
(the write) and ``resilience.restore_ms``, and the port's
``resilience.snapshot_ms`` (the host copies); flight ``ckpt.save`` and
``ckpt.restore``; spans ``resilience.snapshot``, ``resilience.save``,
``resilience.restore``.  ``last_save`` holds the last save's
``{"step", "bytes", "snapshot_ms", "write_ms"}`` (this rank's).
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
from ..distributed.checkpoint import LocalShard, ShardChunks
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
    (a leaf's whole shape differs: a different model, not another mesh).
    Not a reason to fall back to an older checkpoint: every save of the
    run would mismatch alike, so the manager raises at once."""


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


def _dev_of(key):
    """The device a ``_dev_key`` names ("cuda_0" -> "cuda:0")."""
    return re.sub(r"_(\d+)$", r":\1", key)


def _mesh_desc(mesh):
    """The mesh's axes and degrees as the manifest records them (the JAX
    ``_mesh_desc``), None without one."""
    if mesh is None:
        return None
    return {"axis_names": [str(a) for a in mesh.axis_names],
            "shape": [int(mesh.shape[a]) for a in mesh.axis_names]}


def _degrees(desc):
    """A recorded mesh's axes of degree above 1: two meshes lay tensors
    out alike when these are equal (axes of degree 1 split nothing)."""
    if not desc:
        return {}
    return {a: n for a, n in zip(desc["axis_names"], desc["shape"]) if n > 1}


def _spec_json(spec):
    """A partition spec as JSON (None, an axis name or a list of them per
    dimension), the JAX ``_spec_json``."""
    if spec is None:
        return None
    return [None if e is None else (e if isinstance(e, str) else list(e))
            for e in spec]


def _jax_key(seed):
    """The two uint32 words of the JAX ``PRNGKey(seed)``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _own(t):
    """``t`` as a whole tensor this rank writes itself (a rank's own
    stream: the coordinator-only rule for whole tensors would drop the
    other ranks')."""
    return ShardChunks(t.shape, t.dtype, [((0,) * t.dim(), tuple(t.shape),
                                           t)])


def _plan(train_step):
    return getattr(train_step, "_mesh", None)


def _live_tensors(train_step):
    """Every device tensor of a snapshot, by checkpoint key: a tensor, or
    on a mesh the :class:`LocalShard` of this rank's piece."""
    opt = train_step.optimizer
    plan = _plan(train_step)
    out = {f"model/{n}": (t if plan is None else plan.shard(t))
           for n, t in model_state(train_step.model).items()}
    params = {id(p): p for p in opt._parameter_list}
    pos = {id(p): f"p{i}" for i, p in enumerate(opt._parameter_list)}

    def state(pid, t):
        return t if plan is None else plan.state_shard(params[pid], t)
    for acc, store in opt._accumulators.items():
        for pid, t in store.items():
            out[f"opt/acc/{acc}/{pos[pid]}"] = state(pid, t)
    for pid, t in opt._master_weights.items():
        out[f"opt/master/{pos[pid]}"] = state(pid, t)
    for i, t in enumerate(opt._lr_tensors):
        out[f"opt/lr/{i}"] = t if plan is None else LocalShard(
            t, (), plan.mesh)
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
        self.last_save = None

    # -- the ranks -----------------------------------------------------------
    def _ranks(self):
        """``(rank, world, gloo group or None)``; every rank calls."""
        rank, world = _dckpt.rank_world()
        return rank, world, _dckpt.coord_group()

    def _join(self):
        """Wait for the writer thread, keeping its error for :meth:`wait`
        (its collectives and ours share the checkpoint's group)."""
        if self._thread is not None:
            self._thread.join()

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
        """Newest committed checkpoint's global step, or None (over
        several processes rank 0's view, which every rank calls for)."""
        rank, world, group = self._ranks()
        steps = self._committed()
        if group is None:
            return steps[-1] if steps else None
        self._join()
        last = _dckpt.broadcast_int(steps[-1] if steps else -1, group)
        return None if last < 0 else last

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
        snapshot_ms = (time.perf_counter() - t0) * 1000
        _metrics.observe("resilience.snapshot_ms", snapshot_ms, unit="ms")
        self.last_save = {"step": int(global_step), "bytes": sum(
            int(v.nbytes if isinstance(v, ShardChunks)
                else v.numel() * v.element_size())
            for v in arrays.values() if not isinstance(v, np.ndarray)),
            "snapshot_ms": snapshot_ms}
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
        """``(arrays, manifest)``: host tensors (a shard's as
        ``ShardChunks``) by key, and the manifest.
        ``export_resume_state`` is the one counted sync."""
        rank, world, group = self._ranks()
        streams = train_step.export_resume_state()
        opt = train_step.optimizer
        plan = _plan(train_step)
        live = _live_tensors(train_step)
        arrays, specs, cuda = {}, {}, False
        for k, x in live.items():
            if isinstance(x, LocalShard):
                cuda = cuda or x.tensor.is_cuda
                arrays[k] = ShardChunks.capture(
                    x, lambda i, v, k=k: self._host_copy(f"{k}##{i}", v))
                specs[k] = _spec_json(x.spec)
            else:
                cuda = cuda or x.is_cuda
                arrays[k] = self._host_copy(k, x)
        if cuda:
            torch.cuda.current_stream().synchronize()
        for dev, gen in _random._GENERATORS.items():
            arrays[f"rng/rank{rank}/device/{_dev_key(dev)}"] = _own(
                gen.get_state())
        for name, state in streams.items():
            arrays[f"rng/rank{rank}/stream/{name}"] = _own(
                torch.from_numpy(state))
        gen = getattr(train_step.model, "dropout_generator", None)
        arrays["rng/carry"] = _jax_key(0 if gen is None
                                       else gen.initial_seed())
        arrays["rng/host"] = _jax_key(
            _random.default_generator("cpu").initial_seed())
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
                "world_size": world}
        table = {k: {"shape": list(v.shape),
                     "dtype": (v.dtype if isinstance(v, ShardChunks)
                               else str(v.dtype) if isinstance(v, np.ndarray)
                               else _dckpt.dtype_name(v.dtype)),
                     "spec": specs.get(k)}
                 for k, v in arrays.items()}
        if group is not None:
            # the manifest lists every rank's arrays (each rank's streams)
            tables = [None] * world
            torch.distributed.all_gather_object(tables, table, group=group)
            table = {k: v for t in tables for k, v in t.items()}
        manifest = {"format": 1, "step": global_step, "host": host,
                    "mesh": _mesh_desc(None if plan is None else plan.mesh),
                    "arrays": table}
        return arrays, manifest

    def _write(self, arrays, manifest, step_no, ordinal):
        rank, _, group = self._ranks()
        final = self._dir(step_no)
        tmp = os.path.join(self.root, f"{_TMP_PREFIX}step-{step_no:08d}")
        t0 = time.perf_counter()
        attempt = 0
        with _trace.span("resilience.save"):
            while True:
                # every rank takes each decision together: a rank's
                # failure makes every rank retry (or give up)
                err = None
                try:
                    _fi.maybe_fault("ckpt_write", ordinal)
                    if rank == 0:
                        if os.path.isdir(tmp):
                            shutil.rmtree(tmp)
                        os.makedirs(tmp)
                except OSError as e:
                    err = e
                if _dckpt.agree(err is None, group):
                    try:
                        _dckpt.save_state_dict(arrays, tmp)
                        # a writer killed HERE (chunks on disk, no
                        # manifest, no rename) leaves an ignored .tmp dir
                        _fi.maybe_fault("ckpt_crash", ordinal)
                        if rank == 0:
                            mtmp = os.path.join(tmp, _MANIFEST + ".tmp")
                            with open(mtmp, "w") as f:
                                json.dump(manifest, f)
                                f.flush()
                                os.fsync(f.fileno())
                            os.replace(mtmp, os.path.join(tmp, _MANIFEST))
                            if os.path.isdir(final):
                                shutil.rmtree(final)
                            os.replace(tmp, final)  # the commit point
                    except OSError as e:
                        err = e
                    if _dckpt.agree(err is None, group):
                        break
                attempt += 1
                err = err or OSError("another rank's checkpoint write "
                                     "failed")
                if attempt > self.retries:
                    _counters.inc("resilience.save_failures")
                    raise CheckpointWriteError(
                        f"checkpoint save at step {step_no} failed "
                        f"after {attempt} attempts: {err}") from err
                _counters.inc("resilience.retries")
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
        if rank == 0:
            try:
                dfd = os.open(self.root, os.O_RDONLY)
                try:
                    os.fsync(dfd)  # persist the rename itself
                finally:
                    os.close(dfd)
            except OSError:
                pass
        _counters.inc("resilience.saves")
        write_ms = (time.perf_counter() - t0) * 1000
        save_ms = int(write_ms)
        _metrics.observe("resilience.save_ms", save_ms, unit="ms",
                         sum_counter=True)
        _flight.record("ckpt.save", step=step_no, ms=save_ms)
        if self.last_save is not None and self.last_save["step"] == step_no:
            self.last_save["write_ms"] = write_ms
        if rank == 0:
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
        back to older checkpoints on corruption (over several processes:
        rank 0's choice, past any step a rank cannot load).  Returns
        ``{"step", "cursor", "path", "resharded", "saved_mesh",
        "streams_restored", "ms"}``, or None when there is no
        checkpoint."""
        self.wait(suppress=True)
        rank, world, group = self._ranks()
        steps = self._committed()
        if group is not None:
            box = [steps]
            torch.distributed.broadcast_object_list(
                box, src=torch.distributed.get_global_rank(group, 0),
                group=group)
            steps = box[0]
        last_exc = None
        for step_no in reversed(steps):
            path = self._dir(step_no)
            t0 = time.perf_counter()
            err = None
            try:
                with _trace.span("resilience.restore"):
                    info = self._restore_from(path, train_step, scheduler)
            except (CheckpointCorrupt, ValueError, KeyError, OSError,
                    json.JSONDecodeError) as e:
                if not isinstance(e, CheckpointCorrupt):
                    # crc failures are counted by the reader
                    _counters.inc("resilience.corrupt_detected")
                err = e
            if _dckpt.agree(err is None, group):
                _counters.inc("resilience.restores")
                if info["resharded"]:
                    _counters.inc("resilience.resharded_restores")
                restore_ms = (time.perf_counter() - t0) * 1000
                _metrics.observe("resilience.restore_ms", restore_ms,
                                 unit="ms")
                _flight.record("ckpt.restore", step=info["step"],
                               ms=int(restore_ms))
                info["ms"] = restore_ms
                return info
            last_exc = err or CheckpointCorrupt(
                f"another rank could not load {path}")
        if last_exc is not None:
            raise CheckpointCorrupt(
                f"no loadable checkpoint under {self.root}; newest failure: "
                f"{type(last_exc).__name__}: {last_exc}") from last_exc
        return None

    def _restore_from(self, path, train_step, scheduler):
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        host = manifest["host"]
        rank, _, _ = self._ranks()
        plan = _plan(train_step)
        saved_mesh = manifest.get("mesh")
        live_mesh = _mesh_desc(None if plan is None else plan.mesh)
        # another layout of the same tensors: each rank reads its boxes
        # from the chunks that cover them; the random streams belong to
        # the saved layout and stay as they are
        resharded = _degrees(saved_mesh) != _degrees(live_mesh)
        mine = f"rng/rank{rank}/"
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
                t = live[name]
                tgt = LocalShard(t) if plan is None else plan.shard(t)
                if tgt.shape != shape:
                    raise CheckpointLayoutError(
                        f"checkpoint leaf {key!r} has shape {shape} (saved "
                        f"on mesh {saved_mesh}, spec {spec.get('spec')}), "
                        f"but the live model tensor is {tgt.shape} on mesh "
                        f"{live_mesh}: a different model, not a "
                        "resharding; refusing to restore")
                targets[key] = tgt
            elif key.startswith("opt/"):
                targets[key] = self._opt_target(key, shape, spec["dtype"],
                                                opt, plan)
            elif key.startswith(mine) and not resharded:
                targets[key] = torch.empty(
                    shape, dtype=_dckpt._TORCH_DTYPES[spec["dtype"]])
        _dckpt.load_state_dict(targets, path)  # checks each chunk's crc32

        def local(key):
            t = targets[key]
            return t.tensor if isinstance(t, LocalShard) else t
        opt_sd = {"accumulators": {}, "master_weights": {},
                  "step": int(host.get("opt_step", 0)),
                  "LR_Scheduler": host.get("lr_scheduler") or {}}
        lrs = {}
        for key in targets:
            if key.startswith("opt/acc/"):
                _, _, acc, tok = key.split("/", 3)
                opt_sd["accumulators"].setdefault(acc, {})[
                    opt._param_names[_position(tok, opt)]] = local(key)
            elif key.startswith("opt/master/"):
                opt_sd["master_weights"][opt._param_names[_position(
                    key.split("/", 2)[2], opt)]] = local(key)
            elif key.startswith("opt/lr/"):
                lrs[int(key.split("/", 2)[2])] = local(key)
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
        streams = {k[len(mine + "stream/"):]: targets[k].numpy()
                   for k in targets if k.startswith(mine + "stream/")}
        train_step.restore_resume_state(streams)
        devices = [k for k in targets if k.startswith(mine + "device/")]
        for k in devices:
            dev = _dev_of(k[len(mine + "device/"):])
            if _device_present(dev):
                _random.default_generator(dev).set_state(targets[k])
        return {"step": int(manifest["step"]),
                "cursor": dict(host.get("cursor") or {}),
                "path": path,
                "resharded": bool(resharded),
                "saved_mesh": saved_mesh,
                "streams_restored": bool(streams or devices)}

    @staticmethod
    def _opt_target(key, shape, dtype, opt, plan):
        """The tensor an optimizer entry loads into: without a mesh the
        whole tensor; on one a tensor of the parameter's update layout
        (its slice where its state is sharded) when the entry has the
        parameter's whole shape, else whole (Adam's beta powers)."""
        dt = _dckpt._TORCH_DTYPES[dtype]
        parts = key.split("/")
        if plan is None or parts[1] == "lr":
            return torch.empty(shape, dtype=dt)
        p = opt._parameter_list[_position(parts[-1], opt)]
        if plan.shard(p).shape != shape:
            return torch.empty(shape, dtype=dt)
        return plan.state_shard(p, torch.empty(
            opt._view(p).shape, dtype=dt, device=p.device))


def _position(tok, opt):
    """The parameter position a checkpoint's ``p<i>`` names."""
    if not (tok[:1] == "p" and tok[1:].isdigit()
            and int(tok[1:]) < len(opt._parameter_list)):
        raise KeyError(f"checkpoint optimizer entry {tok!r} names no "
                       "parameter position of the optimizer")
    return int(tok[1:])


def _device_present(dev):
    d = torch.device(dev)
    return d.type == "cpu" or (d.type == "cuda" and torch.cuda.is_available()
                               and (d.index or 0) < torch.cuda.device_count())
