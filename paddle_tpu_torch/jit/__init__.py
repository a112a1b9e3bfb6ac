"""The training step (port of ``paddle_tpu/jit/__init__.py``'s
``CompiledTrainStep``).

JAX compiles forward, backward and the optimizer update into one XLA
program with the state donated through it.  Here a step is that
program's body (:meth:`CompiledTrainStep._body`) run as it is:
``loss_fn(model, *args)``, the backward (scaled and unscaled under a
GradScaler), the optional nan/inf checks and metric scalars, the
optimizer update and ``clear_grad``.  Parameters, fp32 masters,
accumulators, the lr tensors and the GradScaler state stay on the device
and are updated in place, so there is no state to carry and no host
sync inside a step: the loss comes back as a device tensor.  ``model``
is a ``torch.nn.Module`` (the port's GPT) or a paddle-style ``nn.Layer``
(whose torch parameters the step reads); ``loss_fn`` may return a
paddle-style ``Tensor``.

``fused_steps=K`` (default ``FLAGS_fused_steps``) takes windows of K
batches stacked on a leading axis (an ``io.Window``, or raw stacked
tensors whose leading axis gives the window length), the port's form of
the JAX ``lax.scan`` window:

* a window call returns the K-vector of losses; ``jit.steps`` and the
  optimizer's step count advance by K, ``jit.host.dispatches`` by 1;
* the learning rates of the window's steps come from the scheduler's
  ``peek(K)`` without stepping it (the caller steps it K times after);
* the first window of a step object (the priming window: it makes the
  optimizer state) and partial tail windows run as single steps
  (``jit.fused_fallback_steps``);
* on CUDA a steady window is one replay of a CUDA graph that holds the
  window's K step bodies, captured at the first steady window on a side
  stream (the priming steps run on that stream too, as its warm-up).
  The batch goes through static input buffers; the lr vector through a
  device buffer each body reads its entry of; dropout masks come from
  the model's CUDA generator, registered with the graph, so each replay
  draws fresh ones.  A capture that fails raises: nothing falls back to
  running eagerly.  The kernel launch counters (``kernels.launch_counted``)
  and the counters the bodies tick are what one capture recorded, added
  on each replay;
* on the CPU a steady window runs its K bodies one after another, with
  the same results and counters.

K fused steps give the same trajectory as K single steps, bit for bit.

``scaler=`` (an enabled ``amp.GradScaler``): the backward runs on the
scaled loss; the scaler unscales the gradients in fp32 and zeroes them
on overflow, the lr tensors are set to 0 and every tensor the update
writes keeps its old value (the JAX ``_scaled_backward`` and
``_skip_select``); the scaler updates its scale and counts on the
device.

``FLAGS_check_nan_inf``: the loss, every gradient and every updated
parameter are checked on the device; after the call (once after a
window) the bits are read back and a ``FloatingPointError`` names the
first bad step (its index inside a fused window) and what was not
finite.  A step whose overflow the scaler handled is not an error.

``metrics=True`` (or a ``profiler.MetricsLogger``): per step the loss,
the gradients' global norm (after unscaling, before clipping; its
per-gradient sums of squares are the ones the clip reads), lr,
scale, skip, step time, tokens/s and MFU (against ``FLAGS_peak_tflops``).
The device scalars wait on the device until :meth:`metrics_flush` or
:meth:`sync` reads them back in one transfer.

Checkpoints (``resilience.CheckpointManager``): :meth:`sync` is the
boundary a save reads the state at (one ``jit.syncs`` after any
dispatch); :meth:`export_resume_state` syncs once and returns this
rank's dropout streams (the port's form of the JAX in-graph RNG carry):
the model's dropout generator and, under a sequence split, the
generators its chunks draw from; :meth:`restore_resume_state` drops the
captured graphs, since a restore replaces tensors they write
(accumulators the checkpoint lacks are dropped), so the next window
primes and captures afresh (``jit.captures`` counts captures), and
installs those streams.

``mesh=`` (``distributed.build_mesh``), ``shard_rules=``,
``batch_axes=``: the mesh step of ``jit/mesh.py`` — each rank takes its
rows of the batch (with ``sep > 1`` also its chunk of every sequence,
and the forward runs under ``distributed.env.sequence_split_over``), the
gradients and the loss are averaged over the data axes and ``sep``,
parameters the model holds whole may keep their optimizer state
sharded (reduce-scattered gradients, all-gathered parameters), and the
collectives run inside the step body, so a fused window's CUDA graph
captures them (NCCL; gloo's cannot be captured: a window on CUDA over
gloo raises, use ``fused_steps=1`` there).  A mesh of one rank gives
the meshless step's bits.

Counters, under the JAX names: ``jit.steps``, ``jit.host.dispatches``,
``jit.fused_windows``, ``jit.fused_fallback_steps``, ``jit.syncs``,
``jit.nan_inf_checks``/``.nan_inf_hits``, ``optimizer.steps``, and the
gauges ``train.steps_accum``, ``train.loss_mean``,
``train.grad_norm_mean`` and ``train.skip_steps``; the port's own
``jit.captures``.  Batch arguments may be ``Tensor``s (the prefetchers'
leaves): the step takes their torch tensors.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import flags
from ..core.state import STATE
from ..core.tensor import unwrap
from ..distributed.elastic import heartbeat
from ..distributed.env import rows_split_over, sequence_split_over
from ..io import Window
from ..kernels import count_launch, launch_counted
from ..nn.clip import sum_sq
from ..profiler import counters
from ..profiler.metrics import MetricsLogger
from .mesh import MeshPlan

def _params(model):
    """The model's torch parameters (a paddle-style ``Layer``'s own
    ``parameters()`` gives its wrappers)."""
    return torch.nn.Module.parameters(model)


def _window_len(args):
    for a in args:
        if isinstance(a, torch.Tensor) and a.dim() >= 1:
            return int(a.shape[0])
    raise ValueError("cannot infer the window length: no tensor with a "
                     "leading axis in the window args (stack batches or "
                     "pass an io.Window)")


def _slice(args, i):
    return tuple(a[i] if isinstance(a, torch.Tensor) and a.dim() >= 1
                 else a for a in args)


def _infer_tokens(args, stacked):
    """Tokens a step from the batch shape: B*S of the first >= 2-d
    tensor (ids [B, S]), else its leading size; a window's leading axis
    is skipped."""
    skip = 1 if stacked else 0
    for a in args:
        if not isinstance(a, torch.Tensor) or a.dim() <= skip:
            continue
        dims = a.shape[skip:]
        return int(dims[0]) * int(dims[1]) if len(dims) >= 2 else int(dims[0])
    return None


class _Captured:
    """One captured window: the graph, its static buffers and outputs,
    and what one replay adds to the counters."""

    def __init__(self, graph, args, lrs, out, names, launches, ticks):
        self.graph, self.args, self.lrs = graph, args, lrs
        self.out, self.names = out, names
        self.launches, self.ticks = launches, ticks


class CompiledTrainStep:
    def __init__(self, model, loss_fn, optimizer, scaler=None, donate=True,
                 fused_steps=None, mesh=None, shard_rules=None,
                 batch_axes=None, metrics=None):
        if mesh is None and (shard_rules is not None
                             or batch_axes is not None):
            raise ValueError("shard_rules= and batch_axes= need mesh=")
        if fused_steps is None:
            fused_steps = int(flags.flag("FLAGS_fused_steps"))
        if int(fused_steps) < 1:
            raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.scaler = (scaler if scaler is not None and scaler.is_enable()
                       else None)
        self.fused_steps = int(fused_steps)
        self.metrics = MetricsLogger() if metrics is True else (
            metrics or None)
        self._primed = False      # a step body has run (state exists)
        self._dirty = False       # dispatched since the last sync
        self._stream = None       # the side stream of CUDA windows
        self._graphs = {}
        self._pending = []
        self._totals = dict.fromkeys(("steps", "loss", "grad_norm", "skip"),
                                     0.0)
        self._last_dispatch_t = None
        self._tokens_per_step = None
        self._n_params = None
        self._mesh = (None if mesh is None else MeshPlan(
            mesh, model, optimizer, shard_rules, batch_axes))

    # -- the step body -----------------------------------------------------
    def _body(self, args, check, mon):
        """One training step on the device with the lr tensors as they
        are.  Returns ``(loss, check names, check bits, metric row,
        overflow flag)``; nothing is read back."""
        model, opt, scaler = self.model, self.optimizer, self.scaler
        # the body takes the dense path where eager code makes SelectedRows
        # (a CUDA graph records shapes; JAX traces the same way)
        STATE.tracing_depth += 1
        mesh = self._mesh
        try:
            with torch.enable_grad(), contextlib.ExitStack() as split:
                if mesh is not None:
                    # the rows and the sequence chunk this rank holds
                    split.enter_context(rows_split_over(mesh.row_axes))
                    split.enter_context(sequence_split_over(mesh.seq_axis,
                                                            mesh.mesh))
                loss = self._loss_and_grads(args)
        finally:
            STATE.tracing_depth -= 1
        if mesh is not None:
            mesh.fill_grads()
        named = [(n, p) for n, p in torch.nn.Module.named_parameters(model)
                 if p.grad is not None]
        # the gradients the update reads: the parameters' own, or on a
        # mesh their data-axes means (a storage slice where sharded)
        grads = {id(p): p.grad for _, p in named}
        if mesh is not None:
            loss = mesh.mean_loss(loss)
            grads = mesh.sync_grads()
        found = None
        if scaler is not None:
            found = scaler._unscale(_params(model), list(grads.values()))
            if mesh is not None:
                found = mesh.found_inf(found)
            opt._zero_lr_where(found)
        names, bits = [], []
        if check:
            names = ["loss"] + ["grad:" + n for n, _ in named]
            bits = [torch.isfinite(loss.float()).all()] + [
                torch.isfinite(grads[id(p)].float()).all() for _, p in named]
        row = sq = None
        if mon or (mesh is not None and opt._grad_clip is not None):
            # one pass over the gradients, shared with the clip (on a
            # mesh: summed over the ranks that hold pieces of one)
            sq = ({id(p): sum_sq(p.grad) for _, p in named} if mesh is None
                  else mesh.sum_squares(grads))
        if mon:
            row = [torch.sqrt(sum(sq.values()))]
        opt._apply(found, sq)
        if mesh is not None:
            mesh.gather_params()
        opt.clear_grad()
        if scaler is not None:
            scaler._update(found)
        if check:
            names += ["param:" + n for n, _ in named]
            bits += [torch.isfinite(p.float()).all() for _, p in named]
        if mon:
            if scaler is not None:
                row += [found.float(), scaler._state["scale"].clone()]
            else:
                row += [torch.zeros_like(row[0]), torch.ones_like(row[0])]
            row = torch.stack(row)
        bits = torch.stack(bits) if check else None
        return loss.detach(), names, bits, row, found

    def _loss_and_grads(self, args):
        """The step's loss on ``args``, its gradients left in the
        parameters' ``.grad`` (scaled under a GradScaler)."""
        loss = unwrap(self.loss_fn(self.model, *args))
        (loss if self.scaler is None else self.scaler.scale(loss)).backward()
        return loss

    # -- dispatch ----------------------------------------------------------
    def __call__(self, *args):
        self._dirty = True
        # the elastic agent's watchdog: one beat a call, a single step or
        # a window (a no-op outside an elastic run)
        heartbeat()
        rows = (self._mesh.rows if self._mesh is not None
                else lambda a, stacked: a)
        if len(args) == 1 and isinstance(args[0], Window):
            return self._call_window(rows(tuple(map(unwrap, args[0])), True),
                                     args[0].k)
        args = tuple(map(unwrap, args))
        if self.fused_steps > 1:
            return self._call_window(rows(args, True), None)
        return self._dispatch_single(rows(args, False),
                                     self.optimizer.get_lr())

    def _device(self):
        return next(_params(self.model)).device

    @contextlib.contextmanager
    def _on_stream(self):
        """Windows on CUDA run every body on one side stream: the
        capture's, so the priming steps are its warm-up."""
        dev = self._device()
        if dev.type != "cuda" or self.fused_steps == 1:
            yield
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)

    def _dispatch_single(self, args, lr_val):
        counters.inc("jit.steps")
        counters.inc("jit.host.dispatches")
        check = bool(flags.flag("FLAGS_check_nan_inf"))
        mon = self.metrics is not None
        with self._on_stream():
            self.optimizer._fill_lr(lr_val)
            loss, names, bits, row, found = self._body(args, check, mon)
        self._primed = True
        if mon:
            self._note(loss[None], row[None], (lr_val,), 1, args, False)
        if check:
            self._raise_if_nonfinite(
                names, bits[None], None if found is None else found[None], 1)
        return loss

    def _call_window(self, args, k=None):
        if k is None:
            k = _window_len(args)
        k = int(k)
        if k < 1:
            raise ValueError(f"empty dispatch window (k={k})")
        lrs = self.optimizer._peek_lrs(k)
        if k == self.fused_steps and k > 1 and self._primed:
            return self._dispatch_window(args, lrs, k)
        counters.inc("jit.fused_fallback_steps", k)
        return torch.stack([self._dispatch_single(_slice(args, i), lrs[i])
                            for i in range(k)])

    def _dispatch_window(self, args, lrs, k):
        counters.inc("jit.steps", k)
        counters.inc("jit.fused_windows")
        counters.inc("jit.host.dispatches")
        check = bool(flags.flag("FLAGS_check_nan_inf"))
        mon = self.metrics is not None
        if self._device().type == "cuda":
            losses, names, bits, rows, found = self._replay(
                args, lrs, k, check, mon)
        else:
            outs = []
            for i in range(k):
                self.optimizer._fill_lr(lrs[i])
                outs.append(self._body(_slice(args, i), check, mon))
            losses, names, bits, rows, found = self._stack(outs)
        if mon:
            self._note(losses, rows, tuple(lrs), k, args, True)
        if check:
            self._raise_if_nonfinite(names, bits, found, k)
        return losses

    @staticmethod
    def _stack(outs):
        loss, names, bits, row, found = zip(*outs)

        def stack(ts):
            return None if ts[0] is None else torch.stack(ts)

        return stack(loss), names[0], stack(bits), stack(row), stack(found)

    # -- CUDA graphs -------------------------------------------------------
    def _replay(self, args, lrs, k, check, mon):
        key = (check, mon, k, tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
            for a in args))
        cap = self._graphs.get(key)
        with self._on_stream():
            if cap is None:
                cap = self._graphs[key] = self._capture(args, k, check, mon)
            for dst, src in zip(cap.args, args):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src, non_blocking=True)
            cap.lrs.copy_(torch.tensor(lrs, dtype=torch.float32)
                          .pin_memory(), non_blocking=True)
            cap.graph.replay()
            out = tuple(None if t is None else t.clone() for t in cap.out)
        self.optimizer._step_count += k
        for fn, n in cap.launches.items():
            count_launch(fn, n)
        for name, n in cap.ticks.items():
            counters.inc(name, n)
        losses, bits, rows, found = out
        return losses, cap.names, bits, rows, found

    def _capture(self, args, k, check, mon):
        """Capture the window's K step bodies into one CUDA graph (on the
        current stream: the side stream).  Nothing runs: the capture
        records.  What the bodies counted is taken back and kept as the
        increments of one replay."""
        opt = self.optimizer
        dev = self._device()
        if self._mesh is not None and dist.get_backend() == "gloo":
            raise RuntimeError(
                "CompiledTrainStep(fused_steps>1) on CUDA over a gloo group: "
                "a CUDA graph cannot capture gloo's collectives (the "
                "gradient all-reduces, and with sep > 1 the ring's K/V "
                "shifts inside every step); use fused_steps=1 over gloo, "
                "or NCCL, whose collectives the window captures")
        static = tuple(a.to(dev, copy=True) if isinstance(a, torch.Tensor)
                       else a for a in args)
        lrs = torch.zeros(k, dtype=torch.float32, device=dev)
        graph = torch.cuda.CUDAGraph()
        # the dropout generators, a sequence chunk's too (the primed
        # steps made it)
        chunk_gens = getattr(self.model, "chunk_generators", None) or {}
        for gen in (getattr(self.model, "dropout_generator", None),
                    *chunk_gens.values()):
            if gen is not None and gen.device.type == "cuda":
                graph.register_generator_state(gen)
        kernels = launch_counted()
        launches0 = {fn: fn.launches for fn in kernels}
        ticks0 = counters.snapshot()
        step0 = opt._step_count
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                outs = []
                for i in range(k):
                    opt._load_lr(lrs[i])
                    outs.append(self._body(_slice(static, i), check, mon))
                losses, names, bits, rows, found = self._stack(outs)
        finally:
            opt._step_count = step0
            launches = {fn: fn.launches - launches0[fn] for fn in kernels}
            for fn in kernels:
                fn.launches = launches0[fn]
            ticks = counters.delta(ticks0)
            for name, n in ticks.items():
                counters.inc(name, -n)
        counters.inc("jit.captures")
        return _Captured(graph, static, lrs, (losses, bits, rows, found),
                         names, {f: n for f, n in launches.items() if n},
                         ticks)

    # -- metrics and checks ------------------------------------------------
    def _note(self, losses, rows, lrs, k, args, stacked):
        """Queue one dispatch's device scalars (not read here) with its
        host context."""
        if self._tokens_per_step is None:
            self._tokens_per_step = _infer_tokens(args, stacked)
        now = time.perf_counter()
        dt = (now - self._last_dispatch_t
              if self._last_dispatch_t is not None else None)
        self._last_dispatch_t = now
        self._pending.append({
            "gstep0": self.optimizer._step_count - k + 1, "k": k,
            "values": torch.cat([losses.float()[:, None], rows.float()], 1),
            "lrs": lrs, "dt": dt})
        if len(self._pending) >= 512:   # a loop that never syncs
            self.metrics_flush()

    def metrics_flush(self):
        """Read the pending per-step scalars back in one transfer and log
        them; set the ``train.*`` gauges."""
        if self.metrics is None or not self._pending:
            return
        pending, self._pending = self._pending, []
        values = torch.cat([r["values"] for r in pending]).cpu().tolist()
        peak = float(flags.flag("FLAGS_peak_tflops") or 0.0)
        if self._n_params is None:
            self._n_params = sum(p.numel() for p in _params(self.model))
        tokens = self._tokens_per_step
        t = self._totals
        row = 0
        for rec in pending:
            k = rec["k"]
            step_time = rec["dt"] / k if rec["dt"] is not None else None
            tok_s = (tokens / step_time
                     if tokens and step_time and step_time > 0 else None)
            mfu = (6.0 * self._n_params * tok_s / (peak * 1e12)
                   if tok_s and peak > 0 else None)
            for i in range(k):
                loss, gnorm, skip, scale = values[row]
                row += 1
                self.metrics.log(step=rec["gstep0"] + i, loss=loss,
                                 grad_norm=gnorm, lr=rec["lrs"][i],
                                 scaler_scale=scale, scaler_skip=skip,
                                 step_time_s=step_time, tok_s=tok_s,
                                 mfu=mfu)
                t["steps"] += 1
                t["loss"] += loss
                t["grad_norm"] += gnorm
                t["skip"] += skip
        counters.set_gauge("train.steps_accum", t["steps"])
        counters.set_gauge("train.loss_mean", t["loss"] / t["steps"])
        counters.set_gauge("train.grad_norm_mean", t["grad_norm"] / t["steps"])
        counters.set_gauge("train.skip_steps", t["skip"])

    def sync(self):
        """A sync boundary: the model and optimizer are always current
        (updated in place, and the caller's stream is ordered after the
        windows' side stream), so this harvests the pending metrics and,
        after any dispatch since the last sync, counts one
        ``jit.syncs``."""
        self.metrics_flush()
        if self._dirty:
            counters.inc("jit.syncs")
            self._dirty = False

    def _drop_graphs(self):
        """Forget the captured windows; the next window primes (single
        steps) and captures again."""
        if self._graphs:
            self._stream.synchronize()  # no replay still reads their pool
        self._graphs = {}
        self._primed = False

    def invalidate(self):
        """Sync, then drop the captured graphs (JAX: drop the device
        state); the next window primes and captures again.  Use after
        replacing tensors the optimizer holds."""
        self.sync()
        self._drop_graphs()

    def export_resume_state(self):
        """Checkpoint hook: one counted :meth:`sync`, then this rank's
        dropout streams as ``{name: uint8 array}`` (the JAX in-graph RNG
        carry's counterpart): ``"dropout"``, the model's dropout
        generator, and ``"chunk:<device>:<seed>:<index>"`` for each
        generator a sequence chunk draws from
        (``GPTForCausalLM.chunk_generators``); empty when the model has
        none."""
        self.sync()
        out = {}
        gen = getattr(self.model, "dropout_generator", None)
        if gen is not None:
            out["dropout"] = gen.get_state().numpy().copy()
        for (dev, seed, index), g in (getattr(
                self.model, "chunk_generators", None) or {}).items():
            out[f"chunk:{dev}:{seed}:{index}"] = g.get_state().numpy().copy()
        return out

    def restore_resume_state(self, streams=None):
        """After a restore: drop the captured graphs (the restore replaced
        tensors they write), install the saved dropout streams
        (:meth:`export_resume_state`'s dict; a chunk's generator is made
        if the model has not made it yet) and start the metric
        accumulators afresh."""
        self._drop_graphs()
        for name, state in (streams or {}).items():
            state = torch.from_numpy(np.asarray(state, np.uint8))
            if name == "dropout":
                gen = getattr(self.model, "dropout_generator", None)
            else:
                dev, seed, index = name[len("chunk:"):].rsplit(":", 2)
                chunks = self.model.chunk_generators
                key = (dev, int(seed), int(index))
                gen = chunks.get(key)
                if gen is None:
                    gen = chunks[key] = torch.Generator(device=dev)
            if gen is not None:
                gen.set_state(state)
        self._pending = []
        self._totals = dict.fromkeys(self._totals, 0.0)
        self._last_dispatch_t = None
        self._dirty = False

    def _raise_if_nonfinite(self, names, bits, found, window):
        """Read the finite-ness bits back (a host sync: a debug mode) and
        raise naming the first bad step of the dispatch."""
        counters.inc("jit.nan_inf_checks")
        bits = bits.cpu().tolist()
        found = found.cpu().tolist() if found is not None else None
        bad_by_step = {}
        for i, step_bits in enumerate(bits):
            if found is not None and found[i]:
                continue   # an overflow the scaler skipped: not a defect
            bad = sorted(n for n, ok in zip(names, step_bits) if not ok)
            if bad:
                bad_by_step[i] = bad
        if not bad_by_step:
            return
        counters.inc("jit.nan_inf_hits")
        i = min(bad_by_step)
        bad = bad_by_step[i]
        shown = ", ".join(bad[:8]) + (f" (+{len(bad) - 8} more)"
                                      if len(bad) > 8 else "")
        gstep = self.optimizer._step_count - window + i + 1
        where = (f"train step {gstep} (step {i} of a {window}-step fused "
                 f"window)" if window > 1 else f"train step {gstep}")
        raise FloatingPointError(
            f"FLAGS_check_nan_inf: non-finite values at {where}: {shown}")


__all__ = ["CompiledTrainStep"]
