"""Pipeline parallelism over the ``pp`` mesh axis (port of
``paddle_tpu/distributed/pipeline.py``).

The JAX package runs a schedule as one compiled ``lax.scan`` whose carry
rotates between the stages by ``lax.ppermute`` over ``pp``; its backward
is the transpose of the scan (GPipe, interleaved) or a second half of
the same scan (1F1B, zero-bubble).  The port drives the same schedules
from the host, tick by tick, with the same tick arithmetic (upstream
Paddle's ``PipelineParallel.forward_backward_pipeline`` is host-driven
too): one process a rank, each holding the rows of its own stages.
Stage-to-stage traffic is ``communication._shift`` over ``pp`` (one
``all_to_all_single``, which gloo takes on CUDA tensors): activations go
to member + 1, gradients to member - 1, each shift ticking
``dist.collective_launches`` and ``dist.pp_shifts``.  **Every rank calls
every shift on every tick**, whether or not its stage is active, as the
JAX ppermutes sit outside its conds: a rank that skipped one would leave
its neighbour waiting.  A bubble tick skips the stage body and sends
zeros.

* :func:`pipeline_apply`: GPipe and the interleaved (circular virtual)
  pipeline, a forward through the stages whose backward runs the reverse
  schedule.  The output and the aux come back replicated over ``pp``.
* :func:`pipeline_value_and_grad`: 1F1B and zero-bubble, with the loss
  inside the last stage, so microbatch m's backward starts before m +
  1's forward ends.

Each active stage step keeps its body's autograd graph until its
backward (the JAX package keeps the stage input and recomputes; the
values are the same); :func:`pipeline_apply`'s ``remat=True`` keeps the
input alone and reruns the body in the backward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..profiler import counters
from .communication import _shift
from .env import get_mesh
from .sharding_utils import P


def stack_spec(spec):
    """Spec of a ``[num_stages, ...]`` stacked parameter: dim 0 on
    ``pp``."""
    return P("pp", *spec)


def num_stages(mesh=None):
    mesh = mesh or get_mesh()
    return mesh.shape["pp"] if mesh is not None else 1


def _shift_pp(x, mesh, step):
    return _shift(x, "pp", mesh, step, counter="dist.pp_shifts")


def _sum_pp(t, mesh):
    """``t`` summed over ``pp`` in place (every member calls)."""
    counters.inc("dist.collective_launches")
    dist.all_reduce(t, group=mesh.group("pp"))
    return t


# ---------------------------------------------------------------------------
# GPipe and the interleaved pipeline
# ---------------------------------------------------------------------------

def pipeline_apply(stage_fn, stage_params, x, num_microbatches, mesh=None,
                   remat=True, schedule="gpipe", num_chunks=1,
                   with_aux=False):
    """Run ``stage_fn(params, h) -> h`` as a pipeline over ``pp``.

    ``stage_params``: ``{name: tensor}``, each stacked on a leading axis
    over the stages this rank runs, in the order it runs them: at ``pp
    == 1`` every stage (they run in sequence); otherwise one (GPipe) or
    ``num_chunks`` (``schedule="interleaved"``: chunk ``v`` on rank
    ``p`` is logical stage ``v * pp + p``, so a rank's rows are not
    contiguous in the model).  ``x [B, ...]``: stage 0's input, whole on
    every rank; ``B`` divides into ``num_microbatches``.

    ``with_aux``: ``stage_fn`` returns ``(h, aux_scalar)``; the aux is
    summed over the stages and averaged over the microbatches (each
    stage counts its active ticks only), and the call returns ``(out,
    aux)``.  The output (and aux) is replicated over ``pp``: the last
    stage's, summed over ``pp`` with zeros from the others.  In the
    backward each rank takes the output's gradient as its own (every
    rank computed the same loss from it), so a caller that runs the
    loss on every rank must give the weights it uses after the
    pipeline no gradient on all but one rank, or the gradient sum over
    ``pp`` counts them ``pp`` times (the GPT's forward detaches them
    off the last stage).

    GPipe runs ``M + pp - 1`` ticks, the interleaved pipeline ``M + V *
    pp - 1``, forward and then backward (the reverse order, the
    gradients shifted back).  ``remat=True`` keeps only each stage
    step's input and reruns ``stage_fn`` in the backward (it must then
    draw no random numbers); ``remat=False`` keeps each step's graph.
    The GPT passes ``False`` and recomputes inside its blocks by its
    ``recompute`` mode (the JAX ``remat_policy``)."""
    mesh = mesh or get_mesh()
    pp = num_stages(mesh)
    fn = stage_fn if with_aux else (lambda sp, h: (stage_fn(sp, h), None))
    if pp == 1:
        h = x
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n = next(iter(stage_params.values())).shape[0]
        for s in range(n):
            h, a = fn({k: v[s] for k, v in stage_params.items()}, h)
            if with_aux:
                aux = aux + a
        return (h, aux) if with_aux else h
    V = num_chunks if schedule == "interleaved" else 1
    if schedule not in ("gpipe", "interleaved"):
        raise ValueError(f"pipeline_apply: unknown schedule {schedule!r} "
                         "(gpipe or interleaved; 1f1b and zero_bubble are "
                         "pipeline_value_and_grad's)")
    names = list(stage_params)
    params = [stage_params[k] for k in names]
    for k, t in zip(names, params):
        if t.shape[0] != V:
            raise ValueError(f"pipeline_apply: {k!r} holds {t.shape[0]} "
                             f"stages on this rank, the schedule runs {V}")
    run = _Circular(fn, names, mesh, V, int(num_microbatches), remat,
                    with_aux)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(t.requires_grad for t in params)):
        out, aux = _Pipelined.apply(run, x, *params)
    else:
        out, aux = run.forward(x, params, keep=False)
    return (out, aux) if with_aux else out


class _Pipelined(torch.autograd.Function):
    """The circular schedule as one autograd node: every rank's backward
    reaches it once (the output is replicated, so every rank's loss
    reads it), and there it runs the reverse schedule with its shifts."""

    @staticmethod
    def forward(ctx, run, x, *params):
        ctx.run = run
        return run.forward(x, params, keep=True)

    @staticmethod
    def backward(ctx, g_out, g_aux):
        run, ctx.run = ctx.run, None
        gx, gp = run.backward(g_out, g_aux)
        return (None, gx, *gp)


class _Circular:
    """One rank's part of the GPipe (``V == 1``) or interleaved schedule:
    chunk ``v`` of rank ``p`` is logical stage ``l = v * pp + p`` and
    runs microbatch ``m = t - l`` at tick ``t``.  Activations hop ``p ->
    p + 1`` round the ring; at the wrap (arriving on rank 0) chunk ``v -
    1``'s output feeds chunk ``v``."""

    def __init__(self, fn, names, mesh, V, M, remat, with_aux):
        self.fn, self.names, self.mesh = fn, names, mesh
        self.pp, self.p = mesh.degree("pp"), mesh.index("pp")
        self.last = self.p == self.pp - 1
        self.V, self.M, self.T = V, M, M + V * self.pp - 1
        self.remat, self.with_aux = remat, with_aux

    def _mb(self, t, v):
        m = t - (v * self.pp + self.p)
        return m if 0 <= m < self.M else None

    def _body(self, v, h):
        y, aux = self.fn(self.chunks[v], h)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return y, aux

    def _step(self, t, v, inp, keep):
        """Chunk ``v``'s body on ``inp`` at tick ``t``; keeps what its
        backward needs."""
        if not keep or self.remat:
            if keep:
                self.saved[(t, v)] = inp
            with torch.no_grad():
                return self._body(v, inp)
        leaf = inp.detach().requires_grad_()
        with torch.enable_grad():
            y, aux = self._body(v, leaf)
        self.saved[(t, v)] = (leaf, y, aux)
        return y.detach(), aux.detach()

    def forward(self, x, params, keep):
        M, V = self.M, self.V
        if x.shape[0] % M:
            raise ValueError(f"pipeline: batch {x.shape[0]} does not "
                             f"divide into {M} microbatches")
        mbs = x.detach().split(x.shape[0] // M)
        self.chunks = [{n: t[v].detach().requires_grad_(keep)
                        for n, t in zip(self.names, params)}
                       for v in range(V)]
        self.saved = {}
        zero = torch.zeros_like(mbs[0])
        acts = [zero] * V
        outs = [None] * M
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(self.T):
            sends = []
            for v in range(V):
                m = self._mb(t, v)
                if m is None:
                    sends.append(zero)
                    continue
                inp = mbs[m] if self.p == 0 and v == 0 else acts[v]
                y, aux = self._step(t, v, inp, keep)
                aux_sum += aux.float()
                if self.last and v == V - 1:
                    outs[m] = y
                sends.append(y.to(zero.dtype))
            got = list(_shift_pp(torch.stack(sends), self.mesh, 1).unbind(0))
            acts = got[-1:] + got[:-1] if self.p == 0 else got
        out = torch.cat(outs) if self.last else torch.zeros_like(x)
        _sum_pp(out, self.mesh)
        if self.with_aux:
            _sum_pp(aux_sum, self.mesh)
        return out, aux_sum / M

    def _grad(self, t, v, gy, g_aux):
        """Chunk ``v``'s step at tick ``t`` run backward from ``gy`` (and
        ``g_aux`` on its aux): its input's gradient; its parameters'
        are added up in ``self.acc``."""
        rec = self.saved.pop((t, v))
        leaves = list(self.chunks[v].values())
        with torch.enable_grad():
            if self.remat:
                leaf = rec.detach().requires_grad_()
                y, aux = self._body(v, leaf)
            else:
                leaf, y, aux = rec
            outs, grads = [y], [gy.to(y.dtype)]
            if self.with_aux and aux.requires_grad:
                outs.append(aux)
                grads.append(g_aux.to(aux.dtype))
            got = torch.autograd.grad(outs, [leaf] + leaves, grads,
                                      allow_unused=True)
        acc = self.acc[v]
        for i, g in enumerate(got[1:]):
            if g is not None:
                acc[i] = g if acc[i] is None else acc[i] + g
        return torch.zeros_like(leaf) if got[0] is None else got[0]

    def backward(self, g_out, g_aux):
        M, V = self.M, self.V
        gmb = g_out.split(g_out.shape[0] // M)
        g_aux = g_aux / M
        zero = torch.zeros_like(gmb[0])
        g_recv = [zero] * V
        gx = [None] * M
        self.acc = [[None] * len(self.names) for _ in range(V)]
        for t in reversed(range(self.T)):
            sends = []
            for v in range(V):
                m = self._mb(t, v)
                if m is None:
                    sends.append(zero)
                    continue
                gy = gmb[m] if self.last and v == V - 1 else g_recv[v]
                g_inp = self._grad(t, v, gy, g_aux)
                if self.p == 0 and v == 0:
                    gx[m] = g_inp
                    sends.append(zero)
                else:
                    sends.append(g_inp.to(zero.dtype))
            if self.p == 0:     # the ring's wrap, backward
                sends = sends[1:] + sends[:1]
            g_recv = list(_shift_pp(torch.stack(sends), self.mesh,
                                    -1).unbind(0))
        grads = [torch.stack([acc[i] if acc[i] is not None
                              else torch.zeros_like(self.chunks[v][n])
                              for v, acc in enumerate(self.acc)])
                 for i, n in enumerate(self.names)]
        self.saved = self.acc = self.chunks = None
        return (torch.cat(gx) if self.p == 0 else None), grads


# ---------------------------------------------------------------------------
# 1F1B and zero-bubble
# ---------------------------------------------------------------------------
#
# Per-stage schedules are integer arithmetic on the tick t (P stages, M
# microbatches, w_s = P - s in-flight target):
#     forward  of mb m on stage s at tick  tF = s + m          (m < w_s)
#                                          tF = 2m + s         (m >= w_s)
#     backward of mb m on stage s at tick  tB = 2P - 1 - s + 2m
# tF ticks have parity s and tB parity s + 1, so a stage does at most one
# of {F, B} a tick; 2(M + P - 1) ticks, at most P - s microbatches in
# flight on stage s (GPipe holds M).

def _f_sched(P, M, s, t):
    """``(microbatch, active)`` of a forward step of stage ``s`` at tick
    ``t`` (the JAX values, inactive ticks included)."""
    w = P - s
    d = t - s
    warm = 0 <= d < min(w, M)
    m_steady = d // 2
    steady = d >= 0 and d % 2 == 0 and w <= m_steady < M
    return (d if warm else m_steady), warm or steady


def _b_sched(P, M, s, t):
    """``(microbatch, active)`` of a backward step of stage ``s`` at tick
    ``t``."""
    d = t - (2 * P - 1 - s)
    m = d // 2
    return m, d >= 0 and d % 2 == 0 and m < M


def zero_bubble_tables(P, M):
    """Static tick tables of the zero-bubble (ZB-H1-style) schedule: the
    backward split into dX (the input gradient, on the critical path
    between the stages) and W (the weight gradient, no cross-stage
    dependency).  F and dX keep the 1F1B ticks; each stage's W steps
    fill its idle ticks (at least one tick after that microbatch's dX),
    with ticks appended at the end for leftovers.

    Returns ``{"f", "b" (dX), "w"}``: int32 ``[T, P]`` arrays of the
    microbatch each stage runs (-1 idle), with ``T`` and the ring depth
    ``Q`` (the most microbatches a stage holds between their arrival
    and their W, plus one)."""
    def f_at(s, t):
        w = P - s
        d = t - s
        if d < 0:
            return -1
        if d < min(w, M):
            return d
        if d % 2 == 0 and w <= d // 2 < M:
            return d // 2
        return -1

    def b_at(s, t):
        d = t - (2 * P - 1 - s)
        if d >= 0 and d % 2 == 0 and d // 2 < M:
            return d // 2
        return -1

    Tbase = 2 * (M + P - 1)
    Tmax = Tbase + M + P  # always enough for leftovers
    f = np.full((Tmax, P), -1, np.int32)
    b = np.full((Tmax, P), -1, np.int32)
    w = np.full((Tmax, P), -1, np.int32)
    t_f = np.zeros((P, M), np.int64)
    t_w = np.zeros((P, M), np.int64)
    T = 0
    for s in range(P):
        pending = []  # microbatches whose dX ran, W not yet scheduled
        for t in range(Tmax):
            mf, mb = f_at(s, t), b_at(s, t)
            f[t, s], b[t, s] = mf, mb
            if mf >= 0:
                t_f[s, mf] = t
            if mf < 0 and mb < 0 and pending:
                m = pending.pop(0)
                w[t, s] = m
                t_w[s, m] = t
            if mb >= 0:
                pending.append(mb)
            if not pending and t >= Tbase - 1:
                break
        T = max(T, t + 1)
    f, b, w = f[:T], b[:T], w[:T]

    # ring depth: a microbatch lives on stage s from its activation's
    # arrival (the tick after stage s - 1's forward of it) until its W
    def birth(s, m):
        return t_f[s - 1, m] + 1 if s > 0 else t_f[s, m]

    Q = P + 1
    for s in range(P):
        for m in range(M):
            concurrent = sum(1 for m2 in range(M)
                             if not (t_w[s, m2] < birth(s, m)
                                     or birth(s, m2) > t_w[s, m]))
            Q = max(Q, concurrent + 1)
    return {"f": f, "b": b, "w": w, "T": T, "Q": int(Q)}


class _Stage:
    """One rank's stage of a 1F1B / zero-bubble step: its microbatches'
    forward steps, kept until their backward (``live``), and the
    gradients and loss they add up."""

    def __init__(self, first_fn, mid_call, last_fn, sp, ex, mbs, lbs, p, P,
                 aux_s):
        self.first_fn, self.mid_call, self.last_fn = first_fn, mid_call, \
            last_fn
        self.sp, self.ex, self.mbs, self.lbs = sp, ex, mbs, lbs
        self.p, self.last, self.aux_s = p, p == P - 1, aux_s
        self.leaves = list(sp.values()) + list(ex.values())
        self.grads = [None] * len(self.leaves)
        self.loss = torch.zeros((), dtype=torch.float32,
                                device=mbs[0].device)
        self.h_in = {}      # microbatch -> the activation received
        self.live = {}      # microbatch -> what its backward needs
        self.max_live = 0

    def forward(self, m):
        if self.p == 0:
            inp = None
            h = self.first_fn(self.ex, self.mbs[m])
        else:
            inp = h = self.h_in.pop(m).requires_grad_()
        y, aux = self.mid_call(self.sp, h, m)
        if aux is not None:
            self.loss += aux.detach().float() * self.aux_s
        self.live[m] = (inp, y, aux)
        self.max_live = max(self.max_live, len(self.live))
        return y.detach()

    def _outputs(self, m, gy):
        """Microbatch ``m``'s outputs on this stage and their
        cotangents: the loss (last stage, computed here) or the
        activation, and the aux."""
        inp, y, aux = self.live.pop(m)
        if self.last:
            lv = self.last_fn(self.ex, y, self.lbs[m]).float()
            self.loss += lv.detach()
            outs, grads = [lv], [torch.ones_like(lv)]
        else:
            outs, grads = [y], [gy.to(y.dtype)]
        if aux is not None:
            outs.append(aux)
            grads.append(torch.full_like(aux, self.aux_s))
        return inp, outs, grads

    def _add(self, got):
        for i, g in enumerate(got):
            if g is not None:
                self.grads[i] = g if self.grads[i] is None \
                    else self.grads[i] + g

    def backward(self, m, gy):
        """1F1B: the whole backward of ``m``; returns its input's
        gradient (None on stage 0)."""
        inp, outs, grads = self._outputs(m, gy)
        wrt = self.leaves + ([inp] if inp is not None else [])
        got = torch.autograd.grad(outs, wrt, grads, allow_unused=True)
        self._add(got[:len(self.leaves)])
        return got[-1] if inp is not None else None

    def dx(self, m, gy):
        """Zero-bubble dX: the input's gradient only; the graph stays
        until :meth:`w`."""
        inp, outs, grads = self._outputs(m, gy)
        self.live[m] = (outs, grads)
        if inp is None:
            return None
        (g,) = torch.autograd.grad(outs, [inp], grads, retain_graph=True)
        return g

    def w(self, m):
        """Zero-bubble W: the weight gradients of ``m`` (stage 0's
        embedding's included), from the graph :meth:`dx` kept."""
        outs, grads = self.live.pop(m)
        self._add(torch.autograd.grad(outs, self.leaves, grads,
                                      allow_unused=True))


def pipeline_value_and_grad(first_fn, mid_fn, last_fn, stage_params, extras,
                            inputs, labels, num_microbatches, mesh=None,
                            schedule="1f1b", aux_scale=None):
    """The 1F1B (or zero-bubble) training step's core.

    ``first_fn(extras, mb_inputs) -> h`` is stage 0's prelude (the
    embedding), ``mid_fn(stage_params, h) -> h`` a stage's body (same
    shape out as in), ``last_fn(extras, h, mb_labels) -> loss`` the
    last stage's head and loss (a scalar, summed over the microbatch).
    ``stage_params``: ``{name: tensor}``, this rank's stage;
    ``extras``: ``{name: tensor}``, whole on every rank.  ``inputs``/
    ``labels``: ``[B, ...]``, ``B`` dividing into ``num_microbatches``.

    ``mid_fn.mb_aware = True``: called as ``mid_fn(sp, h, m)`` with the
    microbatch index.  ``mid_fn.aux_aware = True``: returns ``(h,
    aux)``; each microbatch's aux adds ``aux * aux_scale`` to the loss
    and takes ``aux_scale`` as its cotangent.  ``first_fn.like(ids)``,
    where present, gives a tensor of ``h``'s shape and dtype for a
    microbatch's ``ids`` (else ``first_fn`` runs once more, without
    gradients, to find it).

    ``schedule``: ``"1f1b"`` (F by :func:`_f_sched`, B by
    :func:`_b_sched`) or ``"zero_bubble"`` (:func:`zero_bubble_tables`:
    dX is ``torch.autograd.grad`` with respect to the stage input with
    the graph kept, W the later one with respect to the parameters,
    which runs the stage's backward again).  Each microbatch keeps its
    forward's graph (dropout masks included) until its backward.

    Returns ``(loss_sum, d_stage_params, d_extras)``: the loss summed
    over the batch and over ``pp``, this rank's stage gradients and the
    extras' gradients summed over ``pp``."""
    mesh = mesh or get_mesh()
    P_ = num_stages(mesh)
    M = int(num_microbatches)
    if schedule not in ("1f1b", "zero_bubble"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if inputs.shape[0] % M:
        raise ValueError(f"pipeline: batch {inputs.shape[0]} does not "
                         f"divide into {M} microbatches")
    mb_aware = getattr(mid_fn, "mb_aware", False)
    aux_aware = getattr(mid_fn, "aux_aware", False)
    aux_s = 1.0 if aux_scale is None else float(aux_scale)

    def mid_call(sp, h, m):
        out = mid_fn(sp, h, m) if mb_aware else mid_fn(sp, h)
        return out if aux_aware else (out, None)

    sp = {k: v.detach().requires_grad_() for k, v in stage_params.items()}
    ex = {k: v.detach().requires_grad_() for k, v in extras.items()}
    mb = inputs.shape[0] // M
    mbs, lbs = inputs.split(mb), labels.split(mb)
    with torch.enable_grad():
        if P_ == 1:
            if not (mb_aware or aux_aware):     # the batch whole
                mbs, lbs = (inputs,), (labels,)
            st = _Stage(first_fn, mid_call, last_fn, sp, ex, mbs, lbs, 0, 1,
                        aux_s)
            for m in range(len(mbs)):
                st.forward(m)
                st.backward(m, None)
        else:
            st = _Stage(first_fn, mid_call, last_fn, sp, ex, mbs, lbs,
                        mesh.index("pp"), P_, aux_s)
            if hasattr(first_fn, "like"):
                like = first_fn.like(mbs[0])
            else:
                with torch.no_grad():
                    like = first_fn(ex, mbs[0])
            _run_ticks(st, schedule, P_, M, mesh, torch.zeros_like(like))
    counters.set_gauge("pipeline.max_in_flight", st.max_live)
    loss = st.loss
    n = len(sp)
    dsp = {k: g if g is not None else torch.zeros_like(v)
           for (k, v), g in zip(sp.items(), st.grads[:n])}
    dex = {k: g if g is not None else torch.zeros_like(v)
           for (k, v), g in zip(ex.items(), st.grads[n:])}
    if P_ > 1:
        _sum_pp(loss, mesh)
        for g in dex.values():
            _sum_pp(g, mesh)
    return loss, dsp, dex


def _run_ticks(st, schedule, P_, M, mesh, zero):
    """Drive stage ``st`` through the schedule's ticks, shifting the
    activations (+1) and the gradients (-1) on every tick."""
    p = st.p
    if schedule == "zero_bubble":
        tb = zero_bubble_tables(P_, M)
        T = tb["T"]

        def at(key, s, t):
            m = int(tb[key][t, s]) if 0 <= t < T else -1
            return m, m >= 0
        f_at = lambda s, t: at("f", s, t)     # noqa: E731
        b_at = lambda s, t: at("b", s, t)     # noqa: E731
    else:
        T = 2 * (M + P_ - 1)
        f_at = lambda s, t: _f_sched(P_, M, s, t)   # noqa: E731
        b_at = lambda s, t: _b_sched(P_, M, s, t)   # noqa: E731
    act_recv = grad_recv = zero
    for t in range(T):
        # bank the activation stage p - 1 forwarded at tick t - 1
        m_prev, f_prev = f_at(p - 1, t - 1)
        if p > 0 and f_prev:
            st.h_in[m_prev] = act_recv
        m_f, fwd = f_at(p, t)
        send_act = st.forward(m_f).to(zero.dtype) if fwd else zero
        m_b, bwd = b_at(p, t)
        send_grad = zero
        if bwd:
            g = (st.dx(m_b, grad_recv) if schedule == "zero_bubble"
                 else st.backward(m_b, grad_recv))
            if g is not None:
                send_grad = g.to(zero.dtype)
        if schedule == "zero_bubble":
            m_w, wgt = at("w", p, t)
            if wgt:
                st.w(m_w)
        act_recv = _shift_pp(send_act, mesh, 1)
        grad_recv = _shift_pp(send_grad, mesh, -1)


__all__ = ["num_stages", "pipeline_apply", "pipeline_value_and_grad",
           "stack_spec", "zero_bubble_tables"]
