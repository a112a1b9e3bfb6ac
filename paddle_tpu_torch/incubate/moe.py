"""Mixture-of-Experts: GShard top-k routing over a static per-expert
capacity, and expert parallelism (port of ``paddle_tpu/incubate/moe.py``).

The function is the JAX package's: a router (``x @ gate_w``, softmax in
fp32, cast back), top-k choices by argmax with the first maximum on
ties, each expert's ``capacity = ceil(k * T * cf / E)`` slots filled
choice-major (every token's first choice in token order, then every
second choice), tokens past capacity dropped, top-1 scaled by the raw
router probability and top-k > 1 by the probabilities normalised over
the k choices, the GELU-tanh expert FFN with its bias added to every
slot, and the load-balancing loss ``E * sum(mean(gates) *
mean(mask1))``.

The JAX package builds dense one-hot ``dispatch``/``combine`` tensors
``[T, E, C]`` and contracts them with einsums that XLA fuses.
:func:`topk_gating` and :func:`moe_ffn_dense` keep that form as the
plain version.  :func:`moe_ffn` does not materialise ``[T, E, C]``: it
computes each token's flat slot ``e * C + pos`` per choice with the same
cumsum, gathers the kept tokens into ``[E, C, H]``, runs the two batched
expert products and gathers each token's k outputs back, weighted.  The
gather moves values exactly, so the dispatch equals the dense einsum's
bit for bit; the combine sums the k weighted terms in fp32 (the order of
the k-term sum may differ from the dense contraction's).

Expert parallelism (:class:`ExpertParallel`): tokens split over some
mesh axes see the **global** batch's routing, as the JAX package's
GSPMD program does: the capacity comes from the global token count,
each token's slot is its position in global row order (this rank's count
for an expert starts after the lower ranks', choice by choice: one
all-gather of the ``[k, E]`` counts), and the loss's means are global
(two all-reduces, the one of the router probabilities differentiable:
its backward all-reduces the gradient).  Experts split over a token
axis receive their slots by one all-to-all (each rank sends every owner
its ``[E/n, C, H]`` buffer, the owner sums them: the ranks' slots are
disjoint, so the sum is exact) and send the outputs back by the mirror
all-to-all; each one's backward is the other.  Experts split over ``mp``
on their hidden dimension are a column-parallel ``fc1`` and a
row-parallel ``fc2`` whose all-reduce runs on ``[E, C, H]`` before the
bias and the combine.  Every such collective ticks ``dist.ep_collectives``
and ``dist.collective_launches``.  Shapes depend only on ``T``, so no
step syncs with the host and a CUDA graph captures the whole layer.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.dispatch import apply_op
from ..distributed import mp_ops
from ..distributed.env import (get_mesh, hybrid_degrees, row_axes,
                               sequence_split)
from ..distributed.sharding_utils import P
from ..nn.layer.layers import Layer
from ..profiler import counters as _counters


def moe_capacity(num_tokens, num_experts, top_k, capacity_factor):
    """Static per-expert slot count: ceil(top_k * T * cf / E), >= top_k."""
    return max(int(math.ceil(top_k * num_tokens * capacity_factor
                             / num_experts)), top_k)


def _sum0(x):
    """Sum over the leading axis in fp32.  On the CPU it adds the rows in
    order, one fp32 add a row (``index_add_`` into one row, which adds
    its sources in index order); that is XLA's order on the CPU for up to
    32 rows, the sizes at which the tests hold :func:`topk_gating`
    bit-equal to the JAX package's (``torch.sum`` and ``torch.cumsum``
    accumulate in fp64 there).  On the card it is ``torch.sum``."""
    x = x.float()
    if x.device.type != "cpu":
        return x.sum(0)
    rows = torch.zeros(x.shape[0], dtype=torch.int64)
    return x.new_zeros((1,) + x.shape[1:]).index_add_(0, rows, x)[0]


def _mean0(x):
    """``x.mean(0)`` as the JAX package computes it: the row-order fp32
    sum times ``1 / n``, in ``x``'s dtype."""
    return (_sum0(x) * (1.0 / x.shape[0])).to(x.dtype)


def _aux(me, ce, E):
    """``(me * ce).sum() * E`` in ``me``'s dtype, summed in order, as
    fp32."""
    return ((_sum0(me * ce).to(me.dtype)) * E).float()


def _choices(gates, top_k):
    """The k argmax choices ``[T]`` (first maximum on ties), each masked
    out of the probabilities before the next, as the JAX loop does."""
    E = gates.shape[-1]
    out, g = [], gates
    for _ in range(top_k):
        idx = torch.argmax(g, dim=-1)
        out.append(idx)
        g = g * (1.0 - F.one_hot(idx, E).to(gates.dtype))
    return out


def topk_gating(gates, top_k, capacity):
    """GShard top-k gating over router probabilities ``gates [T, E]``, in
    the JAX package's dense form: returns ``(dispatch [T, E, C] {0, 1},
    combine [T, E, C] weighted, aux scalar, mask1 [T, E])`` in
    ``gates``' dtype.  The plain version :func:`moe_ffn` is held
    against."""
    T, E = gates.shape
    masks = [F.one_hot(i, E).to(gates.dtype) for i in _choices(gates,
                                                                top_k)]
    dispatch = gates.new_zeros((T, E, capacity))
    combine = gates.new_zeros((T, E, capacity))
    if top_k == 1:
        wsum = gates.new_ones((T,))
    else:
        wsum = sum((gates * m).sum(-1) for m in masks)
    offset = torch.zeros(E, dtype=torch.int64, device=gates.device)
    slots = torch.arange(capacity, device=gates.device)
    for m in masks:
        mi = m.to(torch.int64)
        loc = torch.cumsum(mi, 0) - mi + offset[None, :]
        pos = (loc * mi).sum(-1)
        keep = (pos < capacity) & (mi.sum(-1) > 0)
        poh = ((pos[:, None] == slots[None, :]) & keep[:, None]).to(
            gates.dtype)
        d = m[:, :, None] * poh[:, None, :]
        w = (gates * m).sum(-1) / torch.clamp_min(wsum, 1e-9)
        dispatch = dispatch + d
        combine = combine + w[:, None, None] * d
        offset = offset + mi.sum(0)
    mask1 = masks[0]
    aux = _aux(_mean0(gates), _mean0(mask1), E).to(gates.dtype)
    return dispatch, combine, aux, mask1


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def moe_ffn_dense(x, gate_w, fc1_w, fc1_b, fc2_w, fc2_b, top_k=2,
                  capacity_factor=1.25, activation=None):
    """:func:`moe_ffn` through the dense ``[T, E, C]`` einsums of the JAX
    package (one device, no expert parallelism): the plain version."""
    activation = activation or _gelu
    lead, H = x.shape[:-1], x.shape[-1]
    E = gate_w.shape[-1]
    xt = x.reshape(-1, H)
    C = moe_capacity(xt.shape[0], E, top_k, capacity_factor)
    gates = torch.softmax(torch.matmul(xt, gate_w).float(), -1).to(x.dtype)
    dispatch, combine, aux, _ = topk_gating(gates, min(top_k, E), C)
    ex_in = torch.einsum("tec,th->ech", dispatch, xt)
    up = torch.einsum("ech,ehf->ecf", ex_in, fc1_w) + fc1_b[:, None, :]
    down = (torch.einsum("ecf,efh->ech", activation(up), fc2_w)
            + fc2_b[:, None, :])
    y = torch.einsum("ech,tec->th", down, combine)
    return y.reshape(*lead, H), aux.float()


# -- collectives ------------------------------------------------------------

def _tick():
    _counters.inc("dist.ep_collectives")
    _counters.inc("dist.collective_launches")


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the gradient over it too: a
    value every rank computes from the same all-reduced sum and adds to
    its own loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _tick()
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        _tick()
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _a2a(x, group):
    _tick()
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _scatter_sum(x, group, n):
    """Every rank's ``[E, C, H]`` -> this rank's ``[E/n, C, H]`` summed over
    the ranks (chunk ``i`` of the expert axis goes to rank ``i``)."""
    return _a2a(x, group).view(n, x.shape[0] // n, *x.shape[1:]).sum(0)


def _replicate(y, group, n):
    """This rank's ``[E/n, C, H]`` sent to every rank -> ``[E, C, H]``
    (owner by owner)."""
    return _a2a(y.repeat(n, *([1] * (y.dim() - 1))), group)


class _ToExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _scatter_sum(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _replicate(g, ctx.group, ctx.n), None, None


class _FromExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, n):
        ctx.group, ctx.n = group, n
        return _replicate(y, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.n), None, None


class ExpertParallel:
    """How one MoE call spans the ranks of ``mesh``: ``token_axes``, the
    axes the tokens are split over (routing, capacity and the loss are
    global over them), ``expert_axis``, the axis the experts are split
    over (one of the token axes), and ``hidden_axis``, the axis their
    hidden dimension is split over (``mp``).  Axes of degree 1 are
    dropped, so a mesh of one rank runs the local code."""

    def __init__(self, mesh, token_axes=(), expert_axis=None,
                 hidden_axis=None):
        self.mesh = mesh
        self.token_axes = tuple(a for a in token_axes
                                if mesh.degree(a) > 1)
        self.expert_axis = (expert_axis if expert_axis
                            and mesh.degree(expert_axis) > 1 else None)
        self.hidden_axis = (hidden_axis if hidden_axis
                            and mesh.degree(hidden_axis) > 1 else None)
        if self.expert_axis and self.expert_axis not in self.token_axes:
            raise NotImplementedError(
                f"experts split over {self.expert_axis!r} need the tokens "
                f"split over it too (each rank its own rows); the tokens "
                f"are split over {self.token_axes}: a batch replicated "
                "over the expert axis is not supported (a caller whose "
                "ranks each hold their own rows says so with "
                "distributed.env.rows_split_over)")
        self.n_tokens = mesh.degree(self.token_axes) \
            if self.token_axes else 1

    @property
    def token_group(self):
        return self.mesh.group(self.token_axes)

    def __repr__(self):
        return (f"ExpertParallel(tokens={self.token_axes}, "
                f"experts={self.expert_axis}, hidden={self.hidden_axis})")


# -- the indexed route --------------------------------------------------------

class Routing(NamedTuple):
    """One call's routing: ``slots [k, T]`` each choice's flat slot ``e *
    C + pos`` (``E * C`` where the token was dropped), ``weights [k, T]``
    its combine weight, ``aux`` the fp32 load-balancing loss."""
    slots: torch.Tensor
    weights: torch.Tensor
    aux: torch.Tensor
    num_experts: int
    capacity: int


def route(gates, top_k, capacity, ep=None):
    """:func:`topk_gating`'s routing as indices (see :class:`Routing`).
    With ``ep`` splitting the tokens, positions, the loss's means and
    the capacity's token count are those of the global batch."""
    T, E = gates.shape
    dev = gates.device
    choices = _choices(gates, top_k)
    vals = [gates.gather(1, i[:, None])[:, 0] for i in choices]
    if top_k == 1:
        weights = [vals[0]]
    else:
        wsum = torch.clamp_min(sum(vals), 1e-9)
        weights = [v / wsum for v in vals]
    onehot = [F.one_hot(i, E) for i in choices]
    counts = torch.stack([o.sum(0) for o in onehot])           # [k, E]
    group = ep is not None and ep.n_tokens > 1
    if group:
        parts = [torch.empty_like(counts) for _ in range(ep.n_tokens)]
        _tick()
        dist.all_gather(parts, counts, group=ep.token_group)
        allc = torch.stack(parts)                               # [n, k, E]
        r = ep.mesh.index(ep.token_axes)
        before, total = allc[:r].sum(0), allc.sum(0)
        Tg = T * ep.n_tokens
    else:
        before, total, Tg = torch.zeros_like(counts), counts, T
    offset = torch.zeros(E, dtype=torch.int64, device=dev)
    slots = []
    for j, (idx, o) in enumerate(zip(choices, onehot)):
        pos = ((torch.cumsum(o, 0) - o) * o).sum(-1) \
            + (offset + before[j])[idx]
        slots.append(torch.where(pos < capacity, idx * capacity + pos,
                                 E * capacity))
        offset = offset + total[j]
    if group:
        me = (_AllReduceSum.apply(_sum0(gates), ep.token_group)
              * (1.0 / Tg)).to(gates.dtype)
    else:
        me = _mean0(gates)
    ce = (total[0].float() * (1.0 / Tg)).to(gates.dtype)
    aux = _aux(me, ce, E)
    return Routing(torch.stack(slots), torch.stack(weights), aux, E,
                   capacity)


def dispatch(xt, r):
    """The tokens ``xt [T, H]`` in their slots: ``[E, C, H]`` (zeros where
    no token of this rank sits)."""
    T, H = xt.shape
    EC = r.num_experts * r.capacity
    k = r.slots.shape[0]
    src = torch.full((EC + 1,), T, dtype=torch.int64, device=xt.device)
    # dropped choices all land in the dump row EC, which is cut off
    src.index_put_((r.slots.reshape(-1),),
                   torch.arange(T, device=xt.device).repeat(k))
    xp = torch.cat([xt, xt.new_zeros((1, H))])
    return xp[src[:EC]].view(r.num_experts, r.capacity, H)


def combine(down, r, dtype):
    """Each token's k expert outputs from ``down [E, C, H]``, weighted and
    summed in fp32, cast to ``dtype``: ``[T, H]``."""
    E, C, H = down.shape
    dp = torch.cat([down.reshape(E * C, H), down.new_zeros((1, H))])
    y = None
    for s, w in zip(r.slots, r.weights):
        t = w.float()[:, None] * dp[s].float()
        y = t if y is None else y + t
    return y.to(dtype)


def moe_ffn(x, gate_w, fc1_w, fc1_b, fc2_w, fc2_b, top_k=2,
            capacity_factor=1.25, ep=None, activation=None, stats=None):
    """Functional MoE FFN: route -> dispatch -> batched expert FFN ->
    combine.  ``x [..., H]``; ``gate_w [H, E]``; ``fc1_w [E, H, F]``,
    ``fc1_b [E, F]``, ``fc2_w [E, F, H]``, ``fc2_b [E, H]`` (this rank's
    experts and hidden slice under ``ep``, an :class:`ExpertParallel`).
    Returns ``(y [..., H] in x's dtype, aux fp32 scalar)``.
    ``activation`` defaults to GELU-tanh (``jax.nn.gelu``'s default).
    ``stats``, a dict, gathers ``{T: [dropped choices, routed choices]}``
    on the device (no sync)."""
    if sequence_split() is not None:
        # the global routing order is row-major over [B, S]; a rank's
        # tokens are one chunk of each of its rows, which this routing
        # (a rank's tokens after the lower ranks') does not place
        raise NotImplementedError(
            "moe_ffn under a sequence split (a mesh with sep > 1) is not "
            "ported yet: ROADMAP.md A7c-moe (global-batch routing over "
            "the dp x sep tokens)")
    activation = activation or _gelu
    lead, H = x.shape[:-1], x.shape[-1]
    E = gate_w.shape[-1]
    xt = x.reshape(-1, H)
    T = xt.shape[0]
    n_tok = ep.n_tokens if ep is not None else 1
    C = moe_capacity(T * n_tok, E, top_k, capacity_factor)
    gates = torch.softmax(torch.matmul(xt, gate_w).float(), -1).to(x.dtype)
    r = route(gates, min(top_k, E), C, ep)
    ex = dispatch(xt, r)
    experts = ep.expert_axis if ep is not None else None
    hidden = ep.hidden_axis if ep is not None else None
    if experts:
        n = ep.mesh.degree(experts)
        if fc1_w.shape[0] * n != E:
            raise ValueError(f"moe_ffn: {fc1_w.shape[0]} local experts x "
                             f"{experts}={n} != {E}")
        ex = _ToExperts.apply(ex, ep.mesh.group(experts), n)
    if hidden:
        ex = mp_ops.copy_to_mp(ex, hidden, ep.mesh)
    up = torch.bmm(ex, fc1_w) + fc1_b[:, None, :]
    down = torch.bmm(activation(up), fc2_w)
    if hidden:
        down = mp_ops.reduce_from_mp(down, hidden, ep.mesh)
    down = down + fc2_b[:, None, :]
    if experts:
        down = _FromExperts.apply(down, ep.mesh.group(experts), n)
    y = combine(down, r, x.dtype)
    if stats is not None:
        acc = stats.setdefault(T, [torch.zeros((), dtype=torch.int64,
                                               device=x.device), 0])
        acc[0] += (r.slots == E * C).sum()
        acc[1] += r.slots.numel()
    return y.reshape(*lead, H), r.aux


# -- layers -------------------------------------------------------------------

class SwitchGate(Layer):
    """Top-1 router (reference: moe/gate/switch_gate.py)."""

    top_k = 1

    def __init__(self, d_model, num_experts, capacity_factor=1.25):
        super().__init__()
        from ..nn.functional.init_utils import param_attr_init
        from ..nn.initializer import Normal
        self.weight = param_attr_init((d_model, num_experts), "float32",
                                      None, False, Normal(0.0, 0.02))
        self.capacity_factor = capacity_factor


class GShardGate(SwitchGate):
    """Top-2 router (reference: moe/gate/gshard_gate.py)."""

    top_k = 2

    def __init__(self, d_model, num_experts, capacity_factor=2.0):
        super().__init__(d_model, num_experts, capacity_factor)


class MoELayer(Layer):
    """Expert-parallel MoE FFN layer (reference: moe/moe_layer.py:263).

    The experts are a stacked FFN, ``fc1 [E, H, F]``, ``fc2 [E, F, H]``.
    Under a global mesh whose ``ep_axis`` degree divides ``E`` each rank
    holds its ``E / degree`` experts (and its ``mp`` slice of ``F``) and
    the tokens meet them by all-to-all; otherwise the experts are
    replicated, with a ``RuntimeWarning`` when the axis has more than one
    rank, as in the JAX layer.  After ``forward``, ``aux_loss`` holds the
    load-balancing loss: add ``layer.aux_loss * coeff`` to the training
    loss."""

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 top_k=None, capacity_factor=None, ep_axis="dp"):
        super().__init__()
        from ..distributed.fleet.mp_layers import _mp_param
        from ..nn.initializer import Constant, Normal
        if isinstance(gate, str):
            cls = {"switch": SwitchGate, "gshard": GShardGate}[gate]
            gate = cls(d_model, num_experts)
        self.gate = gate
        self.top_k = top_k if top_k is not None else gate.top_k
        self.capacity_factor = (capacity_factor if capacity_factor
                                is not None else gate.capacity_factor)
        self.num_experts = num_experts
        deg = max(hybrid_degrees().get(ep_axis, 1), 1) if ep_axis else 1
        # replicate experts when they can't shard evenly over the axis
        self.ep_axis = ep_axis if (ep_axis and num_experts % deg == 0) \
            else None
        if ep_axis and deg > 1 and self.ep_axis is None:
            warnings.warn(
                f"MoELayer: num_experts={num_experts} does not divide the "
                f"'{ep_axis}' axis degree {deg}; experts will be REPLICATED "
                "(no expert parallelism). Choose num_experts as a multiple "
                f"of {deg} for EP sharding.", RuntimeWarning, stacklevel=2)
        if num_experts >= 64:
            warnings.warn(
                f"MoELayer: the GShard dense one-hot dispatch materialises "
                f"[tokens, E={num_experts}, capacity] tensors — memory "
                "grows linearly in E; at E>=64 consider a sparser routing "
                "formulation", RuntimeWarning, stacklevel=2)
        ep = self.ep_axis
        init, zeros = Normal(0.0, 0.02), Constant(0.0)
        E, H, Fh = num_experts, d_model, d_hidden
        self.fc1_w = _mp_param(self, (E, H, Fh), None, False, init,
                               P(ep, None, "mp"))
        self.fc1_b = _mp_param(self, (E, Fh), None, True, zeros,
                               P(ep, "mp"))
        self.fc2_w = _mp_param(self, (E, Fh, H), None, False, init,
                               P(ep, "mp", None))
        self.fc2_b = _mp_param(self, (E, H), None, True, zeros, P(ep, None))
        self.aux_loss = None

    def _parallel(self):
        mesh = get_mesh()
        if mesh is None:
            return None
        spec = tuple(self.fc1_w._data.placements) + (None,) * 3
        return ExpertParallel(mesh, row_axes(), spec[0],
                              spec[2])

    def forward(self, x):
        ep = self._parallel()

        def fn(xv, gw, w1, b1, w2, b2):
            return moe_ffn(xv, gw, w1, b1, w2, b2, top_k=self.top_k,
                           capacity_factor=self.capacity_factor, ep=ep)
        y, aux = apply_op("moe_ffn", fn, x, self.gate.weight, self.fc1_w,
                          self.fc1_b, self.fc2_w, self.fc2_b)
        self.aux_loss = aux
        return y


__all__ = ["ExpertParallel", "GShardGate", "MoELayer", "Routing",
           "SwitchGate", "combine", "dispatch", "moe_capacity", "moe_ffn",
           "moe_ffn_dense", "route", "topk_gating"]
