"""Megatron's tensor-parallel primitives over the ``mp`` process group
(port of ``paddle_tpu/distributed/mp_ops.py``).

The JAX versions are ``custom_vjp`` functions over a manual ``shard_map``
axis; here each is a ``torch.autograd.Function`` whose forward and
backward call the collective on the group of mesh axis ``axis``:

* :func:`copy_to_mp` (Megatron's g, Paddle's ``_c_identity``): identity
  forward, all-reduce of the gradient backward — at the input of a
  column-parallel region;
* :func:`reduce_from_mp` (f, ``_mp_allreduce``): all-reduce forward,
  identity backward — at the output of a row-parallel matmul;
* :func:`gather_from_mp` (``_c_concat``): all-gather along the last
  dimension forward, this rank's slice of the gradient backward;
* :func:`scatter_to_mp` (``_c_split``): this rank's slice of the last
  dimension forward, all-gather of the gradient backward;
* :func:`vocab_parallel_embedding` and :func:`vocab_parallel_ce_sum`.

Each collective ticks ``dist.<axis>_collectives`` (``dist.mp_collectives``
over ``mp``) and ``dist.collective_launches``.  The backward's collectives run inside
autograd, so a captured training step records them in its CUDA graph.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..profiler import counters as _counters
from .env import get_mesh


def _mesh(mesh, axis):
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError(f"tensor-parallel op over {axis!r} without a "
                           "mesh: build_mesh() first")
    return mesh


def _tick(axis):
    _counters.inc(f"dist.{axis}_collectives")
    _counters.inc("dist.collective_launches")


def _all_reduce(x, axis, mesh):
    _tick(axis)
    x = x.contiguous()
    dist.all_reduce(x, group=mesh.group(axis))
    return x


def _all_gather_last(x, axis, mesh):
    _tick(axis)
    parts = [torch.empty_like(x) for _ in range(mesh.degree(axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, -1)


def _slice_last(x, axis, mesh):
    w = x.shape[-1] // mesh.degree(axis)
    return x.narrow(-1, mesh.index(axis) * w, w).contiguous()


def _all_gather_seq(x, axis, mesh, dim):
    _tick(axis)
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(mesh.degree(axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, dim)


def _chunk_seq(x, axis, mesh, dim):
    w = x.shape[dim] // mesh.degree(axis)
    return x.narrow(dim, mesh.index(axis) * w, w).contiguous()


def _reduce_scatter_seq(x, axis, mesh, dim):
    """Chunk r of ``dim`` summed over the ranks lands on rank r."""
    n = mesh.degree(axis)
    _tick(axis)
    chunks = torch.stack(x.chunk(n, dim))        # [n, ..., S/n, ...]
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=mesh.group(axis))
    return out.sum(0)


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = axis, mesh, dim
        return _all_gather_seq(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, *ctx.args), None, None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = axis, mesh, dim
        return _reduce_scatter_seq(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, *ctx.args), None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = axis, mesh, dim
        return _chunk_seq(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, *ctx.args), None, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = axis, mesh, dim
        return _all_gather_seq(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk_seq(g, *ctx.args), None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.axis, ctx.mesh), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _all_reduce(x.clone(), axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _all_gather_last(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.axis, ctx.mesh), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _slice_last(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.axis, ctx.mesh), None, None


def copy_to_mp(x, axis="mp", mesh=None):
    """Identity forward; all-reduce of the gradient backward."""
    return _Copy.apply(x, axis, _mesh(mesh, axis))


def reduce_from_mp(x, axis="mp", mesh=None):
    """All-reduce (sum) forward; identity backward."""
    return _Reduce.apply(x, axis, _mesh(mesh, axis))


def gather_from_mp(x, axis="mp", mesh=None):
    """All-gather along the last dimension; backward keeps this rank's
    slice of the gradient."""
    return _Gather.apply(x, axis, _mesh(mesh, axis))


def scatter_to_mp(x, axis="mp", mesh=None):
    """This rank's slice of the last dimension; backward all-gathers."""
    return _Scatter.apply(x, axis, _mesh(mesh, axis))


def all_gather_seq(x, axis="mp", mesh=None, dim=1):
    """The whole sequence from every rank's chunk (all-gather along
    ``dim``); backward: the gradient summed over the ranks, this rank's
    chunk kept (reduce-scatter)."""
    return _AllGatherSeq.apply(x, axis, _mesh(mesh, axis), dim)


def reduce_scatter_seq(x, axis="mp", mesh=None, dim=1):
    """``x`` summed over the ranks, this rank's chunk of ``dim`` kept;
    backward all-gathers."""
    return _ReduceScatterSeq.apply(x, axis, _mesh(mesh, axis), dim)


def scatter_seq(x, axis="mp", mesh=None, dim=1):
    """This rank's chunk of ``dim``; backward all-gathers."""
    return _ScatterSeq.apply(x, axis, _mesh(mesh, axis), dim)


def gather_seq(x, axis="mp", mesh=None, dim=1):
    """All-gather along ``dim``; backward keeps this rank's chunk of the
    gradient (every rank holds the same one)."""
    return _GatherSeq.apply(x, axis, _mesh(mesh, axis), dim)


def vocab_parallel_embedding(ids, wte_local, axis="mp", mesh=None):
    """Lookup into a vocab-row-sharded table ``wte_local [V/mp, H]``:
    ids outside this rank's rows give zeros and the all-reduce
    assembles the full vectors."""
    mesh = _mesh(mesh, axis)
    vloc = wte_local.shape[0]
    local = ids - mesh.index(axis) * vloc
    ok = (local >= 0) & (local < vloc)
    h = wte_local[local.clamp(0, vloc - 1)]
    h = torch.where(ok[..., None], h, torch.zeros((), dtype=h.dtype,
                                                  device=h.device))
    return reduce_from_mp(h, axis, mesh)


def vocab_parallel_ce_sum(logits_local, labels, axis="mp", mesh=None):
    """Token-sum of :func:`vocab_parallel_ce`."""
    return torch.sum(vocab_parallel_ce(logits_local, labels, axis, mesh))


def vocab_parallel_ce(logits_local, labels, axis="mp", mesh=None):
    """Per-token cross entropy over vocab-column-sharded logits
    ``[..., V/mp]`` without gathering the vocab axis: two all-reduces
    (max, then the sum of exponentials) and a masked label pick,
    reduced over ``axis``.  The max is detached: its contribution
    cancels analytically."""
    mesh = _mesh(mesh, axis)
    lg = logits_local.float()
    vloc = lg.shape[-1]
    zmax = lg.detach().amax(-1)
    _tick(axis)
    dist.all_reduce(zmax, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    sumexp = reduce_from_mp(torch.exp(lg - zmax[..., None]).sum(-1), axis,
                            mesh)
    lse = torch.log(sumexp) + zmax
    local = labels.long() - mesh.index(axis) * vloc
    ok = (local >= 0) & (local < vloc)
    picked = lg.gather(-1, local.clamp(0, vloc - 1)[..., None])[..., 0]
    picked = reduce_from_mp(torch.where(ok, picked, 0.0), axis, mesh)
    return lse - picked


__all__ = ["all_gather_seq", "copy_to_mp", "gather_from_mp", "gather_seq",
           "reduce_from_mp", "reduce_scatter_seq", "scatter_seq",
           "scatter_to_mp", "vocab_parallel_ce", "vocab_parallel_ce_sum",
           "vocab_parallel_embedding"]
