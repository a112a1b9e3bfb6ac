"""The eager collectives (port of
``paddle_tpu/distributed/communication``) over ``torch.distributed``.

Each call acts on **this rank's** tensor, in place where Paddle's does,
and runs on the process group of ``group`` (a :class:`Group`, a mesh
axis name such as ``"mp"``, a torch process group, or None for the whole
world).  Where the two packages differ:

* the JAX versions act in one process on a stacked per-device array or
  a mesh-sharded one; here every rank calls with its own tensor, and a
  rank outside ``group`` must not call;
* ``reduce`` leaves the non-destination ranks' tensors as they were,
  as in the JAX version; ``ReduceOp.AVG`` is a sum divided by the group
  size (gloo has no average);
* ``send``/``recv`` are real point-to-point transfers at any world
  size (the JAX version rendezvouses through an all-gather and holds
  for two processes only);
* ``reduce_scatter(tensor, tensor_list)`` takes a list of chunks or one
  tensor split on dim 0, as the JAX version does;
* :func:`ring_shift` is the JAX ring attention's ``lax.ppermute`` over
  ``sep``: member r's tensor goes to member r + 1 (cyclically), as a
  differentiable function whose backward shifts the gradient back.

Every call ticks ``dist.collectives``, ``dist.collective_launches``
and ``dist.<op>`` (the JAX names) and opens a host-tracer span of that
name.  In the port every collective is issued by the host, so
``dist.collective_launches`` is above 0 on every mesh path (the JAX
package's compiled mesh programs keep it at 0).  A collective the
backend refuses raises ``RuntimeError`` naming the op; nothing copies
the tensor to another device to get round it.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ...core.tensor import Tensor, unwrap
from ...profiler import counters as _counters
from ...profiler import host_tracer as _tracer
from ..env import get_mesh, get_rank, get_world_size, is_initialized  # noqa: F401


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {"sum": "SUM", "max": "MAX", "min": "MIN", "prod": "PRODUCT",
             "avg": "SUM"}


def _op(op):
    return getattr(dist.ReduceOp, _TORCH_OP[op])


class Group:
    """A process group over ``ranks`` (Paddle's ``Group``); ``rank`` is
    this process's index in it (-1 outside it)."""

    def __init__(self, rank=0, ranks=None, axis_names=None, id=0, pg=None):
        self.rank = rank
        self.ranks = list(ranks) if ranks is not None else [0]
        self.axis_names = axis_names
        self.id = id
        self.pg = pg

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def process_group(self):
        return self.pg

    def __repr__(self):
        return f"Group(rank={self.rank}, ranks={self.ranks}, id={self.id})"


_GROUPS = {}
_GROUP_COUNTER = [0]


def new_group(ranks=None, backend=None, timeout=None):
    """A group over ``ranks`` (default: the world).  Every rank calls it,
    members or not, in the same order (``torch.distributed.new_group``)."""
    world = get_world_size()
    ranks = sorted(ranks) if ranks else list(range(world))
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    _GROUP_COUNTER[0] += 1
    me = get_rank()
    g = Group(rank=ranks.index(me) if me in ranks else -1, ranks=ranks,
              id=_GROUP_COUNTER[0], pg=pg)
    _GROUPS[g.id] = g
    return g


def get_group(gid=0):
    if gid == 0 and 0 not in _GROUPS and dist.is_initialized():
        _GROUPS[0] = Group(rank=get_rank(), ranks=list(range(
            get_world_size())), id=0, pg=dist.group.WORLD)
    return _GROUPS.get(gid)


def axis_group(axes, mesh=None):
    """The :class:`Group` of mesh axis (or axes) ``axes`` of ``mesh``
    (default: the global mesh)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError(f"no mesh: build_mesh() before asking for the "
                           f"group of {axes!r}")
    ranks = mesh.group_ranks(axes)
    return Group(rank=mesh.index(axes), ranks=ranks,
                 axis_names=mesh._axes(axes), pg=mesh.group(axes))


def _pg(group):
    if group is None:
        return None
    if isinstance(group, Group):
        return group.pg
    if isinstance(group, (str, tuple)):
        return axis_group(group).pg
    return group   # a torch ProcessGroup


def _nranks(group):
    if group is None:
        return get_world_size()
    if isinstance(group, Group):
        return group.nranks
    return dist.get_world_size(_pg(group))


class _Task:
    """What an eager collective returns: ``wait()`` blocks on the
    backend's work handle when the call was asynchronous."""

    def __init__(self, work=None):
        self._work = work

    def wait(self):
        if self._work is not None:
            self._work.wait()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _run(name, fn):
    try:
        return fn()
    except RuntimeError as e:
        raise RuntimeError(f"{name}: the {dist.get_backend()} backend "
                           f"refused it: {e}") from e


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    t = unwrap(tensor)
    w = _run("all_reduce", lambda: dist.all_reduce(
        t, op=_op(op), group=_pg(group), async_op=not sync_op))
    if op == ReduceOp.AVG:
        if w is not None:
            w.wait()
            w = None
        t.div_(_nranks(group))
    return _Task(w)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Append every member's ``tensor`` to ``tensor_list`` (rank order);
    pass a list of ``nranks`` tensors to have them filled instead."""
    t = unwrap(tensor)
    n = _nranks(group)
    fill = len(tensor_list) == n
    out = ([unwrap(x) for x in tensor_list] if fill
           else [torch.empty_like(t) for _ in range(n)])
    _run("all_gather", lambda: dist.all_gather(out, t, group=_pg(group)))
    if not fill:
        tensor_list.extend(Tensor._wrap(x) if isinstance(tensor, Tensor)
                           else x for x in out)
    return _Task()


def all_gather_object(object_list, obj, group=None):
    n = _nranks(group)
    out = [None] * n
    _run("all_gather_object",
         lambda: dist.all_gather_object(out, obj, group=_pg(group)))
    object_list.extend(out)


def broadcast(tensor, src=0, group=None, sync_op=True):
    t = unwrap(tensor)
    w = _run("broadcast", lambda: dist.broadcast(
        t, src=src, group=_pg(group),
        async_op=not sync_op))
    return _Task(w)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce to ``dst`` (a global rank); the other ranks' tensors stay
    as they were (the backend may use them as scratch, so they are
    restored)."""
    t = unwrap(tensor)
    keep = None if get_rank() == dst else t.clone()
    _run("reduce", lambda: dist.reduce(t, dst=dst, op=_op(op),
                                       group=_pg(group)))
    if keep is not None:
        t.copy_(keep)
    elif op == ReduceOp.AVG:
        t.div_(_nranks(group))
    return _Task()


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Member r receives the reduction of every member's chunk r.
    ``tensor_list`` is a list of ``nranks`` chunks or one tensor split on
    dim 0."""
    n = _nranks(group)
    if isinstance(tensor_list, (list, tuple)):
        srcs = [unwrap(s) for s in tensor_list]
    else:
        srcs = list(torch.chunk(unwrap(tensor_list), n, dim=0))
    if len(srcs) != n:
        raise ValueError(f"reduce_scatter needs exactly nranks={n} input "
                         f"chunks, got {len(srcs)}")
    t = unwrap(tensor)
    srcs = [s.contiguous() for s in srcs]
    _run("reduce_scatter", lambda: dist.reduce_scatter(
        t, srcs, op=_op(op), group=_pg(group)))
    if op == ReduceOp.AVG:
        t.div_(n)
    return _Task()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Global rank ``src`` hands chunk i of ``tensor_list`` to member i."""
    t = unwrap(tensor)
    if get_rank() == src and not tensor_list:
        raise ValueError("scatter: the source rank must provide "
                         "tensor_list (one chunk per group member)")
    lst = ([unwrap(x).contiguous() for x in tensor_list]
           if get_rank() == src else None)
    _run("scatter", lambda: dist.scatter(t, lst, src=src, group=_pg(group)))
    return _Task()


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """out[i] on member r = in[r] on member i."""
    ins = [unwrap(x).contiguous() for x in in_tensor_list]
    fill = len(out_tensor_list) == len(ins)
    outs = ([unwrap(x) for x in out_tensor_list] if fill
            else [torch.empty_like(x) for x in ins])
    _run("all_to_all", lambda: dist.all_to_all(outs, ins, group=_pg(group)))
    if not fill:
        out_tensor_list.extend(outs)
    return _Task()


def send(tensor, dst=0, group=None, sync_op=True):
    w = _run("send", lambda: (dist.send(unwrap(tensor), dst, group=_pg(group))
                              if sync_op else
                              dist.isend(unwrap(tensor), dst, group=_pg(group))))
    return _Task(None if sync_op else w)


def recv(tensor, src=0, group=None, sync_op=True):
    w = _run("recv", lambda: (dist.recv(unwrap(tensor), src, group=_pg(group))
                              if sync_op else
                              dist.irecv(unwrap(tensor), src, group=_pg(group))))
    return _Task(None if sync_op else w)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Post every ``P2POp`` (``isend``/``irecv``) and return their tasks."""
    return [op.op(op.tensor, op.peer, op.group) for op in p2p_op_list]


def barrier(group=None):
    _run("barrier", lambda: dist.barrier(group=_pg(group)))


def _instrumented(fn):
    cname = "dist." + fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _counters.inc("dist.collectives")
        _counters.inc("dist.collective_launches")
        _counters.inc(cname)
        with _tracer.span(cname):
            return fn(*args, **kwargs)
    return wrapper


for _n in ("all_reduce", "all_gather", "all_gather_object", "broadcast",
           "reduce", "reduce_scatter", "scatter", "all_to_all", "send",
           "recv", "barrier"):
    globals()[_n] = _instrumented(globals()[_n])
del _n


def _shift(x, axis, mesh, step, counter="dist.ring_shifts"):
    """``x`` sent to member ``r + step`` of ``axis``'s group and the
    tensor of member ``r - step`` received (cyclically): one
    ``all_to_all_single`` whose split sizes are zero but toward those two
    members, so gloo (which takes CUDA tensors there) and NCCL run the
    same call.  Ticks ``dist.collective_launches`` and ``counter``."""
    n, r = mesh.degree(axis), mesh.index(axis)
    x = x.contiguous()
    send, recv = [0] * n, [0] * n
    send[(r + step) % n] = recv[(r - step) % n] = x.shape[0]
    out = torch.empty_like(x)
    _counters.inc("dist.collective_launches")
    _counters.inc(counter)
    with _tracer.span("dist.ring_shift"):
        _run("ring_shift", lambda: dist.all_to_all_single(
            out, x, output_split_sizes=recv, input_split_sizes=send,
            group=mesh.group(axis)))
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _shift(x, axis, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, ctx.mesh, -1), None, None


def ring_shift(x, axis="sep", mesh=None):
    """This rank's ``x`` (a torch tensor, split sizes taken on dim 0) to
    the next member of mesh axis ``axis`` (default: the global mesh's),
    and the previous member's tensor back.  Differentiable: the gradient
    travels the other way.  Every shift, forward or backward, ticks
    ``dist.collective_launches`` and ``dist.ring_shifts``."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError(f"ring_shift over {axis!r} without a mesh: "
                           "build_mesh() first")
    return _RingShift.apply(x, axis, mesh)


def stream_all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
                      use_calc_stream=False):
    return all_reduce(tensor, op, group, sync_op)


class stream:
    """``paddle.distributed.stream.*``: the same calls (the backend owns
    its streams)."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    reduce_scatter = staticmethod(reduce_scatter)
    scatter = staticmethod(scatter)
    all_to_all = staticmethod(all_to_all)
    send = staticmethod(send)
    recv = staticmethod(recv)


__all__ = ["Group", "P2POp", "ReduceOp", "all_gather", "all_gather_object",
           "all_reduce", "all_to_all", "axis_group", "barrier",
           "batch_isend_irecv", "broadcast", "get_group", "irecv",
           "is_initialized", "isend", "new_group", "recv", "reduce",
           "reduce_scatter", "ring_shift", "scatter", "send", "stream"]
