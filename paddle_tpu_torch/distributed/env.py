"""The parallel environment and the device mesh (port of
``paddle_tpu/distributed/env.py``).

The JAX package runs one process over every device and names the
parallel dimensions as the axes of one ``jax.sharding.Mesh``; GSPMD then
inserts the collectives.  PyTorch's idiom is one process a rank:
:func:`init_parallel_env` starts ``torch.distributed`` and
:func:`build_mesh` lays the ranks out on a
``torch.distributed.device_mesh.DeviceMesh`` over the same axis order,
``pp -> dp -> sharding -> sep -> mp`` (the innermost axis, ``mp``, holds
neighbouring ranks).  Each axis has its process group
(:meth:`Mesh.group`); the port's code holds plain local shards and calls
the collectives itself, as Megatron does.

The backend is Paddle's ``PADDLE_DISTRI_BACKEND`` when it is set, else
``nccl`` when the default device is CUDA and ``gloo`` when the caller
asked for the CPU (``paddle.set_device("cpu")``); nothing falls back to
another backend because a GPU or NCCL is missing.  Rank, world size and
the rendezvous come from the arguments or from Paddle's launcher
variables (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_MASTER`` as ``host:port``); a world of one with no address
rendezvouses through an in-process ``HashStore`` (no network).
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.distributed as dist

AXIS_ORDER = ("pp", "dp", "sharding", "sep", "mp")

_GLOBAL_MESH = [None]
_HYBRID_DEGREES = dict.fromkeys(AXIS_ORDER, 1)
_INITIALIZED = [False]
_ROW_AXES = [()]
_SEQ_SPLIT = [None]


def is_initialized():
    """True once :func:`init_parallel_env` or :func:`build_mesh` ran."""
    return _INITIALIZED[0] or _GLOBAL_MESH[0] is not None


def _backend():
    b = os.environ.get("PADDLE_DISTRI_BACKEND")
    if b:
        return b.lower()
    from ..device import default_device
    return "nccl" if default_device().type == "cuda" else "gloo"


def init_parallel_env(backend=None, rank=None, world_size=None,
                      init_method=None, store=None, timeout=None):
    """Start ``torch.distributed`` (idempotent) and return a
    :class:`ParallelEnv`.  ``backend`` defaults as the module docstring
    says; ``rank``/``world_size`` default to ``PADDLE_TRAINER_ID`` /
    ``PADDLE_TRAINERS_NUM`` (0 / 1); ``init_method`` (``tcp://...`` or
    ``file://...``) or ``store`` to ``PADDLE_MASTER``, else, for a world
    of one, a ``HashStore``.  A rank takes the card
    ``FLAGS_selected_gpus`` (the launcher's and the elastic agent's
    slot, under any backend), else under NCCL ``PADDLE_LOCAL_RANK``
    (default: rank modulo the card count)."""
    if dist.is_initialized():
        _INITIALIZED[0] = True
        return ParallelEnv()
    backend = (backend or _backend()).lower()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0) if rank is None
               else rank)
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1)
                     if world_size is None else world_size)
    if init_method is None and store is None:
        master = os.environ.get("PADDLE_MASTER")
        if master:
            init_method = (master if "://" in master else "tcp://" + master)
        elif world_size == 1:
            store = dist.HashStore()
        else:
            raise RuntimeError(
                f"init_parallel_env: world size {world_size} needs a "
                "rendezvous: pass init_method= or store=, or set "
                "PADDLE_MASTER")
    selected = os.environ.get("FLAGS_selected_gpus")
    if backend == "nccl" or (selected and torch.cuda.is_available()):
        local = int(selected.split(",")[0]) if selected else int(
            os.environ.get("PADDLE_LOCAL_RANK",
                           rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size, **kw)
    _INITIALIZED[0] = True
    return ParallelEnv()


def reset_parallel_env():
    """Drop the global mesh and the hybrid degrees and destroy the
    process group (test isolation; every phase that started one ends
    here)."""
    _GLOBAL_MESH[0] = None
    for k in _HYBRID_DEGREES:
        _HYBRID_DEGREES[k] = 1
    _INITIALIZED[0] = False
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank(group=None):
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def get_world_size(group=None):
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


class ParallelEnv:
    """Paddle's ``ParallelEnv`` over the process group."""

    @property
    def rank(self):
        return get_rank()

    local_rank = rank

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def device_id(self):
        if torch.cuda.is_available() and dist.is_initialized() \
                and dist.get_backend() == "nccl":
            return torch.cuda.current_device()
        return 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def nrings(self):
        return 1


class Mesh:
    """The ranks laid out over :data:`AXIS_ORDER` on a ``DeviceMesh``.

    ``shape`` maps every axis to its degree (as a JAX mesh's
    ``shape``), ``size`` is their product, ``coord`` this rank's index on
    each axis.  :meth:`group` is the process group of one axis (the
    ``DeviceMesh``'s own) or of several axes taken together (made once,
    by every rank in the same order, and kept)."""

    def __init__(self, degrees, device_type):
        self.axis_names = AXIS_ORDER
        self.shape = {a: int(degrees[a]) for a in AXIS_ORDER}
        self.size = math.prod(self.shape.values())
        from torch.distributed.device_mesh import init_device_mesh
        self.device_mesh = init_device_mesh(
            device_type, tuple(self.shape.values()),
            mesh_dim_names=AXIS_ORDER)
        self.rank = dist.get_rank()
        self._ranks = np.arange(self.size).reshape(
            tuple(self.shape.values()))
        idx = np.unravel_index(self.rank, self._ranks.shape)
        self.coord = {a: int(i) for a, i in zip(AXIS_ORDER, idx)}
        self._groups = {}

    @staticmethod
    def _axes(axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def degree(self, axes):
        """Product of the degrees of ``axes`` (an axis name, a tuple of
        them, or None for 1)."""
        if axes is None:
            return 1
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes):
        """This rank's index inside the group of ``axes`` (row-major
        over the axes in mesh order)."""
        axes = [a for a in AXIS_ORDER if a in self._axes(axes)]
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord[a]
        return i

    def group_ranks(self, axes):
        """The global ranks of this rank's group over ``axes``."""
        axes = self._axes(axes)
        sl = tuple(slice(None) if a in axes else self.coord[a]
                   for a in AXIS_ORDER)
        return [int(r) for r in self._ranks[sl].reshape(-1)]

    def group(self, axes):
        """The process group of ``axes``."""
        axes = tuple(a for a in AXIS_ORDER if a in self._axes(axes))
        g = self._groups.get(axes)
        if g is None and len(axes) == 1:
            g = self._groups[axes] = self.device_mesh.get_group(axes[0])
        if g is None:
            keep = [i for i, a in enumerate(AXIS_ORDER) if a in axes]
            moved = np.moveaxis(self._ranks, keep, list(
                range(self._ranks.ndim - len(keep), self._ranks.ndim)))
            n = math.prod(self.shape[a] for a in axes)
            for ranks in moved.reshape(-1, n):
                pg = dist.new_group([int(r) for r in ranks])
                if self.rank in ranks:
                    g = pg
            self._groups[axes] = g
        return g

    def __repr__(self):
        inner = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({inner}; rank {self.rank})"


def build_mesh(degrees=None, device_type=None):
    """Build the global mesh over the process group's ranks (starting
    the group with :func:`init_parallel_env` when none is running).
    ``degrees`` maps axes of :data:`AXIS_ORDER` to degrees; missing axes
    get 1 and one ``-1`` axis takes the rest.  Their product must be the
    world size.  ``device_type`` defaults to ``cuda`` under NCCL, else
    ``cpu``."""
    if not dist.is_initialized():
        init_parallel_env()
    n = dist.get_world_size()
    deg = dict.fromkeys(AXIS_ORDER, 1)
    if degrees:
        unknown_axes = sorted(set(degrees) - set(AXIS_ORDER))
        if unknown_axes:
            raise ValueError(f"mesh axes {unknown_axes}: the mesh has "
                             f"{AXIS_ORDER}")
        deg.update({k: int(v) for k, v in degrees.items()})
    rest = [a for a, v in deg.items() if v == -1]
    known = math.prod(v for v in deg.values() if v != -1)
    if rest:
        deg[rest[0]] = n // known
    total = math.prod(deg.values())
    if total != n:
        raise ValueError(f"mesh degrees {deg} product {total} != world "
                         f"size {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = Mesh(deg, device_type)
    _GLOBAL_MESH[0] = mesh
    _HYBRID_DEGREES.update(deg)
    _INITIALIZED[0] = True
    return mesh


def get_mesh():
    return _GLOBAL_MESH[0]


def set_mesh(mesh):
    _GLOBAL_MESH[0] = mesh
    if mesh is not None:
        _HYBRID_DEGREES.update(mesh.shape)
    return mesh


def hybrid_degrees():
    return dict(_HYBRID_DEGREES)


def data_axes():
    """The axes the batch is split over: ``dp`` and ``sharding`` where
    their degree is above 1, else ``("dp",)``."""
    axes = [a for a in ("dp", "sharding") if _HYBRID_DEGREES.get(a, 1) > 1]
    return tuple(axes) if axes else ("dp",)


def row_axes():
    """The mesh axes over which the batch the running forward sees is
    split, each rank holding its own rows: ``()`` (every rank holds the
    whole batch) unless the innermost :func:`rows_split_over` says
    otherwise.  The mesh train step sets it from the rows it hands its
    rank; the MoE layers read it to route the global batch."""
    return _ROW_AXES[0]


@contextlib.contextmanager
def rows_split_over(axes):
    """Within the block, :func:`row_axes` is ``axes``."""
    prev, _ROW_AXES[0] = _ROW_AXES[0], tuple(axes)
    try:
        yield
    finally:
        _ROW_AXES[0] = prev


class SequenceSplit:
    """Every sequence the running forward sees is cut into ``degree``
    equal chunks along mesh axis ``axis`` (the JAX package's ``sep``),
    chunk ``index`` on this rank, in global order: a local sequence of
    ``S`` tokens starts at position :meth:`offset` ``(S)``."""

    def __init__(self, mesh, axis="sep"):
        self.mesh, self.axis = mesh, axis
        self.degree = mesh.degree(axis)
        self.index = mesh.index(axis)

    def offset(self, local_len):
        return self.index * local_len


def sequence_split():
    """The :class:`SequenceSplit` of the running forward, or None when it
    sees whole sequences.  The mesh train step sets it on a mesh with
    ``sep > 1``; the GPT forward reads it (positions, RoPE, attention
    across the chunks) and so does the loss (its token count)."""
    return _SEQ_SPLIT[0]


def token_axes():
    """The axes the tokens of the running forward are split over: the
    rows' (:func:`row_axes`), then the sequence's."""
    sp = _SEQ_SPLIT[0]
    return row_axes() + (() if sp is None else (sp.axis,))


@contextlib.contextmanager
def sequence_split_over(axis, mesh=None):
    """Within the block, :func:`sequence_split` cuts the sequence over
    ``axis`` of ``mesh`` (default: the global mesh); ``axis=None`` or a
    degree of 1 leaves the sequences whole."""
    mesh = mesh or get_mesh()
    split = (None if axis is None or mesh is None or mesh.degree(axis) == 1
             else SequenceSplit(mesh, axis))
    prev, _SEQ_SPLIT[0] = _SEQ_SPLIT[0], split
    try:
        yield split
    finally:
        _SEQ_SPLIT[0] = prev
