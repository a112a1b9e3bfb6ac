"""The auto-parallel DistTensor API (port of
``paddle_tpu/distributed/auto_parallel``; reference:
python/paddle/distributed/auto_parallel/api.py — shard_tensor:131,
reshard:579, shard_layer:678, to_static:2345).

The JAX package leaves placement to GSPMD: a ``ProcessMesh`` wraps a
``jax.sharding.Mesh``, placements become a ``PartitionSpec`` and
``reshard`` is a ``device_put``, over arrays that are global.  The port
runs one process a rank, so a dist tensor is this rank's piece:

* a :class:`ProcessMesh` names axes of the port's mesh
  (``distributed.env.AXIS_ORDER``); :meth:`ProcessMesh.to_mesh` returns
  the global mesh of those degrees, building it when there is none;
* placements become the port's ``P`` spec (``t.placements``) on that
  mesh; ``Shard(d)`` over an axis keeps this rank's contiguous chunk of
  dimension ``d``, ``Replicate`` the whole, ``Partial`` a summand (the
  whole on the axis' first rank and zeros elsewhere when it comes from
  a whole tensor, as the reference's r-to-p reshard);
* :func:`reshard` moves a piece between placements with host-issued
  collectives: ``Partial`` axes all-reduced, ``Shard`` axes all-gathered,
  then the target's chunks kept (its ``Partial`` axes zeroed off their
  first rank).  It moves values only: autograd does not see it;
* a **parameter** stays whole (the model's forward computes with the
  whole weight, as the JAX package's global arrays do); its placements
  are recorded as ``placements``, which ``jit.mesh.MeshPlan`` reads as
  its storage sharding: the optimizer state and fp32 master hold this
  rank's piece and the parameter is all-gathered after each update.  So
  :func:`shard_layer` with a tensor-parallel ``shard_fn`` splits the
  training state, not the products: the tensor-parallel products are
  ``fleet``'s layers and the GPT built under a mesh;
* :func:`dtensor_to_local` returns this rank's piece (the reference's
  local tensor); the JAX package returns the global array (ROADMAP.md C);
* :func:`to_static` with a loss and an optimizer returns the port's
  ``DistributedTrainStep`` over the global mesh, as the JAX package
  does; without them, a ``DistributedEvalStep`` of the layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Parameter, Tensor, unwrap
from ..env import AXIS_ORDER, build_mesh, get_mesh, set_mesh
from ..sharding_utils import (P, _axes_of, annotate_param, gather_shard,
                              local_shard)


class Placement:
    pass


class Replicate(Placement):
    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def is_replicated(self):
        return True

    def is_shard(self, dim=None):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim):
        self.dim = dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def get_dim(self):
        return self.dim

    def is_replicated(self):
        return False

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def is_partial(self):
        return False


class Partial(Placement):
    def __init__(self, reduce_type=None):
        self.reduce_type = reduce_type

    def __repr__(self):
        return "Partial()"

    def __eq__(self, other):
        return isinstance(other, Partial)

    def is_replicated(self):
        return False

    def is_shard(self, dim=None):
        return False

    def is_partial(self):
        return True


class ProcessMesh:
    """reference: auto_parallel/process_mesh.py."""

    def __init__(self, mesh, dim_names=None, shape=None, process_ids=None):
        arr = np.asarray(mesh)
        self._shape = list(arr.shape)
        self._process_ids = arr.reshape(-1).tolist()
        self._dim_names = dim_names or [f"d{i}" for i in range(arr.ndim)]
        self._arr = arr

    @property
    def shape(self):
        return self._shape

    @property
    def process_ids(self):
        return self._process_ids

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def ndim(self):
        return len(self._shape)

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._process_ids == other._process_ids)

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dims={self._dim_names})"

    def get_mesh_with_dim(self, dim_name, index=None):
        ax = self._dim_names.index(dim_name)
        moved = np.moveaxis(self._arr, ax, 0)
        names = ([dim_name] + [n for n in self._dim_names if n != dim_name])
        if index is not None:
            return ProcessMesh(moved[index],
                               [n for n in self._dim_names if n != dim_name])
        return ProcessMesh(moved, names)

    def to_mesh(self):
        """The port's mesh with these axes' degrees (every other axis 1):
        the global mesh when it has them, else one built and set as the
        global mesh.  The axes must be mesh axes named in
        ``AXIS_ORDER``'s order, and the process ids the ranks laid out
        as that mesh lays them out (row-major)."""
        names = list(self._dim_names)
        bad = [n for n in names if n not in AXIS_ORDER]
        if bad:
            raise ValueError(f"ProcessMesh dims {bad}: the port's mesh axes "
                             f"are {AXIS_ORDER}")
        if names != sorted(names, key=AXIS_ORDER.index):
            raise ValueError(f"ProcessMesh dims {names}: name them in the "
                             f"mesh's order {AXIS_ORDER}")
        if self._process_ids != list(range(len(self._process_ids))):
            raise ValueError(f"ProcessMesh process ids {self._process_ids}:"
                             " the port's mesh lays ranks 0..n-1 out "
                             "row-major")
        want = dict.fromkeys(AXIS_ORDER, 1)
        want.update(zip(names, self._shape))
        mesh = get_mesh()
        if mesh is not None and mesh.shape == want:
            return mesh
        return build_mesh({a: n for a, n in want.items() if n > 1})


def _placements_to_spec(placements, ndim):
    spec = [None] * ndim
    for axis_idx, p in enumerate(placements):
        if isinstance(p, Shard):
            if spec[p.dim] is None:
                spec[p.dim] = []
            spec[p.dim] = spec[p.dim] + [axis_idx]
    out = []
    for s in spec:
        out.append(None if s is None else tuple(s))
    return out


def _spec_with_names(placements, mesh, ndim):
    names = mesh.dim_names
    spec = [None] * ndim
    for axis_idx, p in enumerate(placements):
        if isinstance(p, Shard):
            cur = spec[p.dim]
            if cur is None:
                spec[p.dim] = names[axis_idx]
            elif isinstance(cur, tuple):
                spec[p.dim] = cur + (names[axis_idx],)
            else:
                spec[p.dim] = (cur, names[axis_idx])
    return P(*spec)


def _partial_axes(placements, mesh):
    return [mesh.dim_names[i] for i, p in enumerate(placements)
            if isinstance(p, Partial)]


def _local_of(whole, placements, mesh):
    """This rank's piece of ``whole`` under ``placements`` of ``mesh``."""
    port = mesh.to_mesh()
    local = local_shard(whole, _spec_with_names(placements, mesh,
                                                whole.dim()), port)
    if any(port.index(a) != 0 for a in _partial_axes(placements, mesh)):
        local = torch.zeros_like(local)
    return local


def _annotate(t, mesh, placements, whole):
    t.is_dist = True
    t.placements = _spec_with_names(placements, mesh,
                                    unwrap(t).dim())
    t.dist_placements = list(placements)
    t.process_mesh = mesh
    t._dist_whole = whole
    return t


def shard_tensor(data, mesh, placements, dtype=None, place=None,
                 stop_gradient=None):
    """reference: auto_parallel/api.py:131.  ``data`` is the whole tensor
    (the same on every rank).  A parameter is annotated in place and
    stays whole (module docstring); anything else gives a new tensor
    holding this rank's piece."""
    if isinstance(data, (Parameter, torch.nn.Parameter)):
        t = data
        spec = _spec_with_names(placements, mesh, unwrap(t).dim())
        mesh.to_mesh()
        if _partial_axes(placements, mesh):
            raise ValueError("shard_tensor: a parameter cannot be Partial")
        annotate_param(t, spec)
        if stop_gradient is not None:
            t.stop_gradient = stop_gradient
        return _annotate(t, mesh, placements, whole=True)
    whole = unwrap(data if isinstance(data, Tensor)
                   else Tensor(data, dtype=dtype, place=place))
    try:
        local = _local_of(whole.detach(), placements, mesh)
    except (RuntimeError, ValueError) as e:
        raise ValueError(
            f"shard_tensor: cannot place shape {tuple(whole.shape)} with "
            f"placements {placements} on mesh "
            f"{dict(zip(mesh.dim_names, mesh.shape))}: {e}") from e
    t = Tensor._wrap(local)
    t.stop_gradient = (data.stop_gradient if stop_gradient is None
                       and isinstance(data, Tensor) else
                       True if stop_gradient is None else stop_gradient)
    return _annotate(t, mesh, placements, whole=False)


def dtensor_from_local(local_tensor, mesh, placements):
    """reference: api.py:499: ``local_tensor`` is this rank's piece."""
    t = Tensor._wrap(unwrap(local_tensor if isinstance(local_tensor, Tensor)
                            else Tensor(local_tensor)))
    return _annotate(t, mesh, placements, whole=False)


def _piece(t):
    """(this rank's piece of dist tensor ``t``, its placements)."""
    data = unwrap(t).detach()
    if getattr(t, "_dist_whole", False):
        return _local_of(data, t.dist_placements, t.process_mesh), \
            t.dist_placements
    return data, t.dist_placements


def dtensor_to_local(dist_tensor, mesh=None, placements=None):
    """This rank's piece (a parameter's is cut from its whole value)."""
    return Tensor._wrap(_piece(dist_tensor)[0])


def _whole(t):
    """The whole value of dist tensor ``t`` on every rank (``Partial``
    axes all-reduced, ``Shard`` axes all-gathered; every rank calls)."""
    if getattr(t, "_dist_whole", False):
        return unwrap(t).detach()
    import torch.distributed as dist
    local, placements = _piece(t)
    mesh = t.process_mesh
    port = mesh.to_mesh()
    local = local.clone()
    for a in _partial_axes(placements, mesh):
        if port.degree(a) > 1:
            dist.all_reduce(local, group=port.group(a))
    return gather_shard(local, _spec_with_names(placements, mesh,
                                                local.dim()), port)


def reshard(dist_tensor, mesh, placements):
    """reference: api.py:579.  The piece of ``dist_tensor``'s whole value
    under ``placements`` of ``mesh`` (module docstring; every rank
    calls)."""
    whole = _whole(dist_tensor)
    try:
        local = _local_of(whole, placements, mesh)
    except (RuntimeError, ValueError) as e:
        raise ValueError(
            f"reshard: cannot move shape {tuple(whole.shape)} to "
            f"placements {placements} on mesh "
            f"{dict(zip(mesh.dim_names, mesh.shape))}: {e}") from e
    t = Tensor._wrap(local)
    t.stop_gradient = getattr(dist_tensor, "stop_gradient", True)
    return _annotate(t, mesh, placements, whole=False)


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """reference: api.py:678.  ``shard_fn(name, sublayer, mesh)`` places
    the parameters; without one every parameter is replicated."""
    if shard_fn is not None:
        for name, sub in layer.named_sublayers(include_self=True):
            shard_fn(name, sub, process_mesh)
    else:
        for _, p in layer.named_parameters():
            shard_tensor(p, process_mesh,
                         [Replicate()] * process_mesh.ndim)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda l, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda l, inp, out: output_fn(out, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """reference: api.py shard_optimizer: the mesh step splits the
    optimizer state by the parameters' placements; nothing to do here."""
    return optimizer


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None):
    """reference: api.py:2345.  With ``loss`` and ``optimizer``: a
    ``DistributedTrainStep`` over the global mesh whose loss is
    ``loss(layer(*inputs), label)`` (the batch's last tensor is the
    label); else the layer's forward without gradients."""
    from ..engine import DistributedEvalStep, DistributedTrainStep
    if loss is not None and optimizer is not None:
        def loss_fn(model, *args):
            out = model(*args[:-1])
            return loss(out, args[-1])
        return DistributedTrainStep(layer, loss_fn, optimizer)
    return DistributedEvalStep(layer)


class DistAttr:
    def __init__(self, mesh=None, sharding_specs=None):
        self.process_mesh = mesh
        self.sharding_specs = sharding_specs


def get_mesh_helper():
    return get_mesh()


def set_auto_parallel_mesh(mesh):
    return set_mesh(mesh.to_mesh() if isinstance(mesh, ProcessMesh)
                    else mesh)


__all__ = ["DistAttr", "Partial", "Placement", "ProcessMesh", "Replicate",
           "Shard", "dtensor_from_local", "dtensor_to_local",
           "get_mesh_helper", "reshard", "set_auto_parallel_mesh",
           "shard_layer", "shard_optimizer", "shard_tensor", "to_static"]
