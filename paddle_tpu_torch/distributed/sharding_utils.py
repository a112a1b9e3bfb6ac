"""Partition specs and the rules that pick them (port of
``paddle_tpu/distributed/sharding_utils.py``).

The JAX package records a ``jax.sharding.PartitionSpec`` on each weight
and lets GSPMD place it.  The port keeps the spec as its own small
:class:`P` (a tuple of mesh-axis names, tuples of names, or None per
dimension) so the rules read as in the reference, and uses it to cut
**plain local shards**: :func:`local_shard` takes this rank's piece of
a full tensor, :func:`gather_shard` puts the full tensor back together.
A ``mesh`` argument here is the port's :class:`~.env.Mesh` or anything
with a ``shape`` mapping of axis degrees (a dict works too).
"""

from __future__ import annotations

import itertools
import re
import warnings

import torch

from .env import get_mesh


class P(tuple):
    """A partition spec: entry ``i`` names the mesh axis (or axes) that
    dimension ``i`` is split over, or None; missing trailing entries are
    None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def _shape_of(mesh):
    return mesh if isinstance(mesh, dict) else mesh.shape


def _axes_of(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_extent(mesh, entry):
    """Product of the degrees of one spec entry's axes."""
    shape = _shape_of(mesh)
    n = 1
    for a in _axes_of(entry):
        n *= shape[a]
    return n


def annotate_param(param, spec):
    """Record ``spec`` as the parameter's ``placements`` (the mesh train
    step reads it: a parameter the model holds whole gets it as its
    storage sharding); returns ``param``."""
    from ..core.tensor import unwrap
    unwrap(param).placements = spec
    return param


def shard_constraint(x, spec):
    """A no-op: the port holds local shards, so there is no layout to
    constrain (the JAX version drops a ``with_sharding_constraint``)."""
    return x


def param_sharding(param, mesh=None):
    """The spec of ``param`` on ``mesh`` (default: the global mesh),
    replicated when it has none; None without a mesh."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return None
    from ..core.tensor import unwrap
    spec = getattr(unwrap(param), "placements", None)
    return spec if spec is not None else P()


def validate_spec(spec, shape, mesh, name="<leaf>", quiet=False,
                  on_fallback=None):
    """``spec`` when every axis it names is on ``mesh`` and every split
    dimension of ``shape`` divides by its extent; otherwise warn (unless
    ``quiet``), call ``on_fallback(message)`` and return ``P()``
    (replicated), so one rule set serves several mesh shapes."""
    def fallback(msg):
        if not quiet:
            warnings.warn("infer_partition_specs: " + msg, RuntimeWarning,
                          stacklevel=4)
        if on_fallback is not None:
            on_fallback(msg)
        return P()

    if spec is None:
        return P()
    spec = spec if isinstance(spec, P) else P(*spec)
    mshape = _shape_of(mesh)
    if len(spec) > len(shape):
        return fallback(f"spec {spec} for {name!r} has more entries than "
                        f"array rank {len(shape)}; using replicated")
    for dim, entry in enumerate(spec):
        names = _axes_of(entry)
        if not names:
            continue
        missing = [a for a in names if a not in mshape]
        if missing:
            return fallback(f"{name!r} spec {spec} names mesh axes "
                            f"{missing} not in mesh {dict(mshape)}; using "
                            "replicated")
        div = mesh_extent(mshape, entry)
        if shape[dim] % div != 0:
            return fallback(f"{name!r} dim {dim} of size {shape[dim]} not "
                            f"divisible by mesh extent {div} for spec "
                            f"{spec}; using replicated")
    return spec


def _rebuild(tree, fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def infer_partition_specs(pytree, mesh, rules, default=P(),
                          on_fallback=None):
    """A spec for every array leaf of ``pytree`` (nested dicts, lists,
    tuples) from ``rules``, ordered ``(regex, spec)`` pairs: the first
    pattern that ``re.search``-matches the leaf's ``/``-joined path wins
    and is checked by :func:`validate_spec`; unmatched leaves (and
    leaves without a shape) get ``default`` (``None`` tells a caller
    that layers another source that no rule matched).  Returns a tree of
    the same structure."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def leaf_spec(path, leaf):
        shape = getattr(leaf, "shape", None)
        if shape is None:
            return default
        pstr = "/".join(path)
        for pat, spec in compiled:
            if pat.search(pstr):
                return validate_spec(spec, tuple(shape), mesh, name=pstr,
                                     on_fallback=on_fallback)
        return default

    return _rebuild(pytree, leaf_spec)


def _fused_view(x, dim, fused):
    """``x`` with dimension ``dim`` viewed as ``[fused, size / fused]``."""
    shape = list(x.shape)
    return x.reshape(shape[:dim] + [fused, shape[dim] // fused]
                     + shape[dim + 1:])


def local_shard(x, spec, mesh, fused=1):
    """This rank's piece of the full tensor ``x`` under ``spec``: each
    split dimension cut into ``extent`` contiguous chunks, chunk
    ``mesh.index(axes)`` kept.  ``fused=k`` treats the last split
    dimension as ``k`` equal parts laid end to end (GPT's ``[q | k | v]``
    columns) and keeps this rank's chunk of each part.  A contiguous
    copy (a replicated spec returns ``x`` itself)."""
    split = [(d, e) for d, e in enumerate(spec or ()) if _axes_of(e)]
    if not split:
        return x
    out = x
    for i, (dim, entry) in enumerate(split):
        n = mesh_extent(mesh, entry)
        k = fused if i == len(split) - 1 else 1
        v = _fused_view(out, dim, k)
        size = v.shape[dim + 1] // n
        v = v.narrow(dim + 1, mesh.index(_axes_of(entry)) * size, size)
        out = v.reshape(list(out.shape[:dim]) + [k * size]
                        + list(out.shape[dim + 1:]))
    return out.contiguous().clone()


def gather_shard(x, spec, mesh, fused=1):
    """The full tensor from every rank's ``x`` under ``spec`` (the
    inverse of :func:`local_shard`: an all-gather over each split
    dimension's group; every member calls)."""
    import torch.distributed as dist
    split = [(d, e) for d, e in enumerate(spec or ()) if _axes_of(e)]
    for i, (dim, entry) in enumerate(reversed(split)):
        n = mesh_extent(mesh, entry)
        k = fused if i == 0 else 1
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(),
                        group=mesh.group(_axes_of(entry)))
        x = torch.cat([_fused_view(p, dim, k) for p in parts], dim + 1)
        x = x.reshape(list(x.shape[:dim]) + [-1] + list(x.shape[dim + 2:]))
    return x


def _runs(rows):
    """``[(start, length)]`` of the contiguous runs of the row indices
    ``rows``, in their order."""
    out = []
    for r in rows:
        if out and out[-1][0] + out[-1][1] == r:
            out[-1] = (out[-1][0], out[-1][1] + 1)
        else:
            out.append((int(r), 1))
    return out


def _pieces(global_shape, spec, mesh, fused=1, rows=None):
    """Per dimension, the ``[(global start, length)]`` pieces this rank
    holds, in the order its local tensor lays them end to end (the
    arithmetic of :func:`local_shard`); ``rows`` (a pipeline stage's
    layer indices) replace dimension 0's."""
    spec = tuple(spec or ())
    split = [d for d, e in enumerate(spec) if _axes_of(e)]
    out = []
    for d, size in enumerate(global_shape):
        entry = spec[d] if d < len(spec) else None
        if d == 0 and rows is not None:
            out.append(_runs(rows))
            continue
        if not _axes_of(entry):
            out.append([(0, int(size))])
            continue
        n = mesh_extent(mesh, entry)
        k = fused if d == split[-1] else 1
        part = size // k
        chunk = part // n
        i = mesh.index(_axes_of(entry)) if n > 1 else 0
        pieces = []
        for j in range(k):
            start = j * part + i * chunk
            if pieces and pieces[-1][0] + pieces[-1][1] == start:
                pieces[-1] = (pieces[-1][0], pieces[-1][1] + chunk)
            else:
                pieces.append((start, chunk))
        out.append(pieces)
    return out


def global_shape(local_shape, spec, mesh):
    """The shape of the whole tensor whose piece of shape ``local_shape``
    a rank holds under ``spec``: each split dimension times its extent."""
    spec = tuple(spec or ())
    return tuple(int(n) * (mesh_extent(mesh, spec[d]) if d < len(spec)
                           else 1) for d, n in enumerate(local_shape))


def shard_boxes(global_shape, spec, mesh, fused=1, rows=None):
    """This rank's boxes of a tensor of ``global_shape`` under ``spec``
    (the inverse arithmetic of :func:`local_shard`): ``[(offset, shape,
    local_offset)]``, the box's corner in the whole tensor, its shape,
    and its corner in the rank's local tensor.  ``fused=k`` (GPT's
    ``[q | k | v]`` columns) makes the last split dimension ``k`` boxes,
    one a part; ``rows`` (a pipeline stage's layer indices, several runs
    under the interleaved schedule) make dimension 0 one box a run of
    contiguous rows.  Boxes that touch in both the whole and the local
    tensor are one box."""
    per_dim = []
    for pieces in _pieces(global_shape, spec, mesh, fused, rows):
        local, at = [], 0
        for start, n in pieces:
            local.append((start, n, at))
            at += n
        per_dim.append(local)
    return [(tuple(p[0] for p in combo), tuple(p[1] for p in combo),
             tuple(p[2] for p in combo))
            for combo in itertools.product(*per_dim)]


def writes_shard(spec, mesh):
    """Whether this rank writes its boxes of a tensor under ``spec``:
    exactly one rank of the ranks holding the same boxes does, the one
    whose index is 0 on every axis ``spec`` does not split (the JAX
    package's ``replica_id == 0``); with no mesh, this rank."""
    if mesh is None:
        return True
    used = {a for e in (spec or ()) for a in _axes_of(e)}
    return all(i == 0 for a, i in mesh.coord.items() if a not in used)


__all__ = ["P", "annotate_param", "gather_shard", "global_shape",
           "infer_partition_specs", "local_shard", "mesh_extent",
           "param_sharding", "shard_boxes", "shard_constraint",
           "validate_spec", "writes_shard"]
