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


__all__ = ["P", "annotate_param", "gather_shard", "infer_partition_specs",
           "local_shard", "mesh_extent", "param_sharding", "shard_constraint",
           "validate_spec"]
