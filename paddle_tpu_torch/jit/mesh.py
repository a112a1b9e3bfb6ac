"""The mesh side of ``CompiledTrainStep(mesh=...)``: which rows of the
batch a rank takes, and how the gradients, the optimizer state and the
parameters meet across ranks (the port of the JAX step's mesh plumbing,
``paddle_tpu/jit/__init__.py`` ``_init_mesh`` and the GSPMD collectives
it leaves to XLA).

* **batch** — every batch tensor of the step is split on its row axis
  over the data axes ``batch_axes`` (default: ``dp`` and ``sharding``
  where their degree is above 1, else ``dp``); a batch whose tensors do
  not all divide stays whole on every rank (replicated), as the JAX
  step leaves an indivisible leaf unconstrained.
* **sequence** — with ``sep > 1`` every batch tensor of two or more
  dimensions is also cut along its sequence (dimension 1) into ``sep``
  chunks, chunk r to member r (the JAX step's batch spec ``P(dp,
  sep)``); the step runs its forward under
  ``distributed.env.sequence_split_over``, so the GPT places its chunk
  and attends across the chunks (ring attention, or the sequence
  all-gather).  A sequence that does not divide raises.  Only a model
  that says it handles the split (``handles_sequence_split``, the
  GPT's) trains on such a mesh: any other would attend within its chunk
  and restart its positions at 0, so it is refused.
* **gradients** — summed over the data axes and ``sep`` (the sync axes)
  and divided by their degree ``n``, one all-reduce a parameter; so is
  the loss the step returns.  That is the mean over the global batch
  when every rank's tokens count alike.  A criterion whose counts
  differ across the ranks (a ``loss_mask``: padding lands in the last
  chunk) returns its rank's masked sum times ``n`` over the global
  count, which it all-reduces over ``distributed.env.token_axes``
  itself (the GPT's does): the mean over the ranks is then the global
  masked mean.
* **storage sharding** — a parameter that the model holds whole gets a
  storage spec: the first ``shard_rules`` entry that matches its name,
  else its ``_opt_state_spec`` or ``annotate_param`` placements
  (``fleet.distributed_model``'s ZeRO annotations), else
  ``P("sharding")`` on its
  first axis when the ``sharding`` degree is above 1.  Its optimizer
  state and fp32 master hold only this rank's slice, its gradient
  arrives as that slice (a reduce-scatter over the spec's axes when
  they are data axes, else the all-reduced gradient cut), and after the
  update the slices are all-gathered back into the parameter.
* **tensor parallelism** — parameters the model splits itself
  (``is_distributed`` set to True: the tensor-parallel GPT, ``fleet``'s
  parallel layers; a torch parameter's own ``is_distributed`` is a
  method, which marks nothing) keep their shards; their collectives
  run inside the model.  Their squares are summed over the axes they are split on before the
  global-norm clip, and so are storage slices'.
* **expert parallelism** — a shard split over a data axis (an MoE
  model's expert stacks over ``dp``) holds experts no other rank of
  that axis holds; the reverse all-to-all of its layer has already
  summed every rank's tokens into its gradient, so it is all-reduced
  only over the other data axes before the division by their degree.
  The MoE layers see the tokens as split over the batch axes when the
  step split the batch or a sharded prefetcher handed it this rank's
  rows, over none when it stayed whole (:meth:`MeshPlan.rows` decides;
  the step runs its forward under ``distributed.env.rows_split_over``).
* **pipeline parallelism** — with ``pp > 1`` only a model built under
  the mesh that runs the pipeline schedule trains (``pipeline_stages``:
  the GPT's, whose ranks hold their stages' rows, split over ``pp`` in
  their placements).  A stage's rows are averaged over the sync axes
  as any parameter; a parameter every stage holds whole (the
  embedding, the final norm, the head) is also summed over ``pp``, in
  the same all-reduce, so the first stage's embedding gradient and the
  last stage's head gradient meet once.  The loss is the same on every
  stage and is averaged over the sync axes only; the global-norm clip
  adds a stage's squares over ``pp`` and the whole ones' once.  ``sep``
  and storage sharding do not compose with ``pp`` yet (ROADMAP.md
  A7e-sep).
* **GradScaler** — the overflow flag is the maximum over every rank.
* **checkpoints** — :meth:`MeshPlan.shard` says which part of the whole
  tensor a rank's parameter (or optimizer state) holds, as a
  ``distributed.checkpoint.LocalShard``: a storage-sharded parameter
  is held whole and its state is its storage slice; a model-held shard
  carries the model's spec, its fused ``[q | k | v]`` parts
  (``shard_fused``) and its pipeline rows (``shard_rows``); anything
  else is whole, written by one rank.

A world of one runs the same code: every collective goes over a group
of one.  Each collective ticks ``dist.collective_launches`` (under
CUDA graphs: the captured ones count at each replay).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.checkpoint import LocalShard
from ..distributed.sharding_utils import (P, _axes_of, gather_shard,
                                          infer_partition_specs,
                                          local_shard, validate_spec)
from ..nn.clip import sum_sq
from ..profiler import counters


def _tick(n=1):
    counters.inc("dist.collective_launches", n)


def _view_of(spec, mesh):
    """A function giving this rank's slice of a tensor under ``spec`` as a
    view (``narrow`` along each split dimension)."""
    cuts = [(d, e) for d, e in enumerate(spec) if _axes_of(e)]

    def view(t):
        for d, e in cuts:
            n = mesh.degree(_axes_of(e))
            size = t.shape[d] // n
            t = t.narrow(d, mesh.index(_axes_of(e)) * size, size)
        return t
    return view


class MeshPlan:
    def __init__(self, mesh, model, optimizer, shard_rules=None,
                 batch_axes=None):
        pp = mesh.shape.get("pp", 1)
        if pp > 1 and mesh.shape.get("sep", 1) > 1:
            raise NotImplementedError(
                "CompiledTrainStep on a mesh with pp > 1 and sep > 1 is not "
                "ported yet: ROADMAP.md A7e-sep (pipeline parallelism with "
                "the sequence split)")
        if pp > 1 and getattr(model, "pipeline_stages", None) is None:
            raise NotImplementedError(
                f"CompiledTrainStep on a mesh with pp > 1 trains a model "
                f"built under that mesh that runs the pipeline schedule "
                f"(the GPT's, built after build_mesh); "
                f"{type(model).__name__} would run every layer on every "
                f"stage: ROADMAP.md A7e-models (pipeline parallelism for "
                f"other models)")
        if (mesh.shape.get("sep", 1) > 1
                and not getattr(model, "handles_sequence_split", False)):
            raise NotImplementedError(
                f"CompiledTrainStep on a mesh with sep > 1 trains a model "
                f"that handles the sequence split (handles_sequence_split: "
                f"the GPT's); {type(model).__name__} would attend within "
                f"its chunk only: ROADMAP.md A7c-models (the sequence "
                f"split for other models)")
        self.mesh = mesh
        if batch_axes is None:
            batch_axes = tuple(a for a in ("dp", "sharding")
                               if mesh.shape[a] > 1)
        elif isinstance(batch_axes, str):
            batch_axes = (batch_axes,)
        self.batch_axes = tuple(batch_axes)
        self.data_axes = self.batch_axes or ("dp",)
        #: the axis the sequence is cut over (None at sep 1)
        self.seq_axis = "sep" if mesh.shape.get("sep", 1) > 1 else None
        #: the axes the gradients and the loss are averaged over
        self.sync_axes = self.data_axes + ((self.seq_axis,)
                                           if self.seq_axis else ())
        self.n_sync = mesh.degree(self.sync_axes)
        self.sync_group = mesh.group(self.sync_axes)
        #: with pp > 1: the parameters every stage holds whole (the
        #: embedding, the final norm, the head), whose gradients each stage
        #: holds its part of, so they are summed over pp too; a pipeline
        #: step whose schedule sums them itself sets ``sum_pp`` False
        self.pp_whole, self.sum_pp = set(), True
        self.sync_pp_group = (mesh.group(self.sync_axes + ("pp",))
                              if pp > 1 else None)
        named = list(torch.nn.Module.named_parameters(model))
        ruled = infer_partition_specs({n: p for n, p in named}, mesh,
                                      shard_rules or (), default=None)
        self.storage = {}   # id(p) -> spec of its storage sharding
        self.split = {}     # id(p) -> axes its model-held shard splits on
        self.experts = {}   # id(p) -> data axes its shard splits on
        #: the batch axes this rank's rows of the last call split over
        self.row_axes = ()
        for name, p in named:
            axes = tuple(a for e in getattr(p, "placements", None) or ()
                         for a in _axes_of(e))
            if pp > 1 and "pp" not in axes:
                self.pp_whole.add(id(p))
            if getattr(p, "is_distributed", False) is True:
                if ruled[name] is not None and any(ruled[name]):
                    raise ValueError(
                        f"shard_rules split {name!r}, which the model "
                        "already holds as a tensor-parallel shard")
                if axes and mesh.degree(axes) > 1:
                    self.split[id(p)] = axes
                ep = tuple(a for a in axes if a in self.data_axes
                           and mesh.degree(a) > 1)
                if ep:
                    self.experts[id(p)] = ep
                continue
            spec = ruled[name]
            # ZeRO 1/2 (fleet.apply_fsdp_annotations) records the state's
            # spec beside a replicated placement
            placed = (getattr(p, "_opt_state_spec", None)
                      or getattr(p, "placements", None))
            if spec is None and placed is not None and any(placed):
                spec = validate_spec(placed, p.shape, mesh, name=name)
            if spec is None:
                spec = (validate_spec(P("sharding"), p.shape, mesh,
                                      name=name, quiet=True)
                        if mesh.shape["sharding"] > 1 and p.dim() else P())
            if any(e is not None for e in spec):
                self.storage[id(p)] = spec
        if pp > 1 and self.storage:
            raise NotImplementedError(
                "CompiledTrainStep on a mesh with pp > 1 and storage "
                "sharding (shard_rules, annotated placements or a sharding "
                "degree above 1) is not ported yet: ROADMAP.md A7e-sep")
        self.params = [p for _, p in named]
        self.optimizer = optimizer
        optimizer._shard_views = {pid: _view_of(spec, mesh)
                                  for pid, spec in self.storage.items()}
        optimizer._shard_specs = dict(self.storage)
        optimizer._shard_mesh = mesh

    # -- checkpoints -------------------------------------------------------
    def shard(self, p, t=None, state=False):
        """The :class:`LocalShard` of ``t`` (default ``p``): parameter (or
        buffer) ``p`` itself, or with ``state`` one of its optimizer's
        tensors of ``p``'s per-element layout (a storage slice where its
        state is sharded)."""
        t = p if t is None else t
        spec = self.storage.get(id(p))
        if spec is not None:
            return LocalShard(t, spec, self.mesh, whole=not state)
        if getattr(p, "is_distributed", False) is True:
            return LocalShard(t, P(*p.placements), self.mesh,
                              fused=getattr(p, "shard_fused", 1),
                              rows=getattr(p, "shard_rows", None))
        return LocalShard(t, P(), self.mesh)

    def state_shard(self, p, t):
        """The :class:`LocalShard` of optimizer tensor ``t`` of ``p``: of
        ``p``'s layout when it has the shape of ``p``'s update (a moment,
        a master), whole otherwise (Adam's beta powers)."""
        if tuple(t.shape) == tuple(self.optimizer._view(p).shape):
            return self.shard(p, t, state=True)
        return LocalShard(t, P(), self.mesh)

    # -- batch -------------------------------------------------------------
    def rows(self, args, stacked):
        """This rank's rows of every batch tensor (dimension 1 of a
        window's stacked tensors), or the batch whole when some tensor
        does not divide or already holds this rank's rows; then, with
        ``sep > 1``, this rank's chunk of each sequence."""
        n = self.mesh.degree(self.batch_axes) if self.batch_axes else 1
        d = 1 if stacked else 0
        ts = [a for a in args if isinstance(a, torch.Tensor) and a.dim() > d]
        local = any(getattr(t, "_local_rows", False) for t in ts)
        split = not (n == 1 or not ts or any(t.shape[d] % n for t in ts)
                     or local)
        # (a sharded prefetcher's tensors hold this rank's rows)
        self.row_axes = self.batch_axes if split or local else ()
        if split:
            i = self.mesh.index(self.batch_axes)
            args = tuple(a.narrow(d, i * (a.shape[d] // n), a.shape[d] // n)
                         if isinstance(a, torch.Tensor) and a.dim() > d
                         else a for a in args)
        if self.seq_axis is None:
            return args
        return tuple(self._chunk(a, d + 1)
                     if isinstance(a, torch.Tensor) and a.dim() > d + 1
                     else a for a in args)

    def _chunk(self, a, dim):
        """This rank's chunk of ``a``'s sequence (dimension ``dim``)."""
        n = self.mesh.degree(self.seq_axis)
        if a.shape[dim] % n:
            raise ValueError(
                f"a batch tensor of shape {tuple(a.shape)}: its sequence "
                f"(dimension {dim}, {a.shape[dim]}) does not divide into "
                f"sep={n} equal chunks")
        size = a.shape[dim] // n
        return a.narrow(dim, self.mesh.index(self.seq_axis) * size, size)

    # -- inside the step ---------------------------------------------------
    def mean_loss(self, loss):
        _tick()
        loss = loss.detach().float().clone()
        dist.all_reduce(loss, group=self.sync_group)
        return loss / self.n_sync

    def _reduce_scatter(self, g, spec):
        """This rank's slice of the sync-axes sum of ``g``, when its only
        split is over sync axes: an all-reduce over the other sync axes,
        then a reduce-scatter.  None when the spec is of another kind."""
        cuts = [(d, _axes_of(e)) for d, e in enumerate(spec) if _axes_of(e)]
        if len(cuts) != 1 or not set(cuts[0][1]) <= set(self.sync_axes):
            return None
        dim, axes = cuts[0]
        rest = tuple(a for a in self.sync_axes if a not in axes)
        if rest:
            _tick()
            dist.all_reduce(g, group=self.mesh.group(rest))
        n = self.mesh.degree(axes)
        chunks = [c.contiguous() for c in g.movedim(dim, 0).chunk(n)]
        out = torch.empty_like(chunks[0])
        _tick()
        dist.reduce_scatter(out, chunks, group=self.mesh.group(axes))
        return out.movedim(0, dim)

    def fill_grads(self):
        """With pp > 1: a zero gradient for each parameter every stage
        holds whole that this stage left without one (the head off the
        last stage, the embedding off the first), so every stage joins
        its all-reduce and updates it alike."""
        for p in self.params:
            if p.grad is None and id(p) in self.pp_whole:
                p.grad = torch.zeros_like(p)

    def sync_grads(self):
        """Average every gradient over the sync axes; a storage-sharded
        parameter's lands as its slice in the optimizer's
        ``_shard_grads``.  Returns the gradients the update will read,
        ``{id(p): tensor}``."""
        opt = self.optimizer
        opt._shard_grads = {}
        out = {}
        for p in self.params:
            g = p.grad
            if g is None:
                continue
            spec = self.storage.get(id(p))
            local = None if spec is None else self._reduce_scatter(g, spec)
            ep = self.experts.get(id(p))
            if ep is not None:
                rest = tuple(a for a in self.sync_axes if a not in ep)
                if rest:
                    _tick()
                    dist.all_reduce(g, group=self.mesh.group(rest))
                local = g
            if local is None:
                _tick()
                dist.all_reduce(g, group=(
                    self.sync_pp_group if self.sum_pp
                    and id(p) in self.pp_whole else self.sync_group))
                local = g if spec is None else local_shard(g, spec,
                                                           self.mesh)
            local.div_(self.n_sync)
            if spec is not None:
                opt._shard_grads[id(p)] = local
            out[id(p)] = local
        return out

    def found_inf(self, found):
        """The overflow flag as the maximum over every rank."""
        f = found.to(torch.float32)
        _tick()
        dist.all_reduce(f, op=dist.ReduceOp.MAX)
        return f > 0

    def sum_squares(self, grads):
        """``{id(p): fp32 sum of squares}`` of the full gradients: a
        slice's or a shard's sum added up over the axes it splits on."""
        sq = {}
        for p in self.params:
            g = grads.get(id(p))
            if g is None:
                continue
            s = sum_sq(g)
            spec = self.storage.get(id(p))
            axes = (tuple(a for e in spec for a in _axes_of(e))
                    if spec is not None else self.split.get(id(p)))
            if axes:
                _tick()
                dist.all_reduce(s, group=self.mesh.group(axes))
            sq[id(p)] = s
        return sq

    def gather_params(self):
        """After the update: every storage-sharded parameter rebuilt from
        the ranks' slices."""
        opt = self.optimizer
        opt._shard_grads = {}
        with torch.no_grad():
            for p in self.params:
                spec = self.storage.get(id(p))
                if spec is None:
                    continue
                _tick()
                p.detach().copy_(gather_shard(opt._view(p), spec, self.mesh))


__all__ = ["MeshPlan"]
