"""The hybrid-parallel steps (port of ``paddle_tpu/distributed/engine.py``).

The JAX package compiles forward, backward and the update into one
GSPMD program over the global mesh.  The port's mesh step is
``jit.CompiledTrainStep(mesh=...)`` (``jit/mesh.py``: one process a rank,
the collectives issued by the host), and these are its Paddle-named
entry points:

* :class:`DistributedTrainStep` — the mesh step over the global mesh
  (``distributed.build_mesh`` / ``fleet.init``), the GPT's pipeline
  included: a GPT built under a mesh with ``pp > 1`` runs GPipe or the
  interleaved schedule inside its forward;
* :class:`Pipeline1F1BTrainStep` — the same step with the loss inside
  the last stage: ``model.pipeline_parts()`` through
  ``pipeline.pipeline_value_and_grad`` (1F1B or zero-bubble), the
  gradients set on the parameters, then the optimizer's update;
* :class:`DistributedEvalStep` — a forward without gradients.
"""

from __future__ import annotations

import torch

from ..jit import CompiledTrainStep
from .env import get_mesh
from .pipeline import pipeline_value_and_grad
from .sharding_utils import _axes_of


def _batch_axes(batch_spec):
    """The axes ``batch_spec`` splits the rows over (its first entry),
    or None for the mesh step's default (the data axes)."""
    if batch_spec is None or not len(batch_spec):
        return None
    return _axes_of(batch_spec[0]) or None


class DistributedTrainStep(CompiledTrainStep):
    """``loss_fn(model, *batch)``, its backward and the optimizer update
    as one step on ``mesh`` (default: the global mesh): each rank takes
    its rows of the batch (``batch_spec``'s first entry names the axes
    they split over, default the data axes), the gradients meet as
    ``jit.mesh.MeshPlan`` says.  ``scaler``: an ``amp.GradScaler``.  One
    step a call (``fused_steps=1``)."""

    def __init__(self, model, loss_fn, optimizer, mesh=None, donate=True,
                 batch_spec=None, scaler=None):
        mesh = mesh or get_mesh()
        if mesh is None:
            raise RuntimeError("DistributedTrainStep: build a mesh first "
                               "(distributed.build_mesh or fleet.init)")
        super().__init__(model, loss_fn, optimizer, scaler=scaler,
                         donate=donate, fused_steps=1, mesh=mesh,
                         batch_axes=_batch_axes(batch_spec))


class Pipeline1F1BTrainStep(DistributedTrainStep):
    """A train step whose loss lives inside the pipeline's last stage:
    ``model.pipeline_parts()`` (the GPT's, built under the mesh) through
    ``pipeline_value_and_grad`` with ``schedule`` ``"1f1b"`` or
    ``"zero_bubble"``, ``M = num_microbatches`` (default ``2 * pp``)
    lowered until it divides this rank's rows.  The loss is the summed
    cross entropy over the tokens; each parameter's gradient is set to
    its summed gradient over the tokens, then the update runs as the
    mesh step's (gradients averaged over the data axes, the clip, the
    optimizer).  With ``mp > 1`` the stages are the manual
    tensor-parallel bodies (``pipeline_parts(tp_axis="mp")``).  An MoE
    model's aux enters the objective as ``moe_aux_weight`` times its
    mean over the microbatches."""

    def __init__(self, model, optimizer, num_microbatches=None, mesh=None,
                 donate=True, batch_spec=None, schedule="1f1b"):
        if schedule not in ("1f1b", "zero_bubble"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        mesh = mesh or get_mesh()
        if mesh is not None and mesh.shape.get("sep", 1) > 1:
            raise NotImplementedError(
                "Pipeline1F1BTrainStep does not compose with sep > 1 yet: "
                "ROADMAP.md A7e-sep (pipeline parallelism with the "
                "sequence split); until it lands no pipeline schedule "
                "trains on a mesh with pp > 1 and sep > 1, so train long "
                "sequences over sep without pp")
        super().__init__(model, None, optimizer, mesh=mesh, donate=donate,
                         batch_spec=batch_spec)
        # the schedule sums the embedding's and the head's gradients over
        # pp itself
        self._mesh.sum_pp = False
        self.num_microbatches = num_microbatches
        self.schedule = schedule

    def _loss_and_grads(self, args):
        ids, labels = args
        mesh = self._mesh.mesh
        pp = mesh.degree("pp")
        tp_axis = "mp" if mesh.degree("mp") > 1 else None
        M = self.num_microbatches or max(2 * pp, 1)
        while M > 1 and ids.shape[0] % M:
            M -= 1
        first_fn, mid_fn, last_fn, sp, ex, _, _, _ = \
            self.model.pipeline_parts(tp_axis=tp_axis)
        ntok = ids.numel()
        aux_scale = (ntok / M if getattr(mid_fn, "aux_aware", False)
                     else None)
        loss_sum, dsp, dex = pipeline_value_and_grad(
            first_fn, mid_fn, last_fn, sp, ex, ids, labels, M, mesh=mesh,
            schedule=self.schedule, aux_scale=aux_scale)
        for params, grads in ((sp, dsp), (ex, dex)):
            for k, p in params.items():
                p.grad = (grads[k].float() / ntok).to(p.dtype)
        return loss_sum / ntok


class DistributedEvalStep:
    """``fn(model, *args)`` (default ``model(*args)``) without gradients.
    Every rank runs the whole batch (a pipelined GPT's stages need every
    rank's call) and returns the whole output; the model's own
    placements say where its pieces live."""

    def __init__(self, model, fn=None):
        self.model, self.fn = model, fn

    def __call__(self, *args):
        with torch.no_grad():
            return (self.fn(self.model, *args) if self.fn is not None
                    else self.model(*args))


__all__ = ["DistributedEvalStep", "DistributedTrainStep",
           "Pipeline1F1BTrainStep"]
