"""ZeRO (sharding stage 1/2/3) parameter annotations (port of
``paddle_tpu/distributed/fleet/parallel_apply.py``; reference:
DygraphShardingOptimizer, GroupSharded stages).

The JAX package records specs that GSPMD places: stages 1/2 keep the
parameters replicated and shard their optimizer state over
``sharding`` (``_opt_state_spec``), stage 3 shards the parameters
themselves.  The port records the same specs; ``jit.mesh.MeshPlan``
reads them as its storage sharding: the optimizer state and fp32 master
hold this rank's slice, the gradient arrives reduce-scattered and the
parameter is all-gathered after the update.  The port's forward always
sees the parameters whole, so stage 3 trains as stages 1/2 do."""

from __future__ import annotations

import numpy as np

from ...core.tensor import unwrap
from ..env import hybrid_degrees
from ..sharding_utils import P, annotate_param


def _fsdp_spec(shape, degree):
    """Shard the largest dim divisible by the sharding degree."""
    for dim in np.argsort(shape)[::-1]:
        if shape[int(dim)] % degree == 0 and shape[int(dim)] >= degree:
            spec = [None] * len(shape)
            spec[int(dim)] = "sharding"
            return P(*spec)
    return P()


def apply_fsdp_annotations(model, stage=3, min_size=1024):
    """Annotate the parameters per the ZeRO ``stage``: below
    ``min_size`` elements replicated; stage 1/2 the spec as
    ``_opt_state_spec`` beside a replicated placement, stage 3 as the
    placement.  Parameters already split (tensor parallel) are left as
    they are.  A no-op at a ``sharding`` degree of 1."""
    degree = hybrid_degrees().get("sharding", 1)
    if degree <= 1:
        return model
    for _, p in model.named_parameters():
        t = unwrap(p)
        placed = getattr(t, "placements", None)
        if placed is not None and placed != P():
            continue        # already split: tensor parallel
        shape = tuple(t.shape)
        if int(np.prod(shape or [1])) < min_size:
            annotate_param(t, P())
            continue
        spec = _fsdp_spec(shape, degree)
        if stage >= 3:
            annotate_param(t, spec)
        else:
            annotate_param(t, P())
            t._opt_state_spec = spec
    return model


__all__ = ["apply_fsdp_annotations"]
