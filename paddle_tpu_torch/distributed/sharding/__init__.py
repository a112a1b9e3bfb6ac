"""Group-sharded (ZeRO) user API (port of
``paddle_tpu/distributed/sharding``; reference:
python/paddle/distributed/sharding/group_sharded.py
group_sharded_parallel).

The stages are specs, not runtime wrappers, as in the JAX package:
``fleet.parallel_apply.apply_fsdp_annotations`` records them on the
parameters and ``jit.mesh.MeshPlan`` reads them as its storage sharding
(the optimizer state and fp32 master hold this rank's slice over
``sharding``)."""

from __future__ import annotations

from ..fleet.parallel_apply import apply_fsdp_annotations


def group_sharded_parallel(model, optimizer, level="p_g_os", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """level: ``'os'`` stage 1, ``'os_g'`` stage 2, ``'p_g_os'`` stage 3."""
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}[level]
    apply_fsdp_annotations(model, stage=stage)
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def save_group_sharded_model(model, output, optimizer=None):
    """reference: group_sharded.py save_group_sharded_model — writes
    ``paddle.save`` files, which the port does not have yet."""
    raise NotImplementedError(
        "save_group_sharded_model needs paddle.save, which is not ported "
        "yet: ROADMAP.md A10; save through distributed.save_state_dict or "
        "resilience.CheckpointManager meanwhile")


__all__ = ["group_sharded_parallel", "save_group_sharded_model"]
