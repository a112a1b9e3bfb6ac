"""``paddle.distributed`` of the port (port of
``paddle_tpu/distributed``).

One process a rank over ``torch.distributed``: the parallel environment
and the device mesh (``env``: ``init_parallel_env``, ``build_mesh``),
the eager collectives (``communication``), partition specs and their
rules (``sharding_utils``), Megatron's tensor-parallel primitives
(``mp_ops``), ``fleet`` (``init``, the hybrid communicate group, the
tensor-parallel layers, the hybrid optimizer, ``recompute``),
``DataParallel``, and the one-process ``checkpoint``.  Expert
parallelism (MoE experts split over ``dp``, their token all-to-all) is
``incubate.moe``'s, run by the MoE GPT and ``jit.mesh``.  Sequence and
context parallelism over ``sep`` (the sequence split of
``env.sequence_split``, ``communication.ring_shift`` under
``kernels.ring_attention``) run in the GPT and ``jit.mesh``; Megatron's
sequence-parallel linears are ``fleet``'s.  Pipeline parallelism over
``pp`` (``pipeline``: GPipe, interleaved, 1F1B and zero-bubble) runs in
the GPT, ``jit.mesh`` and ``engine``'s ``DistributedTrainStep``,
``Pipeline1F1BTrainStep`` and ``DistributedEvalStep`` (imported on first
use: ``engine`` builds on ``jit``); ``fleet.PipelineLayer`` describes a
model in stages.  Multi-process checkpoints and the launchers are
ROADMAP.md A7g–A7h.
"""

from . import checkpoint, fleet, pipeline
from .checkpoint import (CheckpointCorrupt, load_state_dict,
                         save_state_dict, wait_async_save)
from .communication import (Group, P2POp, ReduceOp, all_gather,
                            all_gather_object, all_reduce, all_to_all,
                            axis_group, barrier, batch_isend_irecv,
                            broadcast, get_group, irecv, isend, new_group,
                            recv, reduce, reduce_scatter, ring_shift,
                            scatter, send, stream)
from .env import (AXIS_ORDER, Mesh, ParallelEnv, build_mesh, data_axes,
                  get_mesh, get_rank, get_world_size, hybrid_degrees,
                  init_parallel_env, is_initialized, reset_parallel_env,
                  sequence_split, set_mesh)
from .parallel import DataParallel, fused_allreduce_gradients
from .sharding_utils import P


_ENGINE = ("DistributedEvalStep", "DistributedTrainStep",
           "Pipeline1F1BTrainStep")


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_backend():
    import torch.distributed as dist
    return dist.get_backend() if dist.is_initialized() else None


__all__ = ["AXIS_ORDER", "CheckpointCorrupt", "DataParallel",
           "DistributedEvalStep", "DistributedTrainStep", "Group",
           "Mesh", "P", "P2POp", "ParallelEnv", "Pipeline1F1BTrainStep",
           "ReduceOp", "all_gather",
           "all_gather_object", "all_reduce", "all_to_all", "axis_group",
           "barrier", "batch_isend_irecv", "broadcast", "build_mesh",
           "checkpoint", "data_axes", "fleet", "fused_allreduce_gradients",
           "get_backend", "get_group", "get_mesh", "get_rank",
           "get_world_size", "hybrid_degrees", "init_parallel_env", "irecv",
           "is_initialized", "isend", "load_state_dict", "new_group",
           "pipeline", "recv", "reduce", "reduce_scatter",
           "reset_parallel_env",
           "ring_shift", "save_state_dict", "scatter", "send",
           "sequence_split", "set_mesh", "stream",
           "wait_async_save"]
