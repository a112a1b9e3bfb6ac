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
model in stages.  ``checkpoint`` saves and restores over every mesh.

Starting and keeping a job alive: ``launch`` (``python -m
paddle_tpu_torch.distributed.launch``: one process a rank, each given
its rank, the rendezvous and its card) and :func:`spawn` (the same from
Python); ``elastic`` (``--elastic``: an agent that relaunches the whole
world when a rank process dies or its heartbeat goes stale, the world
resuming from its checkpoint, shrunk when the same rank keeps failing).
The auto-parallel API (``auto_parallel``: ``ProcessMesh``, placements,
``shard_tensor``, ``reshard``, ``shard_layer``, ``to_static``), the
parallel-config ``auto_tuner``, the parameter-server stack (``ps``, and
``fleet``'s role makers), ``sharding``'s ``group_sharded_parallel``,
``utils``, ``io`` and the rest of Paddle's namespace (``compat``).
"""

import os

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


def _spawned(func, args, env):
    os.environ.update(env)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """reference: distributed/spawn.py: ``nprocs`` processes (-1: one)
    each running ``func(*args)``, started with ``multiprocessing``'s
    spawn method; returns them (joined when ``join``).  Each child gets
    the launcher's variables, as the reference's spawn gives them:
    ``PADDLE_TRAINER_ID`` (its index), ``PADDLE_TRAINERS_NUM``,
    ``PADDLE_MASTER`` (one free local port for all) and
    ``PADDLE_LOCAL_RANK``, so ``init_parallel_env()`` in ``func`` joins
    one group.  (The JAX package's spawn sets none: ROADMAP.md C.)"""
    import multiprocessing as mp
    from .launch.main import _free_port
    if nprocs == -1:
        nprocs = 1
    master = f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_MASTER": master, "PADDLE_LOCAL_RANK": str(rank)}
        p = ctx.Process(target=_spawned, args=(func, tuple(args), env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
    return procs


from . import (auto_parallel, auto_tuner, elastic, io, launch,  # noqa: E402
               ps, sharding, utils)
from .auto_parallel import (DistAttr, Partial, Placement,  # noqa: E402
                            ProcessMesh, Replicate, Shard,
                            dtensor_from_local, dtensor_to_local, reshard,
                            shard_layer, shard_optimizer, shard_tensor,
                            to_static)
from .compat import (CountFilterEntry, DistModel,  # noqa: E402
                     InMemoryDataset, ParallelMode, ProbabilityEntry,
                     QueueDataset, ReduceType, ShardingStage1,
                     ShardingStage2, ShardingStage3, ShowClickEntry,
                     Strategy, alltoall, alltoall_single,
                     broadcast_object_list, destroy_process_group,
                     dtensor_from_fn, gather, gloo_barrier,
                     gloo_init_parallel_env, gloo_release, is_available,
                     scatter_object_list, shard_dataloader, shard_scaler,
                     split, unshard_dtensor, wait)
from .sharding import (group_sharded_parallel,  # noqa: E402
                       save_group_sharded_model)


__all__ = ["AXIS_ORDER", "CheckpointCorrupt", "CountFilterEntry",
           "DataParallel", "DistAttr", "DistModel",
           "DistributedEvalStep", "DistributedTrainStep", "Group",
           "InMemoryDataset", "Mesh", "P", "P2POp", "ParallelEnv",
           "ParallelMode", "Partial", "Pipeline1F1BTrainStep", "Placement",
           "ProbabilityEntry", "ProcessMesh", "QueueDataset", "ReduceOp",
           "ReduceType", "Replicate", "Shard", "ShardingStage1",
           "ShardingStage2", "ShardingStage3", "ShowClickEntry", "Strategy",
           "all_gather", "all_gather_object", "all_reduce", "all_to_all",
           "alltoall", "alltoall_single", "auto_parallel", "auto_tuner",
           "axis_group", "barrier", "batch_isend_irecv", "broadcast",
           "broadcast_object_list", "build_mesh", "checkpoint",
           "data_axes", "destroy_process_group", "dtensor_from_fn",
           "dtensor_from_local", "dtensor_to_local", "elastic", "fleet",
           "fused_allreduce_gradients", "gather", "get_backend",
           "get_group", "get_mesh", "get_rank", "get_world_size",
           "gloo_barrier", "gloo_init_parallel_env", "gloo_release",
           "group_sharded_parallel", "hybrid_degrees", "init_parallel_env",
           "io", "irecv", "is_available", "is_initialized", "isend",
           "launch", "load_state_dict", "new_group", "pipeline", "ps",
           "recv", "reduce", "reduce_scatter", "reset_parallel_env",
           "reshard", "ring_shift", "save_group_sharded_model",
           "save_state_dict", "scatter", "scatter_object_list", "send",
           "sequence_split", "set_mesh", "shard_dataloader", "shard_layer",
           "shard_optimizer", "shard_scaler", "shard_tensor", "sharding",
           "spawn", "split", "stream", "to_static", "unshard_dtensor",
           "utils", "wait", "wait_async_save"]
