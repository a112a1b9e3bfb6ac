"""Fleet — the hybrid-parallel user API (port of
``paddle_tpu/distributed/fleet``; reference:
python/paddle/distributed/fleet/fleet.py — init:167,
distributed_optimizer:1326).

``fleet.init(is_collective=True, strategy=...)`` starts the process
group when none is running and builds the global mesh from
``strategy.hybrid_configs`` (all ranks on ``dp`` when no degree is
given); ``get_hybrid_communicate_group()`` answers each rank's place;
``distributed_model`` returns the model (tensor-parallel and
sequence-parallel layers split themselves; at a ``sharding`` degree
above 1 it records the ZeRO specs, ``apply_fsdp_annotations``, that the
mesh train step's storage sharding reads) and ``distributed_optimizer``
wraps the optimizer in ``HybridParallelOptimizer``.  ``PipelineLayer``,
``LayerDesc``, ``SharedLayerDesc`` and ``SegmentLayers`` describe a
model in stages.  The parameter-server role makers raise
(ROADMAP.md A7h); ``recompute`` is the port's activation recompute.
"""

from __future__ import annotations

from ..env import (build_mesh, get_rank, get_world_size,
                   init_parallel_env, reset_parallel_env)
from . import mp_layers as meta_parallel_mp  # noqa: F401
from .distributed_strategy import DistributedStrategy
from .hybrid_optimizer import (HybridParallelClipGrad,
                               HybridParallelGradScaler,
                               HybridParallelOptimizer)
from .mp_layers import (ColumnParallelLinear, ColumnSequenceParallelLinear,
                        GatherOp, ParallelCrossEntropy, RNGStatesTracker,
                        RowParallelLinear, RowSequenceParallelLinear,
                        ScatterOp, VocabParallelEmbedding,
                        get_rng_state_tracker,
                        mark_as_sequence_parallel_parameter,
                        model_parallel_random_seed)
from .parallel_apply import apply_fsdp_annotations
from .pp_layers import (LayerDesc, PipelineLayer, SegmentLayers,
                        SharedLayerDesc)
from .recompute import recompute
from .topology import CommunicateTopology, HybridCommunicateGroup

_FLEET = {"initialized": False, "strategy": None, "hcg": None}

_PS = ("the parameter-server mode is not ported yet: ROADMAP.md A7h "
       "(launch, spawn, elastic, auto_parallel and ps)")


def init(role_maker=None, is_collective=False, strategy=None,
         log_level="INFO"):
    """reference: fleet/fleet.py:167.  Collective mode only."""
    if role_maker is not None or not is_collective:
        raise NotImplementedError(_PS)
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    degrees = {a: int(hc.get(f"{a}_degree", 1))
               for a in ("dp", "mp", "pp", "sharding", "sep")}
    init_parallel_env()
    if all(v == 1 for v in degrees.values()):
        degrees["dp"] = get_world_size()
    build_mesh(degrees)
    _FLEET.update(initialized=True, strategy=strategy,
                  hcg=HybridCommunicateGroup())
    return _FLEET["hcg"]


def get_hybrid_communicate_group():
    return _FLEET["hcg"]


def _reset():
    """Tear down fleet, the global mesh and the process group."""
    _FLEET.update(initialized=False, strategy=None, hcg=None)
    reset_parallel_env()


def is_initialized():
    return _FLEET["initialized"]


def worker_num():
    return get_world_size()


def worker_index():
    return get_rank()


def is_first_worker():
    return get_rank() == 0


def barrier_worker():
    from ..communication import barrier
    barrier()


def distributed_model(model):
    """reference: fleet/model.py:32.  The model, its tensor-parallel
    layers already holding their shards; at a ``sharding`` degree above
    1 its parameters get the ZeRO annotations of the strategy's
    ``sharding_configs["stage"]`` (1 in the default strategy;
    :func:`parallel_apply.apply_fsdp_annotations`), which the mesh
    train step's storage sharding reads."""
    from ..env import hybrid_degrees
    if hybrid_degrees().get("sharding", 1) > 1:
        strategy = _FLEET["strategy"] or DistributedStrategy()
        stage = strategy.hybrid_configs.get("sharding_configs", {}).get(
            "stage", 3)
        apply_fsdp_annotations(model, stage=stage)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """reference: fleet/fleet.py:1326 -> HybridParallelOptimizer."""
    return HybridParallelOptimizer(optimizer, _FLEET["hcg"],
                                   strategy or _FLEET["strategy"]
                                   or DistributedStrategy())


def distributed_scaler(scaler):
    return HybridParallelGradScaler(scaler, _FLEET["hcg"])


class PaddleCloudRoleMaker:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_PS)


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    pass


__all__ = ["ColumnParallelLinear", "ColumnSequenceParallelLinear",
           "CommunicateTopology", "DistributedStrategy", "GatherOp",
           "HybridCommunicateGroup", "HybridParallelClipGrad",
           "HybridParallelGradScaler", "HybridParallelOptimizer",
           "LayerDesc", "PaddleCloudRoleMaker", "ParallelCrossEntropy",
           "PipelineLayer", "RNGStatesTracker", "RowParallelLinear",
           "RowSequenceParallelLinear", "ScatterOp", "SegmentLayers",
           "SharedLayerDesc", "UserDefinedRoleMaker",
           "VocabParallelEmbedding", "apply_fsdp_annotations",
           "barrier_worker", "distributed_model", "distributed_optimizer",
           "distributed_scaler", "get_hybrid_communicate_group",
           "get_rng_state_tracker", "init", "init_parallel_env",
           "is_first_worker", "is_initialized",
           "mark_as_sequence_parallel_parameter", "model_parallel_random_seed",
           "recompute", "worker_index", "worker_num"]
