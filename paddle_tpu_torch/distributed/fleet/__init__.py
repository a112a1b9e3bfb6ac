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
model in stages; ``recompute`` is the port's activation recompute.

The parameter-server mode (``distributed.ps``): ``init(role_maker,
is_collective=False)`` takes its role from the role maker
(:class:`PaddleCloudRoleMaker` reads ``TRAINING_ROLE``,
``PADDLE_PSERVERS_IP_PORT_LIST``, ``PADDLE_PORT`` and
``PADDLE_TRAINER_ID``).  A server process gets no process group and no
mesh: it never touches the card; then ``init_server()`` and
``run_server()``.  A worker process builds the collective mesh as
collective mode does, then ``init_worker(endpoints)`` connects it to
the servers and ``stop_worker()`` stops them.
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

def init(role_maker=None, is_collective=False, strategy=None,
         log_level="INFO"):
    """reference: fleet/fleet.py:167.  In the parameter-server mode
    (``is_collective=False``, or a role maker given) the role maker's
    role is this process's ``distributed.ps`` role; a server returns
    None without a process group or a mesh.  Otherwise (and for a
    worker) the process group starts when none is running and the
    global mesh comes from ``strategy.hybrid_configs`` (all ranks on
    ``dp`` when no degree is given)."""
    if role_maker is not None or not is_collective:
        rm = role_maker or PaddleCloudRoleMaker(is_collective=False)
        if not rm._is_collective:
            from .. import ps
            ps._CTX.role_maker = rm._ps
            if rm.is_server():
                _FLEET.update(initialized=True, strategy=strategy,
                              hcg=None)
                return None
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


class Role:
    """reference: fleet/base/role_maker.py Role."""

    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class PaddleCloudRoleMaker:
    """reference: fleet/base/role_maker.py PaddleCloudRoleMaker.  The
    collective role maker answers from the process group; the
    parameter-server one (``is_collective=False``) from the
    environment, as ``distributed.ps.PSRoleMaker``: ``TRAINING_ROLE``
    (``PSERVER`` or ``TRAINER``), ``PADDLE_PSERVERS_IP_PORT_LIST``,
    ``PADDLE_PORT``, ``PADDLE_TRAINER_ID``.  (The JAX package's answers
    ``is_server()`` False whatever the environment says: ROADMAP.md C.)"""

    def __init__(self, is_collective=False, **kwargs):
        from ..ps import PSRoleMaker
        self._is_collective = is_collective
        self._ps = PSRoleMaker(kwargs.get("role"), kwargs.get("endpoints"),
                               kwargs.get("worker_id", 0))

    def worker_num(self):
        return get_world_size()

    def worker_index(self):
        return (get_rank() if self._is_collective
                else self._ps.worker_id)

    def is_worker(self):
        return self._is_collective or self._ps.is_worker()

    def is_server(self):
        return not self._is_collective and self._ps.is_server()

    def get_pserver_endpoints(self):
        return list(self._ps.endpoints)


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """reference: role_maker.py UserDefinedRoleMaker: the role given,
    not read (``role=Role.SERVER`` or ``Role.WORKER``,
    ``server_endpoints``, ``current_id``)."""

    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        role = kwargs.get("role", Role.WORKER)
        super().__init__(
            is_collective=is_collective,
            role="pserver" if role == Role.SERVER else "trainer",
            endpoints=kwargs.get("server_endpoints"),
            worker_id=kwargs.get("current_id", 0))


# -- the parameter-server mode ----------------------------------------------
# reference: fleet/fleet.py init_server():937 / run_server():1038 /
# init_worker(), over the host-memory PS stack of distributed/ps/.
def is_server():
    from .. import ps
    return ps.is_server()


def is_worker():
    from .. import ps
    return ps.is_worker()


def init_server(*args, **kwargs):
    from .. import ps
    return ps.init_server(*args, **kwargs)


def run_server():
    from .. import ps
    return ps.run_server()


def init_worker(endpoints=None):
    from .. import ps
    return ps.init_worker(endpoints)


def stop_worker():
    from .. import ps
    return ps.stop_worker()


def _collective_device():
    """Where the default process group's collectives take their tensors:
    this rank's card under NCCL (which refuses host tensors), else the
    host."""
    import torch
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class UtilBase:
    """reference: fleet/base/util_factory.py: small cross-worker
    utilities over the collectives."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np
        import torch
        arr = np.asarray(input)
        if mode not in ("sum", "max", "min"):
            raise ValueError(f"all_reduce mode {mode!r}: sum/max/min")
        if get_world_size() <= 1:
            return arr
        from ..communication import ReduceOp, all_reduce as _ar
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(
            _collective_device())
        _ar(t, op={"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
                   "min": ReduceOp.MIN}[mode])
        return t.cpu().numpy()

    def barrier(self, comm_world="worker"):
        from ..communication import barrier
        barrier()

    def get_file_shard(self, files):
        n, r = get_world_size(), get_rank()
        return [f for i, f in enumerate(files) if i % n == r]

    def print_on_rank(self, message, rank_id=0):
        if get_rank() == rank_id:
            print(message)


class Fleet:
    """The fleet singleton's type (reference: fleet/fleet.py Fleet): the
    module's functions, object-style."""

    def __init__(self):
        self.util = UtilBase()

    def __getattr__(self, item):
        import sys
        mod = sys.modules[__name__]
        if hasattr(mod, item):
            return getattr(mod, item)
        raise AttributeError(item)


class MultiSlotDataGenerator:
    """The parameter-server data generator's multi-slot text protocol
    (reference: fleet/data_generator/data_generator.py): a sample is
    ``[(slot_name, [ints]), ...]``, written as ``count id id ...`` a
    slot."""

    def _gen_str(self, line):
        parts = []
        for name, values in line:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts) + "\n"

    def generate_sample(self, line):
        raise NotImplementedError("override generate_sample")

    def run_from_stdin(self):
        import sys
        for line in sys.stdin:
            for sample in self.generate_sample(line)():
                sys.stdout.write(self._gen_str(sample))

    def run_from_memory(self, lines):
        out = []
        for line in lines:
            for sample in self.generate_sample(line)():
                out.append(self._gen_str(sample))
        return out


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """String-valued slots (reference: data_generator.py)."""


__all__ = ["ColumnParallelLinear", "ColumnSequenceParallelLinear",
           "CommunicateTopology", "DistributedStrategy", "Fleet",
           "GatherOp", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator", "Role", "UtilBase",
           "init_server", "init_worker", "is_server", "is_worker",
           "run_server", "stop_worker",
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
