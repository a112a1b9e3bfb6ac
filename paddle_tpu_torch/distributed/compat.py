"""The rest of ``paddle.distributed``'s namespace (port of
``paddle_tpu/distributed/compat.py``; reference: the paddle.distributed
``__all__`` entries outside the core modules — enums, the
parameter-server dataset and entry configs, auto-parallel sugar, the
gloo shims, the object collectives).

Where the JAX package's single process makes a collective trivial (the
object lists, ``gather``) the port, one process a rank, runs it over
the process group.
"""

from __future__ import annotations

import numpy as np
import torch


# -- enums -------------------------------------------------------------------
class ParallelMode:
    """reference: distributed/parallel.py ParallelMode."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class ReduceType:
    """reference: auto_parallel/placement_type ReduceType."""

    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6


# -- PS table entry configs (reference: distributed/entry_attr.py) -----------
class _Entry:
    def __init__(self, kind, *args):
        self._kind = kind
        self._args = args

    def _to_attr(self):
        return ":".join([self._kind] + [str(a) for a in self._args])


class ProbabilityEntry(_Entry):
    def __init__(self, probability):
        if not 0 < probability <= 1:
            raise ValueError("probability must be in (0, 1]")
        super().__init__("probability_entry", probability)


class CountFilterEntry(_Entry):
    def __init__(self, count_filter):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        super().__init__("count_filter_entry", count_filter)


class ShowClickEntry(_Entry):
    def __init__(self, show_name, click_name):
        super().__init__("show_click_entry", show_name, click_name)


# -- PS datasets (reference: distributed/fleet/dataset/dataset.py) -----------
class InMemoryDataset:
    """Files loaded into memory, shuffled, iterated by the PS trainers.
    The reference backs this with a C++ dataset; here host RAM + the
    MultiSlot text protocol."""

    def __init__(self):
        self._files = []
        self._samples = []
        self._parser = None
        self.use_var = []

    def init(self, batch_size=1, thread_num=1, use_var=None, pipe_command="",
             input_type=0, **kwargs):
        self.batch_size = batch_size
        self.use_var = use_var or []

    update_settings = init

    def set_filelist(self, files):
        self._files = list(files)

    def load_into_memory(self):
        self._samples = []
        for path in self._files:
            with open(path) as f:
                self._samples.extend(ln.rstrip("\n") for ln in f)

    def local_shuffle(self):
        np.random.shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num=12):
        self.local_shuffle()

    def get_memory_data_size(self, fleet=None):
        return len(self._samples)

    def release_memory(self):
        self._samples = []

    def __iter__(self):
        return iter(self._samples)


class QueueDataset(InMemoryDataset):
    """Streaming variant (reference: QueueDataset) — iterates files
    directly without the load/shuffle step."""

    def __iter__(self):
        for path in self._files:
            with open(path) as f:
                yield from (ln.rstrip("\n") for ln in f)


# -- auto-parallel sugar -----------------------------------------------------
def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """Build a tensor with ``fn`` and shard it (reference:
    auto_parallel/api.py dtensor_from_fn)."""
    from .auto_parallel import shard_tensor
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def unshard_dtensor(dist_tensor):
    """The whole value of a dist tensor as a plain tensor on every rank
    (reference: auto_parallel/api.py unshard_dtensor; every rank
    calls)."""
    from ..core.tensor import Tensor
    from .auto_parallel import _whole
    t = Tensor._wrap(_whole(dist_tensor).clone())
    t.stop_gradient = getattr(dist_tensor, "stop_gradient", True)
    return t


def shard_dataloader(dataloader, meshes, input_keys=None, shard_dims=None,
                     is_dataset_splitted=False):
    """reference: auto_parallel/api.py shard_dataloader.  The loader
    passes through: the mesh train step takes each rank's rows of the
    global batch itself (``jit.mesh.MeshPlan.rows``), so every rank
    reads the same global batches; a loader that already yields this
    rank's rows is ``io.DevicePrefetcher(loader, sharding=...)``'s."""
    return dataloader


def shard_scaler(scaler):
    """reference: auto_parallel/api.py shard_scaler: the mesh step takes
    the GradScaler's found-inf flag as the maximum over every rank."""
    return scaler


class Strategy:
    """Auto-parallel Strategy (reference: auto_parallel/strategy.py), the
    to_static twin of fleet.DistributedStrategy."""

    class _Section(dict):
        __getattr__ = dict.get

        def __setattr__(self, k, v):
            self[k] = v

    def __init__(self, config=None):
        self.sharding = Strategy._Section(enable=False, degree=1, stage=1)
        self.fused_passes = Strategy._Section(enable=False)
        self.gradient_merge = Strategy._Section(enable=False, k_steps=1)
        self.pipeline = Strategy._Section(enable=False, schedule_mode="1F1B")
        self.amp = Strategy._Section(enable=False, dtype="float16",
                                     level="O1")
        if config:
            for k, v in dict(config).items():
                cur = getattr(self, k, None)
                if isinstance(cur, Strategy._Section) and isinstance(
                        v, dict):
                    cur.update(v)
                else:
                    setattr(self, k, v)


class DistModel:
    """reference: auto_parallel/api.py DistModel: a layer, a loader, a
    loss and an optimizer run eagerly: in train mode a call is the
    forward, the loss, ``backward()`` and the optimizer's step."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None, metrics=None):
        self.network = layer
        self._loader = loader
        self._loss = loss
        self._optimizer = optimizer
        self._strategy = strategy or Strategy()
        self._mode = "train"

    def train(self):
        self._mode = "train"
        self.network.train()

    def eval(self):
        self._mode = "eval"
        self.network.eval()

    def predict(self):
        self._mode = "predict"
        self.network.eval()

    def __call__(self, *args):
        if self._mode == "train":
            if self._loss is None:
                raise ValueError("DistModel train mode needs a loss")
            out = self.network(*args[:-1])
            loss = self._loss(out, args[-1])
            loss.backward()
            if self._optimizer is not None:
                self._optimizer.step()
                self._optimizer.clear_grad()
            return loss
        with torch.no_grad():
            return self.network(*args)


# -- sharding-stage API objects (reference: distributed/sharding/) -----------
def _stage(level):
    def apply(model, optimizer=None, group=None, **kwargs):
        """The ZeRO stage's annotations
        (``fleet.parallel_apply.apply_fsdp_annotations``), which the mesh
        train step reads as its storage sharding."""
        from .fleet.parallel_apply import apply_fsdp_annotations
        apply_fsdp_annotations(model, stage=level)
        return (model, optimizer) if optimizer is not None else model
    apply.__name__ = f"ShardingStage{level}"
    return apply


ShardingStage1 = _stage(1)
ShardingStage2 = _stage(2)
ShardingStage3 = _stage(3)


# -- collectives / runtime shims ---------------------------------------------
def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    from .communication import all_to_all
    return all_to_all(out_tensor_list, in_tensor_list, group, sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Single-tensor all-to-all: ``in_tensor`` split along its first
    dimension over the ranks (``in_split_sizes``, default equal), the
    pieces exchanged and concatenated into ``out_tensor`` (reference:
    communication/all_to_all.py alltoall_single)."""
    from ..core.tensor import Tensor, unwrap
    from .communication import _nranks, all_to_all
    n = max(_nranks(group), 1)
    x = unwrap(in_tensor)
    ins = (torch.chunk(x, n, 0) if in_split_sizes is None
           else torch.split(x, list(in_split_sizes), 0))
    ins = [t.contiguous() for t in ins]
    if out_split_sizes is None:
        outs = [torch.empty_like(t) for t in ins]
    else:
        outs = [x.new_empty((s,) + tuple(x.shape[1:]))
                for s in out_split_sizes]
    all_to_all(outs, ins, group, sync_op)
    out = torch.cat(outs, 0)
    if isinstance(out_tensor, Tensor):
        out_tensor._data = out
    else:
        out_tensor.resize_(out.shape).copy_(out)
    return out_tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """reference: communication/gather.py: every rank's ``tensor``, in
    rank order, on ``dst`` (an all-gather; the others get None)."""
    from .communication import all_gather
    from .env import get_rank
    tmp = []
    all_gather(tmp, tensor, group)
    if gather_list is not None and get_rank() == dst:
        gather_list.extend(tmp)
    return tmp if get_rank() == dst else None


def broadcast_object_list(object_list, src=0, group=None):
    """reference: communication/broadcast.py broadcast_object_list:
    ``object_list`` replaced in place by ``src``'s (pickled over the
    process group)."""
    import torch.distributed as dist
    from .communication import _pg
    from .env import get_world_size
    if get_world_size() > 1:
        dist.broadcast_object_list(object_list, src=src, group=_pg(group))
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """reference: communication/scatter.py scatter_object_list: rank r
    gets ``src``'s ``in_object_list[r]`` in ``out_object_list``."""
    import torch.distributed as dist
    from .communication import _pg
    from .env import get_rank, get_world_size
    n = get_world_size()
    if n <= 1:
        out_object_list.extend(in_object_list or [])
        return
    got = [None]
    dist.scatter_object_list(got, in_object_list if get_rank() == src
                             else None, src=src, group=_pg(group))
    out_object_list.clear()
    out_object_list.append(got[0])


def destroy_process_group(group=None):
    """reference: collective.py destroy_process_group."""
    from .env import reset_parallel_env
    reset_parallel_env()


def wait(tensor, group=None, use_calc_stream=True):
    """reference: collective.py wait: the host waits for the work queued
    on the tensor's card (its current stream)."""
    from ..core.tensor import unwrap
    t = unwrap(tensor)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return tensor


def is_available():
    """reference: distributed/__init__.py is_available."""
    import torch.distributed as dist
    return dist.is_available()


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """reference: collective.py split, the model-parallel fc/embedding
    helper: the port's surface is fleet's parallel layers, so this
    raises with the pointer, as the JAX package's does."""
    raise NotImplementedError(
        "paddle.distributed.split: use fleet.meta_parallel "
        "ColumnParallelLinear/RowParallelLinear/VocabParallelEmbedding "
        "(each rank holds its shard and issues the collectives)")


# -- gloo shims (reference: the gloo CPU rendezvous) --------------------------
def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """A gloo process group of ``rank_num`` ranks meeting at
    ``server_endpoint`` (``host:port``)."""
    from .env import init_parallel_env
    return init_parallel_env(backend="gloo", rank=rank_id,
                             world_size=rank_num,
                             init_method="tcp://" + server_endpoint)


def gloo_barrier():
    from .communication import barrier
    barrier()


def gloo_release():
    pass


__all__ = ["CountFilterEntry", "DistModel", "InMemoryDataset",
           "ParallelMode", "ProbabilityEntry", "QueueDataset", "ReduceType",
           "ShardingStage1", "ShardingStage2", "ShardingStage3",
           "ShowClickEntry", "Strategy", "alltoall", "alltoall_single",
           "broadcast_object_list", "destroy_process_group",
           "dtensor_from_fn", "gather", "gloo_barrier",
           "gloo_init_parallel_env", "gloo_release", "is_available",
           "scatter_object_list", "shard_dataloader", "shard_scaler",
           "split", "unshard_dtensor", "wait"]
