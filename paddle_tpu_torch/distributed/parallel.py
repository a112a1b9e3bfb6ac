"""``DataParallel`` and ``fused_allreduce_gradients`` (port of
``paddle_tpu/distributed/parallel.py``).

Eager data parallelism: every rank runs the model on its rows and the
gradients are averaged over the data-parallel group before the
optimizer steps.  ``jit.CompiledTrainStep(mesh=...)`` does the same
inside its step (and keeps it in the CUDA graph of a fused window).
"""

from __future__ import annotations

import torch

from ..core.tensor import unwrap
from ..nn.layer.layers import Layer
from .communication import ReduceOp, all_reduce
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env)


def _grads(params):
    for p in params:
        g = unwrap(p).grad
        if g is not None:
            yield g


def fused_allreduce_gradients(params, hcg=None):
    """Average the gradients of ``params`` over the data-parallel group of
    ``hcg`` (the world without one): the gradients are flattened into
    one buffer a dtype, all-reduced once and divided by the group
    size."""
    group = None
    if hcg is not None:
        group = hcg.get_data_parallel_group()
        n = group.nranks
    else:
        n = get_world_size()
    by_dtype = {}
    for g in _grads(params):
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce(flat, op=ReduceOp.SUM, group=group)
        flat.div_(n)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


class DataParallel(Layer):
    """Wraps ``layers``; after ``loss.backward()``, call
    :meth:`apply_collective_grads` (or let a ``fleet`` hybrid optimizer
    do it) to average the gradients over the group."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        params = self._layers.parameters()
        if self.group is None:
            fused_allreduce_gradients(params)
            return
        n = self.group.nranks
        for g in _grads(params):
            all_reduce(g, op=ReduceOp.SUM, group=self.group)
            g.div_(n)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)


__all__ = ["DataParallel", "ParallelEnv", "fused_allreduce_gradients",
           "get_rank", "get_world_size", "init_parallel_env"]
