"""The hybrid-parallel optimizer wrappers (port of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py``; reference:
fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py:255,
HybridParallelClipGrad:41, hybrid_parallel_gradscaler.py:24).

For Paddle's eager loop (``loss.backward(); opt.step()``) on a mesh:
:class:`HybridParallelOptimizer` averages the gradients over the data
axes before the inner optimizer steps; :class:`HybridParallelClipGrad`
sums each tensor-parallel shard's squares over ``mp`` (and only those:
a replicated parameter's gradient is whole on every rank) before the
global norm; :class:`HybridParallelGradScaler` takes the overflow flag
as the maximum over every rank.  (The mesh ``CompiledTrainStep`` does
all three inside its step.)
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ...core.tensor import unwrap
from ...nn.clip import ClipGradByGlobalNorm, sum_sq
from ..env import data_axes, get_mesh


class HybridParallelClipGrad:
    _handles_selected_rows = True

    def __init__(self, clip, hcg=None):
        self._clip = clip
        self._hcg = hcg

    def __call__(self, params_grads, sq=None):
        mesh = get_mesh()
        if mesh is None:
            return self._clip(params_grads, sq)
        sq = dict(sq or {})
        for p, g in params_grads:
            if id(p) in sq or g is None:
                continue
            s = sum_sq(g)
            if getattr(p, "is_distributed", False) is True:
                dist.all_reduce(s, group=mesh.group("mp"))
            sq[id(p)] = s
        return self._clip(params_grads, sq)


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if isinstance(optimizer._grad_clip, ClipGradByGlobalNorm):
            optimizer._grad_clip = HybridParallelClipGrad(
                optimizer._grad_clip, hcg)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._dp_sync()
        self._inner_opt.step()

    def _dp_sync(self):
        """The gradients' mean over the data axes (dp and sharding)."""
        mesh = get_mesh()
        if mesh is None:
            return
        axes = data_axes()
        n = mesh.degree(axes)
        group = mesh.group(axes)
        for p in self._inner_opt._parameter_list:
            g = unwrap(p).grad
            if g is not None:
                dist.all_reduce(g, group=group)
                g.div_(n)

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kwargs):
        loss.backward()
        self.step()
        self.clear_grad()


class HybridParallelGradScaler:
    """``scaler``, whose overflow check (``_unscale``, which ``step`` and
    ``unscale_`` call) now answers the maximum over every rank: the
    wrapped scaler's own check is replaced on the instance."""

    def __init__(self, scaler, hcg=None):
        self._scaler = scaler
        self._hcg = hcg
        local = scaler._unscale

        def unscale(params, grads=None):
            found = local(params, grads)
            if get_mesh() is None:
                return found
            f = found.to(torch.float32)
            dist.all_reduce(f, op=dist.ReduceOp.MAX)
            return f > 0
        scaler._unscale = unscale

    def __getattr__(self, item):
        return getattr(self._scaler, item)


__all__ = ["HybridParallelClipGrad", "HybridParallelGradScaler",
           "HybridParallelOptimizer"]
