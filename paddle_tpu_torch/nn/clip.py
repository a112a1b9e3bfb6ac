"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``).

A clip object is called by ``Optimizer.step`` on the ``(param, grad)``
pairs and returns new pairs; every norm and coefficient stays a device
tensor, so clipping adds no host sync to a training step.  A 16-bit
gradient is scaled in fp32 and rounded back once, as the JAX package's
promotion does.  A parameter with ``need_clip = False`` keeps its
gradient and, under the global norm, stays out of the norm (Paddle's
rule; the JAX package honours it in ``ClipGradByGlobalNorm`` only).

Sparse (``SelectedRows``) gradients: ``ClipGradByGlobalNorm`` merges
their duplicate rows, adds the merged values' squares to the global
norm and scales the values, never densifying
(``_handles_selected_rows``); the optimizer lets them bypass
``ClipGradByValue`` and ``ClipGradByNorm`` with a ``RuntimeWarning``, as
the JAX optimizer does.

A caller that already holds each gradient's fp32 sum of squares (the
train step, for its grad-norm metric) passes them as ``sq``, a dict from
``id(param)``; the norm clips then read them instead of making a second
pass over the gradients.
"""

from __future__ import annotations

import torch

from ..core.selected_rows import SelectedRows


def _skip(p, g):
    return g is None or getattr(p, "need_clip", True) is False


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def sum_sq(g):
    """The fp32 sum of squares of gradient ``g`` (a 0-d device tensor)."""
    g32 = g.float()
    return torch.sum(g32 * g32)


def _sq(p, g, sq):
    return sq[id(p)] if sq is not None and id(p) in sq else sum_sq(g)


class ClipGradBase:
    def __call__(self, params_grads, sq=None):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads, sq=None):
        return [(p, g) if _skip(p, g)
                else (p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads, sq=None):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(_sq(p, g, sq))
            scale = torch.clamp_max(self.clip_norm / norm.clamp_min(1e-12),
                                    1.0)
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken over the gradients of the
    parameters that ``need_clip``.  A ``SelectedRows`` gradient has its
    duplicate rows merged first; the merged values' squares join the
    norm and the merged values are scaled."""

    #: read by ``Optimizer.step``: sparse gradients are routed through it
    _handles_selected_rows = True

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def global_norm(self, params_grads, sq=None):
        """The fp32 L2 norm over the clipped gradients (a device 0-d
        tensor), or ``None`` when there are none."""
        total = None
        for p, g in params_grads:
            if _skip(p, g):
                continue
            s = (sum_sq(g.merge_rows().values) if isinstance(g, SelectedRows)
                 else _sq(p, g, sq))
            total = s if total is None else total + s
        return None if total is None else torch.sqrt(total)

    def __call__(self, params_grads, sq=None):
        params_grads = [(p, g.merge_rows() if isinstance(g, SelectedRows)
                         else g) for p, g in params_grads]
        norm = self.global_norm(params_grads, sq)
        if norm is None:
            return params_grads
        scale = self.clip_norm / norm.clamp_min(self.clip_norm)
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
            elif isinstance(g, SelectedRows):
                out.append((p, SelectedRows(g.rows, _scaled(g.values, scale),
                                            g.height)))
            else:
                out.append((p, _scaled(g, scale)))
        return out


def _params(parameters):
    return ([parameters] if isinstance(parameters, torch.Tensor)
            else list(parameters))


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place to a total ``norm_type`` norm of at
    most ``max_norm``; returns the total norm (fp32 device tensor).
    ``error_if_nonfinite`` reads the norm back and raises if it is
    NaN or Inf."""
    params = _params(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max().float()
    else:
        total = torch.stack([torch.sum(g.float().abs() ** norm_type)
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"clip_grad_norm_: the total norm of order "
                           f"{norm_type} is not finite")
    scale = torch.clamp_max(max_norm / total.clamp_min(1e-6), 1.0)
    for g in grads:
        g.copy_(_scaled(g, scale))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp the gradients in place into ``[-clip_value, clip_value]``."""
    for p in _params(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)


__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]
