"""``cross_entropy`` (port of ``paddle_tpu/nn/functional/loss.py:24-70``):
log-softmax over ``axis``, hard labels with ``ignore_index`` (their loss
is 0 and ``mean`` divides by the count of valid labels, at least 1),
soft labels, class weights and label smoothing."""

from __future__ import annotations

import torch

from ...core.dispatch import apply_op
from ...core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    input, label = _t(input), _t(label)

    def fn(logits, lab, *w):
        ax = axis if axis >= 0 else logits.dim() + axis
        logp = (torch.log_softmax(logits, dim=ax) if use_softmax
                else torch.log(logits.clamp_min(1e-30)))
        n_class = logits.shape[ax]
        if soft_label or (lab.dim() == logits.dim()
                          and lab.shape[ax] == n_class
                          and lab.is_floating_point()):
            soft = lab.to(logp.dtype)
            if label_smoothing > 0:
                soft = soft * (1 - label_smoothing) + label_smoothing / n_class
            return _reduce(-(soft * logp).sum(ax), reduction)
        li = lab.squeeze(ax) if lab.dim() == logits.dim() else lab
        li = li.long()
        valid = li != ignore_index
        safe = torch.where(valid, li, 0)
        picked = logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
        if label_smoothing > 0:
            loss = (-(1 - label_smoothing) * picked
                    - label_smoothing * logp.mean(ax))
        else:
            loss = -picked
        if w:
            loss = loss * w[0][safe]
        loss = torch.where(valid, loss, 0.0)
        if reduction == "mean":
            denom = (w[0][safe] * valid).sum() if w else valid.sum()
            return loss.sum() / denom.clamp_min(1)
        return _reduce(loss, reduction)
    if weight is not None:
        return apply_op("cross_entropy", fn, input, label, weight)
    return apply_op("cross_entropy", fn, input, label)


__all__ = ["cross_entropy"]
