"""Backward and ``paddle.grad`` over torch autograd (port of
``paddle_tpu/core/autograd.py``).

torch records the graph as ops run, so the JAX module's ``GradNode``
tape and its topological walk are ``torch.autograd.backward`` and
``torch.autograd.grad``.  Leaf gradients accumulate as Paddle's do:
``.grad`` adds up across backward calls until ``clear_grad``.  A sparse
embedding's ``SelectedRows`` gradient is written by its own hook
(``nn.Embedding(sparse=True)``); ``paddle.grad`` sets
``STATE.accumulating_backward`` to False while it runs, so that hook
leaves ``.grad`` alone, as in JAX.
"""

from __future__ import annotations

import torch

from .state import STATE


def _data(t):
    from .tensor import Tensor
    return t._data if isinstance(t, Tensor) else t


def run_backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``
    (``egr::RunBackward``).  A tensor outside any graph (a leaf with
    ``stop_gradient``) contributes nothing, as in the JAX engine.  A
    non-scalar tensor needs its grad tensor."""
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    outs, grads = [], []
    for t, g in zip(tensors, grad_tensors):
        d = _data(t)
        if g is None and d.numel() != 1:
            raise RuntimeError(
                f"backward() on non-scalar tensor shape={list(d.shape)} "
                "requires an explicit grad tensor")
        if not d.requires_grad:
            continue
        outs.append(d)
        grads.append(None if g is None else torch.as_tensor(
            _data(g), dtype=d.dtype, device=d.device))
    if outs:
        torch.autograd.backward(outs, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None, name=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` as ``Tensor``s, without touching ``.grad``."""
    from .tensor import Tensor

    single = isinstance(inputs, Tensor)
    outputs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    inputs = [inputs] if single else list(inputs)
    if isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    outs = [_data(o) for o in outputs]
    gos = None if grad_outputs is None else [
        None if g is None else _data(g) for g in grad_outputs]
    STATE.accumulating_backward = False
    try:
        res = torch.autograd.grad(outs, [_data(i) for i in inputs], gos,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=allow_unused)
    except RuntimeError as e:
        if "not have been used in the graph" in str(e):
            raise RuntimeError(
                "an input tensor is unused in the graph; pass "
                "allow_unused=True to get None instead") from e
        raise
    finally:
        STATE.accumulating_backward = True
    return [None if r is None else Tensor._wrap(r) for r in res]
