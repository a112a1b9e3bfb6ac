"""Eager op dispatch (port of ``paddle_tpu/core/dispatch.py``).

``apply_op(name, fn, *args)`` unwraps the ``Tensor`` arguments (also
inside lists and tuples) to their ``torch.Tensor``, applies the AMP
cast of op ``name`` (:func:`_amp_cast`), calls ``fn`` on the torch
tensors and wraps what it returns.  torch autograd records the graph as
``fn`` runs, so there is no ``jax.vjp`` and no ``GradNode``: a cast is
an op of that graph, and a cotangent comes back to its input in the
input's dtype, as the JAX closure's cast gives it.  The JAX per-op
``FLAGS_check_nan_inf`` check is not ported: the port's flag acts in
``jit.CompiledTrainStep``, on the loss, gradients and parameters.

The AMP lists act by op name, so every ``apply_op`` name in the port is
the JAX package's, letter for letter (``"linear"``, ``"layer_norm"``,
``"sdpa"``, ``"flash_attention"``, ``"cross_entropy"``,
``"mlm_logits"``, ...).
"""

from __future__ import annotations

import torch

from .state import STATE

#: every op dispatched so far, by name (the JAX ``OPS`` registry)
OPS: dict[str, dict] = {}

_LOW = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def register_op(name, fn=None, **meta):
    if name not in OPS:
        OPS[name] = {"fn": fn, **meta}
    return OPS[name]


def _cast_if(datas, from_dtypes, to):
    return [d.to(to) if isinstance(d, torch.Tensor) and d.dtype in from_dtypes
            else d for d in datas]


def _amp_cast(name, datas):
    """O1/O2 autocast of op ``name``'s flat inputs, the JAX rule: a
    white-listed op casts fp32/fp64 inputs to the AMP dtype, a
    black-listed one casts fp16/bf16 inputs to fp32, and under O2 every
    other op casts fp32 inputs to the AMP dtype."""
    level = STATE.amp_level
    if level == "O0":
        return datas
    target = _LOW[STATE.amp_dtype]
    if name in STATE.amp_white:
        return _cast_if(datas, (torch.float32, torch.float64), target)
    if name in STATE.amp_black:
        return _cast_if(datas, (torch.float16, torch.bfloat16),
                        torch.float32)
    if level == "O2":
        return _cast_if(datas, (torch.float32,), target)
    return datas


def _flatten(args, leaves):
    """The leaves of ``args`` (lists and tuples walked) into ``leaves``;
    returns a function that rebuilds the structure from new leaves."""
    if isinstance(args, (list, tuple)):
        builders = [_flatten(a, leaves) for a in args]
        kind = type(args)
        return lambda it: kind(b(it) for b in builders)
    leaves.append(args)
    return lambda it: next(it)


def apply_op(name, fn, *args, nout=1, amp=True, **kwargs):
    """Run op ``name`` implemented by ``fn`` (on torch tensors); returns a
    ``Tensor`` or a tuple of them."""
    from .tensor import Tensor

    register_op(name, fn)
    leaves = []
    rebuild = _flatten(args, leaves)
    datas = [l._data if isinstance(l, Tensor) else l for l in leaves]
    if amp and STATE.amp_level != "O0":
        datas = _amp_cast(name, datas)
    out = fn(*rebuild(iter(datas)), **kwargs)
    return _wrap_outputs(name, out)


def _wrap_outputs(name, out):
    from .tensor import Tensor

    if isinstance(out, tuple):
        return tuple(Tensor._wrap(o) for o in out)
    return Tensor._wrap(out)
