"""Automatic mixed precision (port of ``paddle_tpu/amp/__init__.py``):
``auto_cast``/``amp_guard`` and ``decorate``, and dynamic loss scaling.

``auto_cast(level=, dtype=, custom_white_list=, custom_black_list=)``
sets the AMP state that ``core.dispatch.apply_op`` reads: by op name, a
white-listed op casts fp32 inputs to the AMP dtype, a black-listed one
casts 16-bit inputs to fp32, and at O2 every other op casts fp32 inputs
to the AMP dtype (the JAX lists, :data:`WHITE_LIST` and
:data:`BLACK_LIST`).  ``decorate(models, optimizers, level="O2")`` casts
every fp32 parameter of every sublayer but the norm layers to the AMP
dtype **in place** (``param.data``): each stays the same
``torch.nn.Parameter``, so an optimizer made before keeps its
parameters, and its fp32 masters, made lazily at the first step, start
from the 16-bit values as the JAX ones do.

``GradScaler``:

The scale and its good/bad step counts are 0-d tensors, updated in
place on the gradients' device (the JAX ``_traced_update``), whoever
drives the scaler.  By hand: ``scaler.scale(loss).backward()``, then
``scaler.step(optimizer)`` unscales the gradients, reads back once
whether any is NaN/Inf, steps the optimizer only if none is, and updates
the scale, as the JAX eager scaler does.  Given to
``jit.CompiledTrainStep(..., scaler=scaler)`` the same unscale and
update run inside the step and nothing is read back: the update of an
overflowing step is undone with ``torch.where`` (the JAX
``_skip_select``).

Unscaling zeroes every gradient on overflow (the JAX ``_scaled_backward``
rule; the JAX eager ``unscale_`` leaves them non-finite, which no step
reads).  It takes a paddle-style ``Tensor`` loss and optimizers built
on ``Layer.parameters()`` as well as torch tensors.
"""

from __future__ import annotations

import torch

from ..core.state import STATE
from ..core.tensor import Tensor, unwrap

#: ops that run in the AMP dtype (``amp_lists.py``'s white list)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "einsum", "mm", "bmm", "addmm",
    "flash_attention", "sdpa", "lstm_cell", "gru_cell", "simple_rnn_cell",
}
#: ops forced to fp32
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cos_sim",
    "softmax", "log_softmax", "cross_entropy", "bce", "bce_with_logits",
    "nll_loss", "mse_loss", "l1_loss", "kl_div", "layer_norm", "rms_norm",
    "batch_norm", "group_norm", "instance_norm", "p_norm",
    "softmax_with_cross_entropy", "sigmoid_focal_loss", "cumsum",
    "logsumexp", "erfinv", "pow", "var", "std", "renorm", "atan2", "acos",
    "asin", "cosh", "sinh", "tan", "logcumsumexp",
}


def white_list():
    return WHITE_LIST


def black_list():
    return BLACK_LIST


class auto_cast:
    """``paddle.amp.auto_cast`` (reference: amp/auto_cast.py:859): a
    context manager that sets the AMP level (``O1``/``O2``), dtype
    (``bfloat16`` unless ``float16``/``fp16``) and op lists."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        self.enable = enable
        self.level = level if enable else "O0"
        self.dtype = "float16" if dtype in ("float16", "fp16") \
            else "bfloat16"
        self.white = set(WHITE_LIST)
        self.black = set(BLACK_LIST)
        if custom_white_list:
            self.white |= set(custom_white_list)
            self.black -= set(custom_white_list)
        if custom_black_list:
            self.black |= set(custom_black_list)
            self.white -= set(custom_black_list)

    def __enter__(self):
        self._prev = (STATE.amp_level, STATE.amp_dtype, STATE.amp_white,
                      STATE.amp_black)
        STATE.amp_level = self.level
        STATE.amp_dtype = self.dtype
        STATE.amp_white = self.white
        STATE.amp_black = self.black
        return self

    def __exit__(self, *exc):
        (STATE.amp_level, STATE.amp_dtype, STATE.amp_white,
         STATE.amp_black) = self._prev
        return False


amp_guard = auto_cast


@torch.no_grad()
def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast every fp32 parameter of every sublayer but the norm
    layers (and ``excluded_layers``) to the AMP dtype, in place; O1
    changes nothing.  Returns ``models`` (and ``optimizers``) as
    given."""
    from ..nn.layer.norm import LayerNorm
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        target = (torch.float16 if dtype in ("float16", "fp16")
                  else torch.bfloat16)
        skip = (LayerNorm, *(excluded_layers or ()))
        for m in model_list:
            for lay in m.sublayers(include_self=True):
                if isinstance(lay, skip):
                    continue
                for p in lay._parameters.values():
                    if p is not None and p.dtype == torch.float32:
                        p.data = p.data.to(target)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling; with ``enable=False`` every method passes
    through."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        #: {"scale", "good", "bad"}: moved to the gradients' device at
        #: first use, then only updated in place
        self._state = {
            "scale": torch.tensor(float(init_loss_scaling),
                                  dtype=torch.float32),
            "good": torch.zeros((), dtype=torch.int32),
            "bad": torch.zeros((), dtype=torch.int32)}
        self._found_inf = False

    def _on(self, device):
        """The state, on ``device``."""
        if self._state["scale"].device != device:
            self._state = {k: v.to(device) for k, v in self._state.items()}
        return self._state

    def scale(self, var):
        """``var`` times the scale rounded to ``var``'s dtype (as JAX
        multiplies by a weakly typed float)."""
        if not self._enable:
            return var
        if isinstance(var, Tensor):
            return Tensor._wrap(self.scale(var._data))
        return var * self._on(var.device)["scale"].to(var.dtype)

    @torch.no_grad()
    def _unscale(self, params, grads=None):
        """Divide the gradients of ``params`` (or the tensors ``grads``)
        by the scale in fp32 and round them back to their dtype; on
        overflow zero them all.  Returns the overflow flag, a 0-d bool
        on the device (nothing is read back)."""
        if grads is None:
            grads = [unwrap(p).grad for p in params
                     if unwrap(p).grad is not None]
        if not grads:
            return torch.zeros((), dtype=torch.bool,
                               device=self._state["scale"].device)
        inv = 1.0 / self._on(grads[0].device)["scale"]
        found = torch.zeros((), dtype=torch.bool, device=inv.device)
        for g in grads:
            found = found | ~torch.isfinite(g.float() * inv).all()
        for g in grads:
            g32 = g.float() * inv
            g.copy_(torch.where(found, torch.zeros_like(g32), g32))
        return found

    def unscale_(self, optimizer):
        if not self._enable:
            return
        self._found_inf = bool(self._unscale(optimizer._parameter_list))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        found = self._unscale(optimizer._parameter_list)
        self._found_inf = bool(found)   # the one read-back
        if not self._found_inf:
            optimizer.step()
        self._update(found)

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        pass  # folded into step, as in the JAX package

    @torch.no_grad()
    def _update(self, found):
        """The JAX ``_traced_update``, in place on the state."""
        if not self._dynamic:
            return
        s = self._on(found.device)
        zero = torch.zeros_like(s["good"])
        bad = torch.where(found, s["bad"] + 1, zero)
        good = torch.where(found, zero, s["good"] + 1)
        dec = found & (bad >= self._decr_every)
        inc = ~found & (good >= self._incr_every)
        scale = torch.where(
            dec, torch.clamp_min(s["scale"] * self._decr_ratio, 1.0),
            torch.where(inc, s["scale"] * self._incr_ratio, s["scale"]))
        s["scale"].copy_(scale)
        s["good"].copy_(torch.where(inc, zero, good))
        s["bad"].copy_(torch.where(dec, zero, bad))

    # -- state ---------------------------------------------------------------
    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._state["scale"].clone()

    def set_init_loss_scaling(self, v):
        self._state["scale"].fill_(float(v))

    def state_dict(self):
        """Plain numbers, read back from the state."""
        s = self._state
        return {"scale": float(s["scale"]), "good_steps": int(s["good"]),
                "bad_steps": int(s["bad"])}

    def load_state_dict(self, state):
        """Set the scale and counts, in place."""
        s = self._state
        s["scale"].fill_(float(state.get("scale", float(s["scale"]))))
        s["good"].fill_(int(state.get("good_steps", 0)))
        s["bad"].fill_(int(state.get("bad_steps", 0)))


def is_bfloat16_supported(device=None):
    """Whether ``device`` (default: the CUDA device when there is one)
    computes in bfloat16."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        return torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(device=None):
    return True


__all__ = ["BLACK_LIST", "GradScaler", "WHITE_LIST", "amp_guard",
           "auto_cast", "black_list", "decorate", "is_bfloat16_supported",
           "is_float16_supported", "white_list"]
