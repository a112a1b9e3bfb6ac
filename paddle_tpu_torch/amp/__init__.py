"""Dynamic loss scaling (port of ``GradScaler`` from
``paddle_tpu/amp/__init__.py``).

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
reads).  ``auto_cast`` and ``decorate`` act through the paddle-style
surface the port does not have yet (ROADMAP.md A4).
"""

from __future__ import annotations

import torch


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
        return var * self._on(var.device)["scale"].to(var.dtype)

    @torch.no_grad()
    def _unscale(self, params):
        """Divide the gradients of ``params`` by the scale in fp32 and
        round them back to their dtype; on overflow zero them all.
        Returns the overflow flag, a 0-d bool on the device (nothing is
        read back)."""
        grads = [p.grad for p in params if p.grad is not None]
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


__all__ = ["GradScaler", "is_bfloat16_supported", "is_float16_supported"]
