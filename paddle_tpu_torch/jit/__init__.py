"""One training step per call (port of ``paddle_tpu/jit/__init__.py``'s
``CompiledTrainStep``, single-step and single-device).

JAX compiles forward, backward and the optimizer update into one XLA
program with the state donated through it.  PyTorch runs eagerly, so a
call here is the body of that program (``_step_body``) run as it is:
``loss_fn(model, *args)``, ``loss.backward()``, ``optimizer.step()``,
``optimizer.clear_grad()``.  Parameters, fp32 masters and moments stay
on the device and are updated in place, so there is no state to carry or
sync.  The loss comes back as a device tensor without a host sync.

Counters, under the JAX names: ``jit.steps`` and ``jit.host.dispatches``
(one each per call) and ``optimizer.steps`` (from ``optimizer.step``).

Fused multi-step windows (CUDA-graph replay), the GradScaler, the mesh
and the train metrics are a later slice (ROADMAP.md A4, A7).
"""

from __future__ import annotations

from ..profiler import counters


class CompiledTrainStep:
    def __init__(self, model, loss_fn, optimizer, scaler=None, donate=True,
                 fused_steps=None, mesh=None, shard_rules=None,
                 batch_axes=None, metrics=None):
        for name, value, item in (
                ("fused_steps > 1", fused_steps not in (None, 1),
                 "A4 (fused windows with CUDA-graph replay)"),
                ("scaler", scaler is not None, "A4 (GradScaler and AMP)"),
                ("mesh", mesh is not None or shard_rules is not None
                 or batch_axes is not None, "A7 (distributed)"),
                ("metrics", metrics not in (None, False),
                 "A4 (train metrics)")):
            if value:
                raise NotImplementedError(
                    f"CompiledTrainStep({name}) is not ported yet: "
                    f"ROADMAP.md {item}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def __call__(self, *args):
        counters.inc("jit.steps")
        counters.inc("jit.host.dispatches")
        loss = self.loss_fn(self.model, *args)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()


__all__ = ["CompiledTrainStep"]
