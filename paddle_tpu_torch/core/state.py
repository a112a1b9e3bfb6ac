"""Thread-local interpreter state: the AMP level, dtype and op lists
(port of ``paddle_tpu/core/state.py``).

Grad mode is torch's own: the JAX ``no_grad_guard``/``enable_grad_guard``
are ``torch.no_grad``/``torch.enable_grad`` (exported as
``paddle_tpu_torch.no_grad``/``enable_grad``).  The JAX module's
parameter-version counter and device-state sync hooks (``:49-72``) have
no counterpart: a torch parameter is updated in place, so a train step
and the ``Layer`` that owns the parameter always see the same tensor.
"""

from __future__ import annotations

import threading


class _State(threading.local):
    def __init__(self):
        self.amp_level = "O0"          # O0 | O1 | O2
        self.amp_dtype = "bfloat16"    # or "float16"
        self.amp_white = set()
        self.amp_black = set()
        #: False during ``paddle.grad()``, which promises not to touch
        #: ``.grad``: the sparse embedding's gradient hook stands down
        self.accumulating_backward = True
        #: > 0 inside a ``jit.CompiledTrainStep`` body, which takes the
        #: dense path where eager code would make SelectedRows (the JAX
        #: package does so under tracing)
        self.tracing_depth = 0


STATE = _State()


def amp_state():
    """The AMP settings as a tuple (saved by ``recompute`` for its
    replay)."""
    return (STATE.amp_level, STATE.amp_dtype, STATE.amp_white,
            STATE.amp_black)


def set_amp_state(state):
    (STATE.amp_level, STATE.amp_dtype, STATE.amp_white,
     STATE.amp_black) = state
