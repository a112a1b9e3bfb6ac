"""Activation recompute (port of
``paddle_tpu/distributed/fleet/recompute.py``'s ``recompute``).

``recompute(function, *args)`` runs ``function`` under
``torch.utils.checkpoint(use_reentrant=False)``: its activations are
dropped and the backward runs it again.  The replay must compute what
the forward computed, and torch's checkpoint restores only torch's
global CPU/CUDA RNG states and ``torch.autocast``.  So the port saves
and restores two more things for the replay:

* the paddle-style default generators (``tensor.random``), which draw
  the dropout masks: without them the replayed masks differ and the
  gradients are wrong;
* the AMP level, dtype and lists (``core.state``): the backward, and so
  the replay, usually runs after the ``auto_cast`` block has closed.

Both are put back after the replay, so the backward does not move the
generators.
"""

from __future__ import annotations

import torch.utils.checkpoint

from ...core.state import amp_state, set_amp_state
from ...tensor import random as _random


def recompute(function, *args, **kwargs):
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    rng = _random._states() if preserve else None
    amp = amp_state()
    ran = [False]

    def run(*a):
        if not ran[0]:          # the forward
            ran[0] = True
            return function(*a, **kwargs)
        now_rng, now_amp = (_random._states() if preserve else None,
                            amp_state())
        if preserve:
            _random._set_states(rng)
        set_amp_state(amp)
        try:
            return function(*a, **kwargs)
        finally:
            if preserve:
                _random._set_states(now_rng)
            set_amp_state(now_amp)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=preserve)


__all__ = ["recompute"]
