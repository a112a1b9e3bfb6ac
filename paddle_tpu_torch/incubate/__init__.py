"""``paddle.incubate`` of the port (port of ``paddle_tpu/incubate``): the
Mixture-of-Experts names of :mod:`.moe`.  The rest of the JAX package's
``incubate`` (``asp``, ``LookAhead``, ``incubate.nn``'s fused ops) is
ROADMAP.md A10."""

from . import moe
from .moe import (GShardGate, MoELayer, SwitchGate, moe_capacity, moe_ffn,
                  topk_gating)

__all__ = ["GShardGate", "MoELayer", "SwitchGate", "moe_capacity", "moe_ffn",
           "topk_gating"]
