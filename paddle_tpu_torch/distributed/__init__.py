"""``paddle.distributed`` of the port: ``fleet.recompute`` and the
one-process ``checkpoint`` (``save_state_dict``/``load_state_dict``);
the rest is ROADMAP.md A7."""

from . import checkpoint, fleet
from .checkpoint import (CheckpointCorrupt, load_state_dict,
                         save_state_dict, wait_async_save)

__all__ = ["CheckpointCorrupt", "checkpoint", "fleet", "load_state_dict",
           "save_state_dict", "wait_async_save"]
