"""``paddle.distributed.io`` (port of ``paddle_tpu/distributed/io.py``;
reference: python/paddle/distributed/io.py — the static graph's
persistables).  The port has no static program: a layer's state and its
optimizer's go through ``distributed.checkpoint`` (sharded, one file set
a rank, resharded on load) or ``resilience.CheckpointManager``."""

from __future__ import annotations


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    """reference: distributed/io.py save_persistables."""
    raise NotImplementedError(
        "static persistables: use paddle_tpu_torch.distributed."
        "save_state_dict (sharded, crash-safe) or resilience."
        "CheckpointManager(root).save(train_step, step)")


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    raise NotImplementedError(
        "static persistables: use paddle_tpu_torch.distributed."
        "load_state_dict or resilience.CheckpointManager(root).restore")


def is_persistable(var):
    return getattr(var, "persistable", False)


__all__ = ["is_persistable", "load_persistables", "save_persistables"]
