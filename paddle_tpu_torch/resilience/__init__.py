"""paddle_tpu_torch.resilience — the deterministic fault schedule
(``faultinject``) the serving engine's fault sites read.  The checkpoint
manager and the fault-tolerant trainer are ROADMAP.md A8."""

from . import faultinject  # noqa: F401

__all__ = ["faultinject"]
