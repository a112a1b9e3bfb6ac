"""paddle_tpu_torch.resilience: fault-tolerant training (port of
``paddle_tpu/resilience``; reference analogue: Paddle's fleet/elastic
stack).

Three pieces:

* :class:`CheckpointManager` (``manager.py``): snapshots the complete
  training state of a ``jit.CompiledTrainStep`` (parameters, optimizer
  accumulators and masters, scaler, scheduler, random generators, data
  cursor) at one counted ``sync()`` a save, writes it through
  ``distributed.checkpoint`` with an atomic directory commit, per-chunk
  crc32 checked on load, retry with backoff, keep-last-N GC, and async
  writes that overlap the next window; on a mesh every rank writes its
  shards and a restore onto another mesh reshards;
* :class:`FaultTolerantTrainer` (``trainer.py``): a loop that catches
  faults, restores the last good checkpoint, replays the data iterator
  to the saved offset and continues bit for bit;
* ``faultinject``: the deterministic, flag-driven fault schedule
  (``FLAGS_fault_schedule``) the tests and ``chip_smoke.py`` use to drive
  every recovery path; the serving engine and fleet fire their own
  sites from it too.

Counters: ``resilience.saves / save_ms / restores /
resharded_restores / retries / corrupt_detected / recoveries /
save_failures / faults_injected / gc_removed`` (+
``io.skipped_batches`` from the replay).
"""

from . import faultinject  # noqa: F401
from .manager import (CheckpointCorrupt, CheckpointLayoutError,  # noqa: F401
                      CheckpointManager, CheckpointWriteError)
from .trainer import FaultTolerantTrainer, NonFiniteLossError  # noqa: F401

__all__ = [
    "CheckpointManager", "CheckpointCorrupt", "CheckpointLayoutError",
    "CheckpointWriteError",
    "FaultTolerantTrainer", "NonFiniteLossError", "faultinject",
]
