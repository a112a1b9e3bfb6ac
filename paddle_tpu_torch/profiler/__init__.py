"""Observability for the port: the process-global counter registry and
the train-metrics logger."""

from . import counters
from .metrics import MetricsLogger

__all__ = ["counters", "MetricsLogger"]
