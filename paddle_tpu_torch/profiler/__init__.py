"""Observability for the port: the process-global counter registry,
histograms and the train-metrics logger, the host span tracer, the
flight recorder, request traces, the device-time ledger, the health
plane and the trainer's goodput ledger."""

from . import (counters, devicetime, flight, goodput, health, host_tracer,
               metrics, trace)
from .metrics import Histogram, MetricsLogger

__all__ = ["counters", "devicetime", "flight", "goodput", "health",
           "host_tracer", "metrics", "trace", "Histogram", "MetricsLogger"]
