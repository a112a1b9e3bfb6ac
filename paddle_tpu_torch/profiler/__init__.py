"""Observability for the port: the process-global counter registry,
histograms and the train-metrics logger, the host span tracer, the
flight recorder, request traces, the device-time ledger and the health
plane."""

from . import counters, devicetime, flight, health, host_tracer, metrics, trace
from .metrics import Histogram, MetricsLogger

__all__ = ["counters", "devicetime", "flight", "health", "host_tracer",
           "metrics", "trace", "Histogram", "MetricsLogger"]
