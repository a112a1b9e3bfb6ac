"""Observability for the port: the process-global counter registry."""

from . import counters

__all__ = ["counters"]
