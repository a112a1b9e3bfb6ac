"""Distributed utilities (port of ``paddle_tpu/distributed/utils``;
reference: fleet/utils/ — log_util, timer_helper).  The logger and the
host-clock timers; tensor fusion is ``jit.mesh``'s one all-reduce a
parameter."""

from __future__ import annotations

import logging
import time

logger = logging.getLogger("paddle_tpu_torch.distributed")


def get_logger(level="INFO", name="paddle_tpu_torch.distributed"):
    log = logging.getLogger(name)
    log.setLevel(level)
    return log


class _Timer:
    def __init__(self, name):
        self.name = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = 0.0

    def start(self):
        self.start_time = time.time()
        self.started_ = True

    def stop(self):
        self.elapsed_ += time.time() - self.start_time
        self.started_ = False

    def reset(self):
        self.elapsed_ = 0.0
        self.started_ = False

    def elapsed(self, reset=True):
        e = self.elapsed_ + (time.time() - self.start_time
                             if self.started_ else 0.0)
        if reset:
            self.reset()
        return e


class TimerHub:
    """Named host-clock timers (``timer_helper``): a timer measures what
    the host spent between ``start`` and ``stop``; kernels still queued
    on the card are not waited for."""

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        return self.timers.setdefault(name, _Timer(name))

    def log(self, names=None, normalizer=1.0, reset=True):
        names = names or list(self.timers)
        parts = [f"{n}: {self.timers[n].elapsed(reset) * 1000 / normalizer:.2f}ms"
                 for n in names if n in self.timers]
        logger.info(" | ".join(parts))


_TIMERS = TimerHub()


def get_timers():
    return _TIMERS


__all__ = ["TimerHub", "get_logger", "get_timers", "logger"]
