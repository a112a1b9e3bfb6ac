"""Goodput/badput ledger: trainer wall clock in named buckets (port of
``paddle_tpu/profiler/goodput.py``).

"Goodput" is the share of wall time the trainer spent on productive
step compute; everything else (the first window, waiting on data,
checkpoint saves, restore and replay after a fault, recovery
bookkeeping, loop scaffolding) is badput with a name.  The ledger is an
exclusive-time profiler: :meth:`GoodputLedger.bucket` context managers
nest, and a child's time is taken out of its parent's, so every
nanosecond of wall clock lands in one bucket and the accounting closes
(``chip_smoke.py``'s ckpt_resume gates ``accounted >= 0.99``).

Buckets (the ``FaultTolerantTrainer`` wiring):

  compile         the first window (on CUDA: the eager priming steps;
                  the capture of the CUDA graph rides the next window)
  step            later windows: the goodput numerator
  data_wait       blocking on the prefetcher for the next batch/window
  ckpt_sync       CheckpointManager.save / the terminal wait
  restore_replay  checkpoint restore and replay to the offset after a
                  fault
  recovery        fault handling around the restore (flight dump, save
                  quiesce)
  idle            loop scaffolding and anything not otherwise attributed

Single writer: the trainer loop is one thread.  ``report()`` only reads
the accumulated dict, so a reader on another thread is at worst one
bucket behind.

Gauges published by :meth:`report`, under the JAX names:
``goodput.fraction``, ``goodput.accounted``, ``goodput.wall_ns``,
``goodput.<bucket>_ns``.  The health plane's ``goodput_accounted``
watchdog reads them.
"""

from __future__ import annotations

import time

from . import counters as _counters

__all__ = ["GoodputLedger", "BUCKETS"]

BUCKETS = ("compile", "step", "data_wait", "ckpt_sync", "restore_replay",
           "recovery", "idle")

# buckets counted as productive (compile is badput: wall time users wait
# through, paid once)
_GOOD = ("step",)


class _Bucket:
    """Exclusive-time context manager (re-usable, not re-entrant)."""

    __slots__ = ("_led", "_name")

    def __init__(self, ledger, name):
        self._led = ledger
        self._name = name

    def __enter__(self):
        now = time.perf_counter_ns()
        led = self._led
        stack = led._stack
        if stack:                      # pause the parent bucket's clock
            pname, t_resume = stack[-1]
            led._ns[pname] = led._ns.get(pname, 0) + (now - t_resume)
            stack[-1] = (pname, now)
        stack.append((self._name, now))
        return self

    def __exit__(self, *exc):
        now = time.perf_counter_ns()
        led = self._led
        name, t_resume = led._stack.pop()
        led._ns[name] = led._ns.get(name, 0) + (now - t_resume)
        if led._stack:                 # resume the parent's clock
            pname, _ = led._stack[-1]
            led._stack[-1] = (pname, now)
        return False


class GoodputLedger:
    """Wall-clock bucket accounting for one training run."""

    def __init__(self):
        self._ns: dict = {}
        self._stack: list = []
        self._t_start = None
        self._t_stop = None

    def start(self):
        """Begin (or restart) the accounting window."""
        self._ns = {}
        self._stack = []
        self._t_start = time.perf_counter_ns()
        self._t_stop = None
        return self

    def stop(self):
        self._t_stop = time.perf_counter_ns()
        return self

    @property
    def started(self):
        return self._t_start is not None

    def bucket(self, name):
        """``with ledger.bucket("step"): ...``; nested buckets accrue
        exclusive time."""
        return _Bucket(self, str(name))

    def add(self, name, ns):
        """Attribute ``ns`` nanoseconds directly."""
        self._ns[str(name)] = self._ns.get(str(name), 0) + int(ns)

    def wall_ns(self):
        if self._t_start is None:
            return 0
        end = self._t_stop if self._t_stop is not None \
            else time.perf_counter_ns()
        return max(0, end - self._t_start)

    def report(self, publish=True):
        """The ledger as a dict: per-bucket ns and seconds, the goodput
        fraction (step / wall) and ``accounted``, the share of wall clock
        attributed to a bucket before unattributed time is folded into
        ``idle`` (so the returned buckets sum to the wall clock)."""
        wall = max(1, self.wall_ns())
        attributed = sum(self._ns.values())
        buckets = {b: int(self._ns.get(b, 0)) for b in BUCKETS}
        for k, v in self._ns.items():          # custom bucket names pass
            if k not in buckets:
                buckets[k] = int(v)
        buckets["idle"] += max(0, wall - attributed)
        good = sum(self._ns.get(b, 0) for b in _GOOD)
        out = {
            "wall_ns": int(wall),
            "wall_s": wall / 1e9,
            "buckets_ns": buckets,
            "buckets_s": {k: v / 1e9 for k, v in buckets.items()},
            "goodput": good / wall,
            "badput": 1.0 - good / wall,
            "accounted": min(1.0, attributed / wall),
        }
        if publish:
            _counters.set_gauge("goodput.fraction", out["goodput"])
            _counters.set_gauge("goodput.accounted", out["accounted"])
            _counters.set_gauge("goodput.wall_ns", out["wall_ns"])
            for k, v in buckets.items():
                _counters.set_gauge(f"goodput.{k}_ns", v)
        return out

    def __repr__(self):
        if not self.started:
            return "GoodputLedger(unstarted)"
        r = self.report(publish=False)
        return (f"GoodputLedger(goodput={r['goodput']:.3f}, "
                f"accounted={r['accounted']:.3f}, "
                f"wall_s={r['wall_s']:.3f})")
