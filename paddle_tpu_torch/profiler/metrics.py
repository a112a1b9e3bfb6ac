"""Structured train metrics (port of ``MetricsLogger`` from
``paddle_tpu/profiler/metrics.py``): one JSONL line a step and an
in-memory series per metric.  The histograms, Prometheus output and
program statistics of the JAX module are not ported yet (ROADMAP.md
A9)."""

from __future__ import annotations

import json
import os
import threading
import time


class MetricsLogger:
    """Structured JSONL time-series + in-memory query API.

    One :meth:`log` call is one JSONL line::

        {"ts": <unix-seconds>, "step": <int>, "<metric>": <float>, ...}

    plus one in-memory ``(step, value)`` point per metric, queryable with
    :meth:`series`/:meth:`latest`.  ``path=None`` keeps the series
    memory-only.  Thread-safe; writes are line-buffered appends (a crash
    keeps every completed line).  Wire it into the train loop with
    ``jit.CompiledTrainStep(model, loss_fn, opt, metrics=logger)``: the
    step keeps its scalars on the device and hands them to the logger
    only at ``metrics_flush()`` or ``sync()``."""

    def __init__(self, path=None, run=None):
        self.path = os.fspath(path) if path is not None else None
        self.run = run
        self._lock = threading.Lock()
        self._series: dict[str, list] = {}
        self._fh = None
        if self.path is not None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)

    def log(self, step=None, **metrics):
        """Record one time point: ``logger.log(step=3, loss=2.17, lr=1e-4)``."""
        rec = {"ts": time.time()}
        if self.run is not None:
            rec["run"] = self.run
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            if v is None:
                continue
            rec[k] = float(v)
        with self._lock:
            for k, v in rec.items():
                if k in ("ts", "run", "step"):
                    continue
                self._series.setdefault(k, []).append((rec.get("step"), v))
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
        return rec

    def series(self, name):
        """All recorded ``(step, value)`` points for one metric, in order."""
        with self._lock:
            return list(self._series.get(name, ()))

    def latest(self, name, default=None):
        with self._lock:
            pts = self._series.get(name)
            return pts[-1][1] if pts else default

    def names(self):
        with self._lock:
            return sorted(self._series)

    def summary(self):
        """``{metric: {count, last, mean, min, max}}`` over the series."""
        with self._lock:
            items = {k: [v for _, v in pts]
                     for k, pts in self._series.items()}
        return {k: {"count": len(vs), "last": vs[-1],
                    "mean": sum(vs) / len(vs), "min": min(vs),
                    "max": max(vs)}
                for k, vs in items.items() if vs}

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["MetricsLogger"]
