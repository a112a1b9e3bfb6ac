"""Histograms and structured train metrics (port of
``paddle_tpu/profiler/metrics.py``).

* :class:`Histogram` — fixed log2-bucket histogram, mergeable across
  threads and replicas (one bucket layout everywhere), exact
  count/sum/min/max, nearest-rank percentiles at the bucket's geometric
  midpoint clamped to [min, max].  The process-global registry
  (:func:`observe`, :func:`get_histogram`, :func:`histograms`) holds the
  serving latency and occupancy distributions (``serving.ttft_ns``,
  ``serving.itl_ns``, ``serving.queue_wait_ns``, ...); each engine keeps
  its own copies too, which the fleet's Router merges.
* :class:`MetricsLogger` — one JSONL line a train step and an in-memory
  series per metric.

Prometheus output and per-program device statistics are not ported
yet (ROADMAP.md A9)."""

from __future__ import annotations

import json
import math
import os
import threading
import time

from . import counters as _counters

# one shared bucket layout so ANY two histograms merge: bucket i holds
# values in [2**(i - _OFFSET), 2**(i - _OFFSET + 1)); i=0 also absorbs
# zero, negative and underflowing values
_NBUCKETS = 100
_OFFSET = 36  # bucket 0's lower bound 2**-36: sub-ns .. 2**64 ns


def _bucket_index(value):
    if value <= 0.0:
        return 0
    # frexp: value = m * 2**e with 0.5 <= m < 1, so floor(log2(v)) == e - 1
    _, e = math.frexp(value)
    i = e - 1 + _OFFSET
    if i < 0:
        return 0
    if i >= _NBUCKETS:
        return _NBUCKETS - 1
    return i


def _bucket_bounds(i):
    return 2.0 ** (i - _OFFSET), 2.0 ** (i - _OFFSET + 1)


class Histogram:
    """Fixed log2-bucket histogram: O(1) record, mergeable, percentiles.

    Every instance shares one bucket layout, so histograms recorded by
    different engine replicas merge by element-wise addition.
    ``count/sum/min/max`` are exact; percentiles carry the bucket's <= 2x
    relative error, clamped to the observed [min, max] (a single-value
    histogram reports exact percentiles)."""

    __slots__ = ("name", "unit", "_lock", "_buckets", "count", "sum",
                 "min", "max")

    def __init__(self, name="", unit=""):
        self.name = name
        self.unit = unit
        self._lock = threading.Lock()
        self._buckets = [0] * _NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value):
        value = float(value)
        i = _bucket_index(value)
        with self._lock:
            self._buckets[i] += 1
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value

    def merge(self, other):
        """In-place element-wise merge of ``other`` into ``self``."""
        with other._lock:
            ob = list(other._buckets)
            oc, osum, omin, omax = (other.count, other.sum, other.min,
                                    other.max)
        with self._lock:
            for i, n in enumerate(ob):
                self._buckets[i] += n
            self.count += oc
            self.sum += osum
            if omin < self.min:
                self.min = omin
            if omax > self.max:
                self.max = omax
        return self

    def copy(self):
        out = Histogram(self.name, self.unit)
        out.merge(self)
        return out

    def delta(self, prev):
        """The samples recorded since ``prev`` (an earlier copy of this
        histogram) as a fresh histogram: the health plane's windowed
        percentile, ``cur.delta(prev).percentile(95)``.  If ``prev`` is
        not a prefix of ``self`` (a reset ran between them) the whole
        current state is returned.  The window's min/max are the bounds
        of its outermost non-empty buckets (exact ones are not
        recoverable from bucket counts)."""
        if prev is self:
            return Histogram(self.name, self.unit)
        with prev._lock:
            pb = list(prev._buckets)
            pc, psum = prev.count, prev.sum
        with self._lock:
            cb = list(self._buckets)
            cc, csum = self.count, self.sum
        if cc < pc or any(c < p for c, p in zip(cb, pb)):
            pb = [0] * _NBUCKETS       # reset between the two: from zero
            pc, psum = 0, 0.0
        out = Histogram(self.name, self.unit)
        out._buckets = [c - p for c, p in zip(cb, pb)]
        out.count = cc - pc
        out.sum = csum - psum
        for i, n in enumerate(out._buckets):
            if n:
                lo, hi = _bucket_bounds(i)
                out.min = min(out.min, lo)
                out.max = max(out.max, hi)
        if out.count:
            out.min = max(out.min, 0.0)
        return out

    def percentile(self, q):
        """Nearest-rank percentile from the bucket counts (0 when empty);
        ``q`` in [0, 100]."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = max(1, math.ceil((q / 100.0) * self.count))
            cum = 0
            for i, n in enumerate(self._buckets):
                cum += n
                if cum >= rank:
                    lo, hi = _bucket_bounds(i)
                    # geometric bucket midpoint, clamped to the range seen
                    mid = math.sqrt(lo * hi) if lo > 0 else 0.0
                    return min(max(mid, self.min), self.max)
            return self.max

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def summary(self):
        """``{count, sum, mean, min, max, p50, p95, p99}``."""
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}

    def to_dict(self):
        """JSON-safe form (sparse buckets)."""
        with self._lock:
            return {"name": self.name, "unit": self.unit,
                    "count": self.count, "sum": self.sum,
                    "min": self.min if self.count else None,
                    "max": self.max if self.count else None,
                    "buckets": {str(i): n for i, n in
                                enumerate(self._buckets) if n}}

    @classmethod
    def from_dict(cls, d):
        out = cls(d.get("name", ""), d.get("unit", ""))
        for i, n in d.get("buckets", {}).items():
            out._buckets[int(i)] = int(n)
        out.count = int(d.get("count", 0))
        out.sum = float(d.get("sum", 0.0))
        if out.count:
            out.min = float(d["min"])
            out.max = float(d["max"])
        return out


# -- the process-global histogram registry ----------------------------------
_HLOCK = threading.Lock()
_HISTS: dict[str, Histogram] = {}


def get_histogram(name: str, unit: str = "") -> Histogram:
    """The process-global histogram ``name`` (created on first use)."""
    with _HLOCK:
        h = _HISTS.get(name)
        if h is None:
            h = _HISTS[name] = Histogram(name, unit)
        return h


def observe(name: str, value, unit: str = "", sum_counter=False,
            extra: Histogram | None = None):
    """Record ``value`` into the global histogram ``name``;
    ``sum_counter=True`` also adds it to the plain counter of the same
    name (a string: to that counter), ``extra`` also records it into a
    caller-scoped histogram (an engine's own, which the Router merges)."""
    get_histogram(name, unit).record(value)
    if extra is not None:
        extra.record(value)
    if sum_counter:
        _counters.inc(name if sum_counter is True else sum_counter, value)


def histograms() -> dict:
    """Point-in-time copies of every registered histogram."""
    with _HLOCK:
        items = list(_HISTS.items())
    return {k: h.copy() for k, h in items}


def histogram_summaries() -> dict:
    """``{name: summary}`` for every non-empty registered histogram."""
    return {k: h.summary() for k, h in histograms().items() if h.count}


def reset_metrics():
    """Drop every registered histogram and the device-time ledger (test
    isolation)."""
    with _HLOCK:
        _HISTS.clear()
    from . import devicetime   # devicetime imports this module
    devicetime.reset()


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


__all__ = ["Histogram", "MetricsLogger", "get_histogram", "histograms",
           "histogram_summaries", "observe", "reset_metrics"]
