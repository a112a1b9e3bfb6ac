"""Per-request tracing (port of ``paddle_tpu/profiler/trace.py``).

Counters and histograms say what the p99s are; a request trace says
where one request's time went.  A :class:`TraceContext` (trace id, an
optional parent span id) is minted at admission — ``ServingFleet.submit``
or, for a standalone engine, ``LLMEngine.add_request`` — and rides the
fleet handle and every engine attempt.  Each hop records a child span:

  admission        router pick and dispatch onto a replica
  queue            bounded-queue wait, enqueue to admission
  kv.reserve       paged block-table reservation (prefix match included)
  cow.adopt        copy-on-write clone of a shared partial block
  prefill          slot-engine prefill (one span a request)
  prefill.chunk    paged chunked prefill (one span a chunk)
  decode.iter      one batched decode step (one span a live request)
  decode.stall     injected ``slow_decode`` stall
  kv.migrate / kv.adopt   the disaggregated hand-off
  redispatch       re-prefill after a replica death, same trace id
  evict            terminal transition, tagged with the finish reason

Sampling is head and tail: ``FLAGS_request_trace_sample`` is the head
probability (0 turns tracing off: ``new_trace`` returns None and every
site checks for None, so no counter moves).  With sampling on every
request records; at finish the trace is kept if head-sampled or if the
request breached its deadline, finished as an error or was retried
(tail keep-always).

Export: :func:`export_jsonl` (one span tree a line) and
:func:`to_chrome_trace` / :func:`export_chrome`, which merge the kept
traces with the host tracer's spans on the same ``perf_counter_ns``
clock.  Counters: ``trace.started / finished / kept / kept.head /
kept.tail / dropped / spans``.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
from collections import OrderedDict

from .. import flags as _flags
from . import counters as _counters
from . import host_tracer as _host

__all__ = [
    "TraceContext", "enabled", "sample_rate", "new_trace", "finish",
    "get_trace", "kept", "kept_ids", "clear", "export_jsonl",
    "to_chrome_trace", "export_chrome", "stage_breakdown", "STAGES",
]

# cached flag value: the ONE hot-path gate (flag observer keeps it fresh)
_SAMPLE = [0.0]
_KEEP_MAX = [256]          # kept-trace ring bound
_MAX_SPANS = 4096          # per-trace span cap (decode.iter is per token)

_LOCK = threading.Lock()
_KEPT: "OrderedDict[str, TraceContext]" = OrderedDict()
_TRACE_SEQ = itertools.count(1)

# finish reasons that force tail retention regardless of head sampling
TAIL_REASONS = frozenset({"deadline", "error", "retried"})

# span names whose durations make up a request's stage accounting
# (queue + prefill work + decode work ≈ TTFT + decode wall time)
STAGES = {
    "queue": ("queue",),
    "prefill": ("prefill", "prefill.chunk", "kv.reserve", "cow.adopt"),
    "decode": ("decode.iter", "decode.stall"),
}
_STAGE_OF = {n: s for s, names in STAGES.items() for n in names}


def enabled() -> bool:
    """True when request tracing is on (``FLAGS_request_trace_sample > 0``)."""
    return _SAMPLE[0] > 0.0


def sample_rate() -> float:
    return _SAMPLE[0]


class _CtxSpan:
    """Context manager recording one timed span into a TraceContext."""

    __slots__ = ("_ctx", "_name", "_parent", "_extra", "_t0")

    def __init__(self, ctx, name, parent, extra):
        self._ctx = ctx
        self._name = name
        self._parent = parent
        self._extra = extra
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._ctx.add_span(self._name, self._t0, time.perf_counter_ns(),
                           parent=self._parent, **(self._extra or {}))
        return False


class TraceContext:
    """One request's trace: identity + a flat span list forming a tree.

    Span records are ``(span_id, parent_id, name, t0_ns, t1_ns, extra)``
    tuples appended to a plain list — ``list.append`` is atomic under the
    GIL, so concurrent recorders (fleet submit thread, replica worker
    threads, the monitor) need no lock on the record path.  Span ids come
    from a per-trace ``itertools.count`` (also GIL-atomic).  ``parent_id``
    0 is the implicit root (the request's lifetime span); the clock is
    ``time.perf_counter_ns`` — the host tracer's clock, so merged chrome
    exports line up.
    """

    __slots__ = ("trace_id", "rid", "parent_span_id", "head_sampled",
                 "status", "keep_reason", "start_ns", "end_ns", "spans",
                 "dropped_spans", "finished", "_seq", "_marks")

    def __init__(self, trace_id, rid, head_sampled, parent_span_id=None):
        self.trace_id = trace_id
        self.rid = rid
        self.parent_span_id = parent_span_id
        self.head_sampled = bool(head_sampled)
        self.status = None          # finish_reason at finalize
        self.keep_reason = None     # "head" | "tail:<why>" | None (dropped)
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None
        self.spans: list = []       # (sid, parent, name, t0, t1, extra)
        self.dropped_spans = 0
        self.finished = False
        self._seq = itertools.count(1)
        self._marks: dict = {}      # stamp name -> perf_counter_ns

    # -- recording -----------------------------------------------------------
    def add_span(self, name, t0_ns, t1_ns, parent=0, **extra):
        """Record one completed span; returns its span id (None when the
        trace is finished or at the span cap)."""
        if self.finished:
            return None
        if len(self.spans) >= _MAX_SPANS:
            self.dropped_spans += 1
            return None
        sid = next(self._seq)
        self.spans.append((sid, parent, name, int(t0_ns), int(t1_ns),
                           extra or None))
        return sid

    def add_event(self, name, **extra):
        """Zero-duration marker span (evict reasons, replica deaths)."""
        now = time.perf_counter_ns()
        return self.add_span(name, now, now, **extra)

    def span(self, name, parent=0, **extra):
        """``with ctx.span("prefill", bucket=64): ...`` timed recording."""
        return _CtxSpan(self, name, parent, extra)

    def stamp(self, name):
        """Remember 'now' under ``name`` for a later :meth:`span_from`."""
        self._marks[name] = time.perf_counter_ns()

    def span_from(self, mark, name, **extra):
        """Record a span from a previous :meth:`stamp` to now (falls back
        to the trace start when the stamp is missing)."""
        t0 = self._marks.pop(mark, None)
        if t0 is None:
            t0 = self.start_ns
        return self.add_span(name, t0, time.perf_counter_ns(), **extra)

    # -- accounting / export -------------------------------------------------
    def wall_ns(self):
        end = self.end_ns if self.end_ns is not None \
            else time.perf_counter_ns()
        return max(0, end - self.start_ns)

    def stage_ns(self):
        """``{stage: summed ns}`` over the stage spans (queue / prefill /
        decode) — the per-request 'where did the time go' split."""
        out = {s: 0 for s in STAGES}
        for _sid, _p, name, t0, t1, _x in self.spans:
            s = _STAGE_OF.get(name)
            if s is not None:
                out[s] += max(0, t1 - t0)
        return out

    def to_dict(self):
        """JSON-safe span tree: flat span list + nested tree under an
        implicit root covering the request lifetime."""
        spans = sorted(self.spans, key=lambda s: (s[3], s[0]))
        flat, nodes = [], {}
        for sid, parent, name, t0, t1, extra in spans:
            rec = {"span_id": sid, "parent_id": parent, "name": name,
                   "t0_ns": t0, "dur_ns": max(0, t1 - t0)}
            if extra:
                rec.update(extra)
            flat.append(rec)
            nodes[sid] = {"name": name, "span_id": sid, "t0_ns": t0,
                          "dur_ns": max(0, t1 - t0),
                          "extra": dict(extra) if extra else {},
                          "children": []}
        root = {"name": f"request[rid={self.rid}]", "span_id": 0,
                "t0_ns": self.start_ns, "dur_ns": self.wall_ns(),
                "extra": {}, "children": []}
        for sid, parent, _n, _t0, _t1, _x in spans:
            (nodes.get(parent, root))["children"].append(nodes[sid])
        stages = self.stage_ns()
        return {"trace_id": self.trace_id, "rid": self.rid,
                "parent_span_id": self.parent_span_id,
                "status": self.status, "keep_reason": self.keep_reason,
                "head_sampled": self.head_sampled,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "wall_ns": self.wall_ns(),
                "stage_ns": stages,
                "dropped_spans": self.dropped_spans,
                "spans": flat, "tree": root}

    def __repr__(self):
        return (f"TraceContext({self.trace_id}, rid={self.rid}, "
                f"spans={len(self.spans)}, status={self.status!r}, "
                f"keep={self.keep_reason!r})")


# -- lifecycle ---------------------------------------------------------------
def new_trace(rid, parent_span_id=None, trace_id=None):
    """Mint a trace for request ``rid`` — or None when sampling is off
    (the zero-overhead fast path: callers gate every record site on the
    returned context being non-None)."""
    s = _SAMPLE[0]
    if s <= 0.0:
        return None
    head = s >= 1.0 or random.random() < s
    if trace_id is None:
        trace_id = f"t{next(_TRACE_SEQ):05d}-r{rid}"
    ctx = TraceContext(trace_id, rid, head, parent_span_id)
    _counters.inc("trace.started")
    return ctx


def finish(ctx, reason, breached=False, retried=False):
    """Finalize a trace: decide retention (head sample OR tail keep-always
    on deadline/SLO breach, error, or retry) and publish kept traces to
    the bounded registry.  Idempotent per trace; returns
    True when the trace was kept."""
    if ctx is None or ctx.finished:
        return False
    ctx.end_ns = time.perf_counter_ns()
    ctx.status = str(reason)
    tail = bool(breached) or bool(retried) or (str(reason) in TAIL_REASONS)
    keep = ctx.head_sampled or tail
    if tail:
        why = str(reason) if str(reason) in TAIL_REASONS else (
            "breach" if breached else "retried")
        ctx.keep_reason = f"tail:{why}"
    elif keep:
        ctx.keep_reason = "head"
    ctx.finished = True
    _counters.inc("trace.finished")
    _counters.inc("trace.spans", len(ctx.spans))
    if keep:
        _counters.inc("trace.kept")
        _counters.inc("trace.kept.tail" if tail else "trace.kept.head")
        with _LOCK:
            _KEPT[ctx.trace_id] = ctx
            while len(_KEPT) > _KEEP_MAX[0]:
                _KEPT.popitem(last=False)
    else:
        _counters.inc("trace.dropped")
    return keep


# -- registry ----------------------------------------------------------------
def kept():
    """Kept TraceContexts, oldest first (bounded ring of the last N)."""
    with _LOCK:
        return list(_KEPT.values())


def kept_ids():
    with _LOCK:
        return list(_KEPT)


def get_trace(trace_id):
    """The kept trace's span-tree dict, or None."""
    with _LOCK:
        ctx = _KEPT.get(trace_id)
    return None if ctx is None else ctx.to_dict()


def clear():
    """Drop every kept trace (test isolation)."""
    with _LOCK:
        _KEPT.clear()


def set_keep_max(n):
    """Resize the kept-trace ring."""
    with _LOCK:
        _KEEP_MAX[0] = max(1, int(n))
        while len(_KEPT) > _KEEP_MAX[0]:
            _KEPT.popitem(last=False)


# -- export ------------------------------------------------------------------
def export_jsonl(path, traces=None):
    """Write one JSON span-tree per line; returns the path."""
    if traces is None:
        traces = kept()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for ctx in traces:
            f.write(json.dumps(ctx.to_dict() if isinstance(ctx, TraceContext)
                               else ctx) + "\n")
    return path


def to_chrome_trace(traces=None, host_events=None,
                    process_name="paddle_tpu_torch"):
    """Chrome trace-event JSON merging the host tracer's spans with the
    kept request traces — same process, same ``perf_counter_ns`` clock,
    one synthetic named lane per request trace."""
    trace = _host.to_chrome_trace(host_events, process_name=process_name)
    evs = trace["traceEvents"]
    pid = os.getpid()
    if traces is None:
        traces = kept()
    for i, ctx in enumerate(traces):
        tid = 1_000_000 + i   # synthetic lane, clear of real thread ids
        evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid,
                    "args": {"name": f"request {ctx.trace_id} "
                                     f"[{ctx.status}]"}})
        evs.append({"ph": "X", "name": f"request[rid={ctx.rid}]",
                    "cat": "request", "pid": pid, "tid": tid,
                    "ts": ctx.start_ns / 1000.0,
                    "dur": ctx.wall_ns() / 1000.0,
                    "args": {"trace_id": ctx.trace_id,
                             "keep": ctx.keep_reason}})
        for sid, parent, name, t0, t1, extra in ctx.spans:
            evs.append({"ph": "X", "name": name, "cat": "request",
                        "pid": pid, "tid": tid, "ts": t0 / 1000.0,
                        "dur": max(t1 - t0, 0) / 1000.0,
                        "args": dict(extra or {}, span_id=sid,
                                     parent_id=parent)})
    return trace


def export_chrome(path, traces=None, host_events=None):
    obj = to_chrome_trace(traces, host_events)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def stage_breakdown(traces=None):
    """Aggregate queue/prefill/decode shares and percentiles over traces
    (the "which hop ate the p99" view ``Router.observability_summary``
    reports).  Returns ``{"requests": N, "<stage>": {"share", "p50_ms",
    "p99_ms", "max_ms"}}``."""
    if traces is None:
        traces = kept()
    per_stage = {s: [] for s in STAGES}
    for ctx in traces:
        st = ctx.stage_ns() if isinstance(ctx, TraceContext) \
            else ctx.get("stage_ns", {})
        for s in per_stage:
            per_stage[s].append(st.get(s, 0))
    n = len(traces)
    out = {"requests": n}
    total = sum(sum(v) for v in per_stage.values()) or 1
    for s, vals in per_stage.items():
        vals = sorted(vals)
        if not vals:
            out[s] = {"share": 0.0, "p50_ms": 0.0, "p99_ms": 0.0,
                      "max_ms": 0.0}
            continue
        pick = lambda q: vals[min(len(vals) - 1, int(q * len(vals)))]
        out[s] = {"share": sum(vals) / total,
                  "p50_ms": pick(0.50) / 1e6,
                  "p99_ms": pick(0.99) / 1e6,
                  "max_ms": vals[-1] / 1e6}
    return out


# -- flag --------------------------------------------------------------------
def _on_sample(v):
    try:
        _SAMPLE[0] = max(0.0, float(v))
    except (TypeError, ValueError):
        _SAMPLE[0] = 0.0


_flags.register_flag_observer("FLAGS_request_trace_sample", _on_sample,
                              call_now=True)
