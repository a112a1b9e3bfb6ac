"""Host-side span tracer (port of ``paddle_tpu/profiler/host_tracer.py``).

A span is a wall-clock [begin, end) interval on one thread.  Sites call
``span("serving.step")`` in a ``with`` block; when tracing is off
(``FLAGS_host_trace_level`` is 0 or no collection session is active)
``span`` returns a shared no-op singleton: no allocation, no record, one
integer compare.  When on, completed spans are appended to the session
as ``(name, tid, start_ns, end_ns, depth)``; the nesting depth comes from
a per-thread stack, which is also the span context the flight recorder
reports.

Export: ``to_chrome_trace()`` renders the session as chrome://tracing /
perfetto "X" complete events; ``summary()`` the per-name stats table
(count/total/avg/max/min).
"""

from __future__ import annotations

import json
import os
import threading
import time

from .. import flags as _flags

# _ENABLED[0] is the single hot-path gate: the flag level while a collection
# session is active, 0 otherwise.  Recomputed on session start/stop and on
# FLAGS_host_trace_level changes (flag observer).
_ENABLED = [0]
_LEVEL = [1]
_COLLECTING = [False]
_EVENTS: list[tuple] = []
_THREAD_NAMES: dict[int, str] = {}
_TLS = threading.local()


def _recompute():
    _ENABLED[0] = _LEVEL[0] if _COLLECTING[0] else 0


def _on_level_change(value):
    _LEVEL[0] = int(value)
    _recompute()


_flags.register_flag_observer("FLAGS_host_trace_level", _on_level_change)


def get_level() -> int:
    return _LEVEL[0]


def set_level(level: int):
    _flags.set_flags({"FLAGS_host_trace_level": int(level)})


class _NullSpan:
    """Shared do-nothing context manager — the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "_t0", "_depth")

    def __init__(self, name):
        self.name = name
        self._t0 = 0
        self._depth = 0

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self._depth = len(stack)
        stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _TLS.stack
        if stack and stack[-1] is self.name:
            stack.pop()
        tid = threading.get_ident()
        if tid not in _THREAD_NAMES:
            _THREAD_NAMES[tid] = threading.current_thread().name
        _EVENTS.append((self.name, tid, self._t0, end, self._depth))
        return False


def span(name: str, level: int = 1):
    """Open a trace span; returns the no-op singleton when tracing is off or
    the site's ``level`` exceeds ``FLAGS_host_trace_level``."""
    if _ENABLED[0] < level:
        return _NULL
    return _Span(name)


def enabled(level: int = 1) -> bool:
    return _ENABLED[0] >= level


def current_stack() -> list:
    """Names of the spans currently open on THIS thread, outermost first
    (the context the NaN/Inf guard attaches to its error)."""
    return list(getattr(_TLS, "stack", ()))


# -- collection sessions ----------------------------------------------------
def start():
    """Begin a collection session; drops any previous session's events."""
    _EVENTS.clear()
    _THREAD_NAMES.clear()
    _COLLECTING[0] = True
    _recompute()


def stop() -> list:
    """End the session; returns the collected event tuples."""
    _COLLECTING[0] = False
    _recompute()
    return list(_EVENTS)


def is_collecting() -> bool:
    return _COLLECTING[0]


def events() -> list:
    """Snapshot of the current session's events (live if still collecting)."""
    return list(_EVENTS)


def span_count() -> int:
    return len(_EVENTS)


# -- export -----------------------------------------------------------------
def to_chrome_trace(evts=None, process_name="paddle_tpu_torch") -> dict:
    """Render events as a chrome://tracing trace-event JSON object
    (loadable in chrome://tracing and https://ui.perfetto.dev)."""
    if evts is None:
        evts = events()
    pid = os.getpid()
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name}}]
    for tid, tname in sorted(_THREAD_NAMES.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": tname}})
    for name, tid, t0, t1, depth in evts:
        out.append({"ph": "X", "name": name, "cat": "host", "pid": pid,
                    "tid": tid, "ts": t0 / 1000.0,
                    "dur": max(t1 - t0, 0) / 1000.0,
                    "args": {"depth": depth}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome(path, evts=None):
    trace = to_chrome_trace(evts)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def summary(evts=None, sorted_by="total", time_unit="ms") -> str:
    """Paddle-style aggregate stats table: per span name, call count and
    total/avg/max/min duration (reference: the profiler summary tables)."""
    if evts is None:
        evts = events()
    if not evts:
        return "(no host trace events recorded)"
    div = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}.get(time_unit, 1e6)
    agg: dict[str, list] = {}
    for name, _tid, t0, t1, _d in evts:
        dur = max(t1 - t0, 0)
        st = agg.get(name)
        if st is None:
            agg[name] = [1, dur, dur, dur]
        else:
            st[0] += 1
            st[1] += dur
            st[2] = max(st[2], dur)
            st[3] = min(st[3], dur)
    key = {"total": lambda kv: -kv[1][1], "count": lambda kv: -kv[1][0],
           "max": lambda kv: -kv[1][2], "name": lambda kv: kv[0]}
    rows = sorted(agg.items(), key=key.get(sorted_by, key["total"]))
    wname = max(24, max(len(n) for n in agg) + 2)
    header = (f"{'Name':<{wname}}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
              f"{'Avg(' + time_unit + ')':>12}{'Max(' + time_unit + ')':>12}"
              f"{'Min(' + time_unit + ')':>12}")
    bar = "-" * len(header)
    lines = [bar, "Host Tracer Summary".center(len(header)), bar, header, bar]
    for name, (cnt, tot, mx, mn) in rows:
        lines.append(f"{name:<{wname}}{cnt:>8}{tot / div:>14.3f}"
                     f"{tot / cnt / div:>12.3f}{mx / div:>12.3f}"
                     f"{mn / div:>12.3f}")
    lines.append(bar)
    return "\n".join(lines)
