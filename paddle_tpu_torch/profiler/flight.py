"""Flight recorder: an always-on ring buffer and a fault-triggered
postmortem dump (port of ``paddle_tpu/profiler/flight.py``).

Hot paths append small structured events (request admits and finishes,
pool exhaustion, host-tier moves, migrations, alerts) into a bounded
ring: one GIL-atomic ``deque.append`` an event, no lock on the record
path.  When something dies, :func:`dump` writes a JSON bundle of the
last events with the full counter state, the counters' movement since
start-up (or :func:`clear`), histogram summaries, the active span stack,
the health plane's state and the device-time ledger's top rows.
Triggers: a serving-fleet replica dying (``reason="replica_died"``,
naming the replica and its requests, stall trips included), a health
alert firing (``reason="health_<rule>"``), or an explicit
``flight.dump(reason, {...})``.

Bundles land in ``FLAGS_flight_dir`` (default: a per-process directory
under the temp dir) as ``flight-<reason>-<seq>.json``, a rank above 0 of
a process group as ``flight-<reason>-rank<r>-<seq>.json`` (ranks may
share the directory); :func:`last_dump_path` names the latest.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import tempfile
import threading
import time

from .. import flags as _flags
from . import counters as _counters
from . import host_tracer as _trace

_DEFAULT_CAPACITY = int(_flags.flag("FLAGS_flight_capacity"))

# deque.append is atomic under the GIL — the record() hot path takes no
# lock; only configure/dump/clear serialize on _LOCK
_LOCK = threading.Lock()
_RING: collections.deque = collections.deque(maxlen=_DEFAULT_CAPACITY)
_SEQ = itertools.count()
_LAST_DUMP = [None]
_BASELINE = [_counters.snapshot()]
_DIR_OVERRIDE = [None]
_HEALTH_PROVIDER = [None]


def set_health_provider(fn):
    """Register a callable returning the health plane's JSON-safe state
    (active alerts + last window) to embed into every dump bundle, or
    None when the plane is off.  ``profiler.health`` installs one at
    import; kept as a late-bound hook so flight never imports health
    (no cycle) and dumps stay health-free in processes that never load
    it."""
    _HEALTH_PROVIDER[0] = fn


def configure(directory=None, capacity=None):
    """Set the dump directory and/or ring capacity (keeps current events
    up to the new capacity)."""
    global _RING
    with _LOCK:
        if directory is not None:
            _DIR_OVERRIDE[0] = os.fspath(directory)
        if capacity is not None:
            _RING = collections.deque(_RING, maxlen=int(capacity))


def record(kind, **fields):
    """Append one event to the ring: ``flight.record("jit.dispatch",
    step=12, k=4)``.  Cheap enough for every dispatch/request — one tuple
    build + one atomic deque append."""
    _RING.append((time.time_ns(), kind, fields))


def record_point(name, value, step=None):
    """Metric-point convenience (MetricsLogger harvest feeds this)."""
    _RING.append((time.time_ns(), "metric",
                  {"name": name, "value": value, "step": step}))


def events():
    """Snapshot of the ring, oldest first."""
    return list(_RING)


def clear():
    """Drop all events and re-baseline the counter delta (test isolation)."""
    with _LOCK:
        _RING.clear()
        _BASELINE[0] = _counters.snapshot()
        _LAST_DUMP[0] = None


def dump_dir():
    d = _DIR_OVERRIDE[0] or str(_flags.flag("FLAGS_flight_dir") or "")
    if not d:
        d = os.path.join(tempfile.gettempdir(),
                         f"ptpu-torch-flight-{os.getpid()}")
    return d


def _json_safe(obj):
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def dump(reason, context=None, path=None):
    """Write the postmortem bundle and return its path.

    Bundle schema::

        {"reason": str, "ts": float, "pid": int, "context": {...},
         "spans": [active span names at dump time],
         "counters": {name: value},              # full current snapshot
         "counters_delta": {name: movement},     # since startup / clear()
         "histograms": {name: {count,sum,mean,min,max,p50,p95,p99}},
         "events": [{"ts_ns": int, "kind": str, ...fields}, ...],  # oldest first
         "health": {"admission_level", "alerts", "window"},  # when plane is on
         "devicetime": {"sample_every", "est_total_s",
                        "programs": [top-K ledger rows]}}  # when sampled
    """
    from . import metrics as _metrics
    with _LOCK:
        ring = list(_RING)
        bundle = {
            "reason": str(reason),
            "ts": time.time(),
            "pid": os.getpid(),
            "context": _json_safe(context or {}),
            "spans": _trace.current_stack(),
            "counters": _json_safe(_counters.snapshot()),
            "counters_delta": _json_safe(_counters.delta(_BASELINE[0])),
            "histograms": _json_safe(_metrics.histogram_summaries()),
            "events": [dict(_json_safe(f), ts_ns=ts, kind=kind)
                       for ts, kind, f in ring],
        }
        provider = _HEALTH_PROVIDER[0]
        if provider is not None:
            try:
                hstate = provider()
            except Exception:
                hstate = None
            if hstate is not None:
                bundle["health"] = _json_safe(hstate)
        from . import devicetime as _devicetime
        dt = _devicetime.snapshot(top=8)
        if dt["programs"]:
            bundle["devicetime"] = _json_safe(dt)
        if path is None:
            d = dump_dir()
            os.makedirs(d, exist_ok=True)
            # ranks that share FLAGS_flight_dir: a rank above 0 names its
            # bundles by its rank, rank 0 (and one process) as the JAX
            # recorder does
            r = _rank()
            tag = f"rank{r}-" if r else ""
            path = os.path.join(
                d, f"flight-{_slug(reason)}-{tag}{next(_SEQ):04d}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1)
        _LAST_DUMP[0] = path
        _counters.inc("flight.dumps")
        _counters.inc(f"flight.dumps.{_slug(reason)}")
    return path


def _rank():
    """This process's rank in the default process group, 0 without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _slug(s):
    return "".join(ch if (ch.isalnum() or ch in "-_") else "_"
                   for ch in str(s))[:64]


def last_dump_path():
    """Path of the most recent :func:`dump` in this process (None if no
    fault has triggered one) — the chaos-test assertion hook."""
    return _LAST_DUMP[0]


def load(path):
    """Read one dump bundle back as a dict."""
    with open(path) as f:
        return json.load(f)


def _on_capacity(v):
    try:
        v = int(v)
    except (TypeError, ValueError):
        return
    if v > 0 and v != _RING.maxlen:
        configure(capacity=v)


_flags.register_flag_observer("FLAGS_flight_capacity", _on_capacity)
