"""Device-time ledger (port of the sampling ledger of
``paddle_tpu/profiler/devicetime.py``).

Every dispatch site of the serving engines (slot prefill and decode,
paged prefill chunks and decode, the copy-on-write block copy, host-tier
spill and restore, migration adopt, the speculative draft and verify
passes) calls :func:`note` with its program name just before it launches
and :func:`observe` with the token and the outputs just after:

* ``FLAGS_device_time_sample=0`` (the default): ``note`` is one cached
  list read and returns ``None``; no counter moves, no sync happens.
* ``FLAGS_device_time_sample=N``: every note counts its dispatch in the
  ledger (``jit.devicetime.dispatches``) and every Nth, globally, returns
  a token; ``observe`` then pays ONE fence — an event recorded on the
  current CUDA stream and waited on (nothing for CPU tensors) — ticks
  ``jit.devicetime.sampled_syncs`` (exactly ``ceil(dispatches / N)`` over
  a window started by :func:`reset`), and records the fenced wall time
  into the program's row and log2 histogram.

The fenced time is host wall time from just before the dispatch to the
device's completion: with one program in flight (the engines' loops read
their results back each step) it is the program's device time plus a
constant host overhead, an attribution weight rather than an isolated
kernel time.

Read side: :func:`snapshot` (per-program dispatches, samples, mean /
p50 / p95 ms, estimated total seconds, share, trailing-window regression
ratio; ``ServingFleet.stats()["devicetime"]``, the flight recorder and
the health plane's ``device_time_regression`` watchdog read it) and
:func:`summary` (a text table).  The efficiency join (achieved TFLOP/s,
MFU, HBM GB/s and the roofline class from per-program FLOPs and bytes)
and the on-demand profiler capture are not ported yet: they raise
``NotImplementedError`` naming ROADMAP.md A9.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

from .. import flags as _flags
from . import counters as _counters
from . import metrics as _metrics

_LOCK = threading.Lock()
_LEDGER: dict[str, dict] = {}
_SAMPLE = [0]          # observer-cached FLAGS_device_time_sample (hot read)
_SEQ = itertools.count()   # global dispatch sequence: every Nth is sampled
_RECENT = 8            # trailing per-program samples kept for regression ratio

_COUNTER_DISPATCHES = "jit.devicetime.dispatches"
_COUNTER_SAMPLED = "jit.devicetime.sampled_syncs"

_A9 = "is not ported to paddle_tpu_torch yet: ROADMAP.md A9"


class _Token:
    """One armed sample: the program name and the pre-dispatch time, from
    :func:`note` to :func:`observe`."""

    __slots__ = ("name", "t0")

    def __init__(self, name, t0):
        self.name = name
        self.t0 = t0


def enabled() -> bool:
    """True when sampling is on (``FLAGS_device_time_sample > 0``)."""
    return _SAMPLE[0] > 0


def sample_every() -> int:
    return _SAMPLE[0]


def _row(name):
    rec = _LEDGER.get(name)
    if rec is None:
        rec = _LEDGER[name] = {
            "dispatches": 0, "sampled": 0, "time_s": 0.0, "recent": [],
            "hist": _metrics.Histogram(f"devicetime.{name}", "ns")}
    return rec


def note(name):
    """Note one dispatch of program ``name``; returns a token for every
    Nth note while sampling is on, else None.  Call it just before the
    dispatch."""
    n = _SAMPLE[0]
    if n <= 0:
        return None
    _counters.inc(_COUNTER_DISPATCHES)
    with _LOCK:
        _row(name)["dispatches"] += 1
        armed = next(_SEQ) % n == 0
    if not armed:
        return None
    return _Token(name, time.perf_counter())


def observe(token, out=None):
    """Complete a sample armed by :func:`note`: fence on ``out`` (a
    tensor or a tuple/list/dict of them; None fences nothing) and record
    the elapsed time against the token's program.  A None token is a
    no-op, so sites call ``observe(note(..), out)`` unconditionally."""
    if token is None:
        return None
    _fence(out)
    dt = time.perf_counter() - token.t0
    _record_sample(token.name, dt)
    return dt


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def _fence(out):
    """The one sync a sample pays: an event recorded on the current
    stream of the outputs' CUDA device, waited on."""
    for t in _tensors(out):
        if t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            ev.synchronize()
            return


def _record_sample(name, dt_s):
    """Fold one fenced sample into the ledger (also the test seam: feeds
    the ledger without a dispatch)."""
    _counters.inc(_COUNTER_SAMPLED)
    with _LOCK:
        rec = _row(name)
        rec["sampled"] += 1
        rec["time_s"] += dt_s
        rec["recent"].append(dt_s)
        if len(rec["recent"]) > _RECENT:
            del rec["recent"][:len(rec["recent"]) - _RECENT]
        rec["hist"].record(dt_s * 1e9)


def _regression(rec, recent):
    """Trailing-window mean over the pre-window baseline mean (None until
    both windows hold samples): the device_time_regression signal."""
    n_recent = len(recent)
    n_base = rec["sampled"] - n_recent
    if n_recent == 0 or n_base <= 0:
        return None
    recent_sum = sum(recent)
    base_sum = rec["time_s"] - recent_sum
    if base_sum <= 0:
        return None
    return (recent_sum / n_recent) / (base_sum / n_base)


def snapshot(top=None):
    """Per-program rows sorted by estimated total time (mean sampled time
    x dispatches), largest first; ``top`` keeps the K largest."""
    with _LOCK:
        items = [(name, dict(rec), rec["hist"].copy(), list(rec["recent"]))
                 for name, rec in _LEDGER.items()]
    rows = []
    for name, rec, hist, recent in items:
        sampled = rec["sampled"]
        mean_s = (rec["time_s"] / sampled) if sampled else None
        # a sampled row had at least `sampled` dispatches (the floor
        # matters when the ledger is fed through the _record_sample seam)
        disp = max(rec["dispatches"], sampled)
        rows.append({
            "name": name, "dispatches": rec["dispatches"],
            "sampled": sampled,
            "mean_ms": mean_s * 1e3 if mean_s is not None else None,
            "p50_ms": hist.percentile(50) / 1e6 if sampled else None,
            "p95_ms": hist.percentile(95) / 1e6 if sampled else None,
            "est_total_s": mean_s * disp if mean_s is not None else 0.0,
            "regression": _regression(rec, recent)})
    rows.sort(key=lambda r: r["est_total_s"], reverse=True)
    total = sum(r["est_total_s"] for r in rows)
    for r in rows:
        r["share"] = (r["est_total_s"] / total) if total > 0 else None
    if top is not None:
        rows = rows[:top]
    return {"sample_every": _SAMPLE[0], "n_programs": len(items),
            "est_total_s": total, "programs": rows}


def summary(top=None) -> str:
    """The ledger as a text table."""
    snap = snapshot(top=top)
    if not snap["programs"]:
        return ("(no device-time samples recorded: set "
                "FLAGS_device_time_sample=N and dispatch)")

    def f(v, spec="{:.3f}"):
        return spec.format(v) if v is not None else "-"

    headers = ("Program", "Disp", "Samp", "Mean(ms)", "P95(ms)", "Share",
               "Regression")
    rows = [(r["name"], str(r["dispatches"]), str(r["sampled"]),
             f(r["mean_ms"]), f(r["p95_ms"]), f(r["share"], "{:.1%}"),
             f(r["regression"], "{:.2f}"))
            for r in snap["programs"]]
    widths = [max(len(h), *(len(row[i]) for row in rows))
              for i, h in enumerate(headers)]
    fmt = "  ".join("{:<%d}" % w for w in widths)
    lines = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    lines.extend(fmt.format(*row) for row in rows)
    lines.append(f"sample_every={snap['sample_every']}  "
                 f"est_total={snap['est_total_s']:.3f}s  "
                 f"programs={snap['n_programs']}")
    return "\n".join(lines)


def reset():
    """Drop the ledger and re-anchor the sampling sequence (the next note
    is sample #0).  Counters are not touched."""
    global _SEQ
    with _LOCK:
        _LEDGER.clear()
        _SEQ = itertools.count()


def efficiency(name):
    """Achieved TFLOP/s, MFU, HBM GB/s and roofline class of one program
    (needs per-program FLOPs and bytes)."""
    raise NotImplementedError(f"devicetime.efficiency {_A9}")


def capture_profile(ms, out_dir=None):
    """An on-demand profiler capture window."""
    raise NotImplementedError(f"devicetime.capture_profile {_A9}")


def _on_sample_flag(v):
    try:
        n = int(v)
    except (TypeError, ValueError):
        n = 0
    # cache only: reset() alone clears the ledger, so turning sampling
    # off to read the results keeps them
    _SAMPLE[0] = max(0, n)


_flags.register_flag_observer("FLAGS_device_time_sample", _on_sample_flag,
                              call_now=True)
