"""The PyTorch port's telemetry plane against the JAX package's.

Histograms, the flight recorder, request traces, the host tracer and the
device-time ledger are pure Python in both packages; the port keeps its
own copies (``paddle_tpu_torch.profiler``).  Each test feeds both the same
inputs, made from a seed with numpy (or drawn by hypothesis), and wants
the same outputs:

* ``Histogram`` bucket indices, percentiles, ``summary``, ``merge`` and
  ``delta`` equal JAX's value for value (exact float equality: the same
  arithmetic in the same order);
* flight rings, dumps and capacity, trace retention (head and tail),
  span trees, ``stage_breakdown`` and the exports, the host tracer's
  sessions and the device-time ledger's sampling budget
  (``jit.devicetime.sampled_syncs == ceil(dispatches / N)``) behave as
  JAX's, compared exactly;
* the locked launch-counter helper the kernel wrappers share counts
  every launch from 8 threads exactly.
"""

import json
import math
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.core import flags as jflags
from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.profiler import devicetime as jdevicetime
from paddle_tpu.profiler import flight as jflight
from paddle_tpu.profiler import host_tracer as jhost
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.profiler import trace as jtrace
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.kernels import count_launch
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.profiler import devicetime as tdevicetime
from paddle_tpu_torch.profiler import flight as tflight
from paddle_tpu_torch.profiler import host_tracer as thost
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.profiler import trace as ttrace

SIDES = {"jax": (jflags, jcounters, jmetrics, jflight, jtrace, jhost,
                 jdevicetime),
         "torch": (tflags, tcounters, tmetrics, tflight, ttrace, thost,
                   tdevicetime)}


def _samples(seed, n=200):
    """Latency-like samples over 8 decades, with zeros and negatives."""
    rng = np.random.default_rng(seed)
    v = 10.0 ** rng.uniform(-3, 9, n)
    v[::17] = 0.0
    v[5::23] = -1.0
    return v.tolist()


def _hist(metrics, values, name="h"):
    h = metrics.Histogram(name, "ns")
    for v in values:
        h.record(v)
    return h


# -- histograms --------------------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(st.floats(min_value=-1e30, max_value=1e30, allow_nan=False))
def test_bucket_index_equals_jax(v):
    assert tmetrics._bucket_index(v) == jmetrics._bucket_index(v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentiles_summary_and_dict_equal_jax(seed):
    values = _samples(seed)
    j, t = _hist(jmetrics, values), _hist(tmetrics, values)
    assert t._buckets == j._buckets
    assert t.summary() == j.summary()
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert t.percentile(q) == j.percentile(q)
    assert t.to_dict() == j.to_dict()
    back = tmetrics.Histogram.from_dict(j.to_dict())
    assert back.summary() == j.summary()


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(min_value=0.0, max_value=1e12), max_size=40),
       st.lists(st.floats(min_value=0.0, max_value=1e12), max_size=40))
def test_merge_and_delta_equal_jax(a, b):
    out = {}
    for name, (_, _, metrics, *_) in SIDES.items():
        ha, hb = _hist(metrics, a), _hist(metrics, b)
        prev = ha.copy()
        for v in b:
            ha.record(v)
        d = ha.delta(prev)
        merged = _hist(metrics, a).merge(hb)
        reset = hb.delta(_hist(metrics, a + b + [1.0]))
        out[name] = (merged.summary(), merged._buckets, d.summary(),
                     d._buckets, reset.count)
    assert out["torch"] == out["jax"]


def test_registry_observe_extra_and_sum_counter():
    tmetrics.reset_metrics()
    extra = tmetrics.Histogram("serving.ttft_ns", "ns")
    before = tcounters.snapshot()
    for v in (5.0, 7.0):
        tmetrics.observe("test.plane.lat_ns", v, sum_counter=True,
                         extra=extra)
    assert tmetrics.get_histogram("test.plane.lat_ns").count == 2
    assert extra.count == 2
    assert tcounters.delta(before) == {"test.plane.lat_ns": 12.0}
    assert tmetrics.histogram_summaries()["test.plane.lat_ns"]["max"] == 7.0
    tmetrics.reset_metrics()
    assert "test.plane.lat_ns" not in tmetrics.histograms()


# -- flight recorder ---------------------------------------------------------
def test_flight_ring_dump_and_capacity_equal_jax(tmp_path):
    out = {}
    for name, (flags, counters, metrics, flight, *_) in SIDES.items():
        flight.configure(directory=str(tmp_path / name))
        flags.set_flags({"FLAGS_flight_capacity": 8})
        flight.clear()
        try:
            for i in range(12):
                flight.record("serving.request", rid=i, prompt_len=3 * i)
            flight.record_point("loss", 2.5, step=3)
            counters.inc("test.plane.flight_ticks", 4)
            path = flight.dump("replica died!", {"replica": 1,
                                                 "ids": (1, 2)})
            bundle = flight.load(path)
            assert flight.last_dump_path() == path
            out[name] = (
                [e["kind"] for e in bundle["events"]],
                [e.get("rid") for e in bundle["events"]],
                bundle["context"], bundle["reason"],
                bundle["counters_delta"].get("test.plane.flight_ticks"),
                path.rsplit("/", 1)[1].split("-")[1])
        finally:
            flags.set_flags({"FLAGS_flight_capacity": 2048})
            flight.clear()
    assert out["torch"] == out["jax"]
    kinds, rids, ctx, reason, ticks, slug = out["torch"]
    assert len(kinds) == 8 and rids[:7] == list(range(5, 12))
    assert ctx == {"replica": 1, "ids": [1, 2]} and ticks == 4
    assert slug == "replica_died_"


# -- request traces ----------------------------------------------------------
def _trace_run(flags, trace, sample):
    """Six traces: finish reasons length/deadline/error, a retried one, a
    breached one; spans recorded by hand at fixed times."""
    flags.set_flags({"FLAGS_request_trace_sample": sample})
    trace.clear()
    try:
        kept = []
        for rid, (reason, kw) in enumerate(
                [("length", {}), ("deadline", {}), ("error", {}),
                 ("length", {"retried": True}),
                 ("length", {"breached": True}), ("eos", {})]):
            ctx = trace.new_trace(rid)
            t0 = ctx.start_ns
            ctx.add_span("queue", t0, t0 + 1000 * (rid + 1))
            ctx.add_span("prefill.chunk", t0 + 10, t0 + 500, chunk=16)
            sid = ctx.add_span("decode.iter", t0 + 600, t0 + 900, batch=2)
            ctx.add_span("kv.adopt", t0 + 610, t0 + 620, parent=sid)
            ctx.add_event("evict", reason=reason)
            kept.append(trace.finish(ctx, reason, **kw))
            assert trace.finish(ctx, reason) is False   # idempotent
            assert ctx.add_span("late", 0, 1) is None
        trees = [trace.get_trace(i) for i in trace.kept_ids()]
        shape = [(t["rid"], t["status"], t["keep_reason"],
                  [s["name"] for s in t["spans"]],
                  [c["name"] for c in t["tree"]["children"]],
                  t["stage_ns"]) for t in trees]
        br = trace.stage_breakdown()
        return kept, shape, {k: v for k, v in br.items()
                             if k == "requests"}, sorted(br)
    finally:
        flags.set_flags({"FLAGS_request_trace_sample": 0.0})
        trace.clear()       # later tests expect no kept trace


@pytest.mark.parametrize("sample", [1.0, 1e-12])
def test_trace_retention_and_trees_equal_jax(sample):
    out = {n: _trace_run(s[0], s[4], sample) for n, s in SIDES.items()}
    assert out["torch"] == out["jax"]
    kept = out["torch"][0]
    assert kept == ([True] * 6 if sample == 1.0
                    else [False, True, True, True, True, False])


def test_trace_off_mints_nothing_and_exports(tmp_path):
    before = tcounters.snapshot()
    assert ttrace.new_trace(3) is None
    assert not any(k.startswith("trace.") for k in tcounters.delta(before))
    tflags.set_flags({"FLAGS_request_trace_sample": 1.0})
    try:
        ctx = ttrace.new_trace(9)
        ctx.add_span("queue", ctx.start_ns, ctx.start_ns + 5)
        ttrace.finish(ctx, "length")
        path = ttrace.export_jsonl(str(tmp_path / "t.jsonl"), [ctx])
        rec = json.loads(open(path).read().splitlines()[0])
        assert rec["rid"] == 9 and rec["spans"][0]["name"] == "queue"
        thost.start()
        with thost.span("serving.step"):
            pass
        thost.stop()
        chrome = ttrace.to_chrome_trace([ctx])["traceEvents"]
        names = {e["name"] for e in chrome if e["ph"] == "X"}
        assert {"serving.step", "request[rid=9]", "queue"} <= names
    finally:
        tflags.set_flags({"FLAGS_request_trace_sample": 0.0})
        ttrace.clear()


# -- host tracer --------------------------------------------------------------
def test_host_tracer_sessions_equal_jax():
    out = {}
    for name, (flags, _, _, _, _, host, _) in SIDES.items():
        assert host.span("x") is host._NULL          # no session: no-op
        host.start()
        try:
            with host.span("serving.step"):
                with host.span("serving.decode"):
                    stack = host.current_stack()
                with host.span("serving.detail", level=2):
                    pass
            evts = host.stop()
        finally:
            flags.set_flags({"FLAGS_host_trace_level": 1})
        out[name] = ([(e[0], e[4]) for e in evts], stack,
                     host.summary(evts).splitlines()[3].split())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [("serving.decode", 1), ("serving.step", 0)]


# -- device-time ledger -------------------------------------------------------
@pytest.mark.parametrize("every", [1, 3, 7])
def test_devicetime_sampling_budget_equal_jax(every):
    out = {}
    for name, (flags, counters, *_, devicetime) in SIDES.items():
        devicetime.reset()
        flags.set_flags({"FLAGS_device_time_sample": every})
        before = counters.snapshot()
        try:
            for i in range(20):
                tok = devicetime.note(f"serving.decode{i % 2}")
                devicetime.observe(tok, None)
        finally:
            flags.set_flags({"FLAGS_device_time_sample": 0})
        d = counters.delta(before)
        snap = devicetime.snapshot()
        out[name] = (d.get("jit.devicetime.sampled_syncs", 0),
                     d.get("jit.devicetime.dispatches", 0),
                     sorted((r["name"], r["dispatches"], r["sampled"])
                            for r in snap["programs"]))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == math.ceil(20 / every)


def test_devicetime_regression_and_off_path_equal_jax():
    out = {}
    for name, (flags, counters, *_, devicetime) in SIDES.items():
        devicetime.reset()
        for _ in range(12):
            devicetime._record_sample("serving.decode_paged", 1e-3)
        for _ in range(8):
            devicetime._record_sample("serving.decode_paged", 5e-3)
        devicetime._record_sample("serving.kv.copy_block", 1e-4)
        row = devicetime.snapshot(top=1)["programs"][0]
        before = counters.snapshot()
        assert devicetime.note("serving.decode_paged") is None    # off
        out[name] = (row["name"], row["sampled"], row["regression"],
                     row["share"], row["mean_ms"], counters.delta(before))
        devicetime.reset()
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == pytest.approx(5.0)


def test_devicetime_fence_and_unported_join():
    tdevicetime.reset()
    tflags.set_flags({"FLAGS_device_time_sample": 1})
    try:
        tok = tdevicetime.note("serving.decode")
        dt = tdevicetime.observe(tok, (torch.ones(3), [torch.zeros(2)]))
    finally:
        tflags.set_flags({"FLAGS_device_time_sample": 0})
    assert dt >= 0.0
    assert "serving.decode" in tdevicetime.summary()
    tdevicetime.reset()
    with pytest.raises(NotImplementedError, match="A9"):
        tdevicetime.efficiency("serving.decode")
    with pytest.raises(NotImplementedError, match="A9"):
        tdevicetime.capture_profile(10)


# -- kernel launch counters ----------------------------------------------------
def test_launch_counter_exact_under_threads():
    """8 threads x 5000 counted launches on a plain counter and on a
    quantized one: the totals are exact (a bare ``+=`` on an attribute
    can drop increments between threads)."""
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.quant_launches = {"int8": 0, "fp8": 0}

    def hammer(i):
        for _ in range(5000):
            count_launch(wrapper)
            count_launch(wrapper, kv_dtype="int8" if i % 2 else "fp8")

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert wrapper.launches == 40000
    assert wrapper.quant_launches == {"int8": 20000, "fp8": 20000}
    count_launch(wrapper, 7)
    assert wrapper.launches == 40007
