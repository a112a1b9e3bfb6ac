"""Engine telemetry in the PyTorch port against the JAX package.

The paged engine (with LoRA tenants), the slot engine and the
speculative engine of each package serve one stream of requests over the
same 2-layer fp32 model (weights carried by ``load_numpy_state``), with
request tracing sampled at 1.0 and the flight recorder cleared first.
Compared exactly, engine for engine:

* the per-engine histograms (``LLMEngine.histogram_snapshot``): the same
  names — ``serving.ttft_ns``, ``itl_ns``, ``queue_wait_ns``,
  ``prefill_occupancy``, ``decode_occupancy``, the paged engine's
  ``serving.kv.block_occupancy`` and, under LoRA, the tenant buckets
  ``serving.{ttft,itl}_ns.tenant.<b>`` — with the same sample counts;
  the occupancy histograms (fractions of fixed shapes) bucket for bucket;
* the sequence of flight-recorder event kinds and their request ids;
* each kept trace's span names, in order, and its finish status;
* greedy tokens.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler import flight as jflight
from paddle_tpu.profiler import trace as jtrace
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.profiler import flight as tflight
from paddle_tpu_torch.profiler import trace as ttrace
from paddle_tpu_torch.serving import adapters as tad

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64, initializer_range=0.3)
DRAFT = dict(CFG, hidden_size=16, num_layers=1, num_heads=2)
COMMON = dict(max_slots=2, max_seq_len=64, min_bucket=4)
PAGED = dict(COMMON, kv_layout="paged", block_size=8, prefill_chunk=16)
#: fractions of fixed shapes: their samples are equal, not just counted
EXACT = ("serving.prefill_occupancy", "serving.decode_occupancy",
         "serving.kv.block_occupancy")


def _pair(cfg, seed):
    paddle.seed(seed)
    jm = JGPT(JConfig(use_flash_attention=False, **cfg))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_numpy_state({k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(CFG, 31), _pair(DRAFT, 7)


@pytest.fixture
def traced():
    for f in (jflags, tflags):
        f.set_flags({"FLAGS_request_trace_sample": 1.0})
    yield
    for f, tr, fl in ((jflags, jtrace, jflight), (tflags, ttrace, tflight)):
        f.set_flags({"FLAGS_request_trace_sample": 0.0})
        tr.clear()
        fl.clear()


def _stream(tenants=False):
    rng = np.random.default_rng(3)
    system = rng.integers(1, 64, size=16).tolist()
    out = []
    for i, n in enumerate((20, 9, 27, 5, 30)):
        p = (system if i % 2 == 0 else []) + rng.integers(
            1, 64, size=n).tolist()
        kw = dict(max_new_tokens=6, seed=i)
        if tenants and i in (1, 2):
            kw["adapter"] = f"t{i}"
        out.append((p, kw))
    return out


def _serve(eng, trace, flight, specs):
    flight.clear()
    trace.clear()
    hs = [eng.add_request(p, **kw) for p, kw in specs]
    n = 0
    while not all(h.is_finished for h in hs):
        eng.step()
        n += 1
        assert n < 500, "engine did not converge"
    hists = eng.histogram_snapshot()
    spans = sorted((c.rid, c.status, [s[2] for s in c.spans])
                   for c in trace.kept())
    return {
        "tokens": [list(map(int, h.tokens)) for h in hs],
        "hist_counts": {k: h.count for k, h in hists.items()},
        "exact": {k: hists[k].to_dict() for k in EXACT if k in hists},
        "flight": [(kind, f.get("rid")) for _, kind, f in flight.events()],
        "spans": spans,
    }


def _both(models, kw, specs, tenants=()):
    (jm, tm), (jd, td) = models
    out = {}
    for name, Eng, m, d, trace, flight in (
            ("jax", JEngine, jm, jd, jtrace, jflight),
            ("torch", LLMEngine, tm, td, ttrace, tflight)):
        ekw = dict(kw)
        if ekw.pop("draft", False):
            ekw["draft_model"] = d
        eng = Eng(m, **ekw)
        for i, t in enumerate(tenants):
            eng.register_adapter(t, tad.random_lora_factors(
                GPTConfig(**CFG), 3, seed=i + 1, scale=1.0))
        out[name] = _serve(eng, trace, flight, specs)
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_paged_engine_with_tenants(models, traced):
    rec = _both(models, dict(PAGED, adapter_slots=2, adapter_rank=3),
                _stream(tenants=True), tenants=("t1", "t2"))
    names = set(rec["hist_counts"])
    assert {"serving.ttft_ns", "serving.itl_ns", "serving.queue_wait_ns",
            "serving.prefill_occupancy", "serving.decode_occupancy",
            "serving.kv.block_occupancy"} <= names
    assert {n for n in names if ".tenant." in n} >= {
        "serving.ttft_ns.tenant.base", "serving.itl_ns.tenant.base"}
    assert len([n for n in names if n.startswith("serving.ttft_ns.tenant")]
               ) >= 2
    assert rec["hist_counts"]["serving.ttft_ns"] == 5
    assert rec["hist_counts"]["serving.itl_ns"] == 5 * 5
    kinds = [k for k, _ in rec["flight"]]
    assert kinds.count("serving.request") == 5
    assert kinds.count("serving.kv.admit") == 5
    assert kinds.count("serving.finish") == 5
    for _rid, status, names in rec["spans"]:
        assert status == "length"
        assert names[0] == "kv.reserve" and names[-1] == "evict"
        assert "queue" in names and "prefill.chunk" in names
        assert names.count("decode.iter") == 5


def test_slot_engine(models, traced):
    rec = _both(models, dict(COMMON), _stream())
    assert "serving.kv.block_occupancy" not in rec["hist_counts"]
    for _rid, _status, names in rec["spans"]:
        assert names[:2] == ["queue", "prefill"] and names[-1] == "evict"


def test_speculative_engine(models, traced):
    rec = _both(models, dict(PAGED, draft=True, spec_k=3, n_blocks=64),
                _stream())
    assert rec["hist_counts"]["serving.itl_ns"] == 5 * 5
    assert rec["hist_counts"]["serving.decode_occupancy"] < 5 * 5
