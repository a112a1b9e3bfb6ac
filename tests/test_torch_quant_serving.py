"""Quantized paged serving of the PyTorch port against the JAX package:
int8/fp8 KV pools with per-token scales, int8 weight-only layer matmuls.
(The quantized paged attention itself is held against the JAX kernel in
``tests/test_torch_paged_attention.py``.)

Same numpy inputs and the same weights (``load_numpy_state``) on both
sides.  Tolerances, each with its reason:

* ``quantize_kv``, ``channel_scales``, ``quantize_weight_int8``: bit
  equal (the same fp32 ops; fp8 tiles compared as their bytes).
* ``_mm``'s int8 epilogue: fp32 rtol/atol 1e-5 (one fp32 product in
  another order); bf16 one bf16 ulp of the output's scale (the product
  and the scale multiply round to bf16 once each, in another order).
* Model prefill/decode over scale pools: logits atol/rtol 1e-4, as the
  unquantized parity test (two fp32 implementations of the same 2-layer
  model).  A K/V value within an fp32 rounding of a quantization
  boundary may land one quantum apart, so pools may differ by at most
  one quantum of the token's own scale, and scales by 1e-5 relative.
* Engines: greedy tokens equal request for request, and the same
  counter movements.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.quantization import (channel_scales as jchannel_scales,
                                     ptq_int8_decode_state as jptq,
                                     quantize_weight_int8 as jquant_w)
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.quantization import (PTQ_WEIGHTS, channel_scales,
                                           ptq_int8_decode_state,
                                           quantize_weight_int8)
from paddle_tpu_torch.serving.kvcache import BlockPool

#: the tiny model of tests/test_paged_attention.py (vocab 64, hidden 32,
#: 2 layers); initializer_range 0.3, as in tests/test_torch_engine.py,
#: so greedy tokens vary and a token test proves something
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3)
ENGINE = dict(kv_layout="paged", max_slots=3, max_seq_len=32, block_size=4,
              prefill_chunk=8, min_bucket=8)
QUANT = ("serving.kv.quant.prefill_tokens", "serving.kv.quant.decode_tokens")
COMPARED = ("serving.kv.prefix_hits", "serving.kv.prefix_hit_tokens",
            "serving.kv.cow_copies", "serving.kv.prefill_chunks",
            "serving.decode_steps", "serving.decode_tokens") + QUANT
GAUGES = ("serving.kv.quant.arena_bytes", "serving.kv.quant.bytes_saved")


@pytest.fixture()
def interpret_mode():
    jpa._INTERPRET[0] = True
    yield
    jpa._INTERPRET[0] = False


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = JGPT(JConfig(use_flash_attention=False, **CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_numpy_state({k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


def _bytes(t):
    """A quantized tensor's raw bytes (fp8 compared bit for bit)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy() if t.dtype.itemsize == 1 \
            else t.numpy()
    return np.asarray(t).view(np.uint8)


# -- quantize_kv / dequantize_kv ---------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantize_kv_matches_jax(kv_dtype, dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 4, 2, 8)).astype(np.float32) * 3.0
    x[1, 2] = 0.0                  # an all-zero (padded) token
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jpa.quantize_kv(jx, kv_dtype)
    tq, ts = tpa.quantize_kv(tx, kv_dtype)
    assert tq.dtype == tpa.KV_DTYPES[kv_dtype] and ts.dtype == torch.float32
    assert tq.shape == (5, 4, 2, 8) and ts.shape == (5, 4)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tpa.dequantize_kv(tq, ts).numpy(),
                                  np.asarray(jpa.dequantize_kv(jq, js)))
    assert not tq[1, 2].float().any()
    assert tpa.kv_dtype_of(tq.dtype) == kv_dtype


def test_kv_dtype_of_float_pools():
    assert tpa.kv_dtype_of(torch.bfloat16) is None
    assert tpa.kv_dtype_of(torch.float32) is None


# -- int8 weight-only PTQ -----------------------------------------------------
@pytest.mark.parametrize("observer,percentile", [
    ("absmax", 99.99), ("percentile", 99.99), ("percentile", 97.3)])
def test_weight_quantization_bit_equal_to_jax(observer, percentile):
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((2, 96, 40)) * 0.3).astype(np.float32)
    w[1, :, 3] = 0.0               # a dead channel: the 1e-8 floor
    want = np.asarray(jchannel_scales(jnp.asarray(w), observer, percentile))
    got = channel_scales(torch.from_numpy(w), observer, percentile)
    assert got.shape == (2, 1, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    jq, js = jquant_w(jnp.asarray(w), observer, percentile)
    tq, ts = quantize_weight_int8(torch.from_numpy(w), observer, percentile)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="observer"):
        channel_scales(torch.from_numpy(w), "minmax")


def test_ptq_decode_state_matches_jax(models):
    jm, tm = models
    jw, tw = jptq(jm), ptq_int8_decode_state(tm)
    for name in PTQ_WEIGHTS:
        assert tw["lws"][name].dtype == torch.int8
        np.testing.assert_array_equal(tw["lws"][name].numpy(),
                                      np.asarray(jw["lws"][name]))
        np.testing.assert_array_equal(
            tw["lws"][name + "__scale"].numpy(),
            np.asarray(jw["lws"][name + "__scale"]))
    # biases, norms and embeddings stay the model's own tensors
    assert tw["lws"]["qkv_b"] is tm.qkv_b._data \
        and tw["wte"] is tm.wte._data


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm_int8_epilogue_matches_jax(dtype):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (rng.standard_normal((1, 32, 24)) * 0.2).astype(np.float32)
    jq, js = jquant_w(jnp.asarray(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jgpt._mm(jx, {"fc1_w": jq[0], "fc1_w__scale": js[0]}, "fc1_w")
    tq, ts = quantize_weight_int8(torch.from_numpy(w))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tgpt._mm(tx, {"fc1_w": tq[0], "fc1_w__scale": ts[0]}, "fc1_w")
    assert got.dtype == tx.dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got.float().numpy() - want).max() <= tol


# -- the model's quantized prefill/decode ------------------------------------
def _assert_pools_close(tpool, tscale, jpool, jscale, kv_dtype):
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale),
                               rtol=1e-5, atol=0)
    deq_t = tpa.dequantize_kv(tpool, tscale).numpy()
    deq_j = np.asarray(jpa.dequantize_kv(jpool, jscale))
    step = np.asarray(jscale)[..., None, None]
    if kv_dtype == "fp8":   # one e4m3 step at the value: 2**-3 relative
        step = np.maximum(step, np.abs(deq_j) * 2.0 ** -3)
    assert (np.abs(deq_t - deq_j) <= step * (1 + 1e-5)).all()


@pytest.mark.parametrize("kv_dtype,weights", [
    ("int8", None), ("fp8", None), ("int8", "int8")])
def test_quantized_prefill_and_decode_match_jax(interpret_mode, models,
                                                kv_dtype, weights):
    jm, tm = models
    if weights:
        jw, tw = jptq(jm), ptq_int8_decode_state(tm)
    else:
        jw, tw = jm.decode_state(), tm.decode_state()
    L, nh = CFG["num_layers"], CFG["num_heads"]
    hd = CFG["hidden_size"] // nh
    shape = (L, 12, 4, nh, hd)
    jk = jnp.zeros(shape, jpa.KV_DTYPES[kv_dtype])
    jv = jnp.zeros(shape, jpa.KV_DTYPES[kv_dtype])
    jsk, jsv = jnp.zeros(shape[:3]), jnp.zeros(shape[:3])
    tk = torch.zeros(shape, dtype=tpa.KV_DTYPES[kv_dtype])
    tv = torch.zeros(shape, dtype=tpa.KV_DTYPES[kv_dtype])
    tsk, tsv = torch.zeros(shape[:3]), torch.zeros(shape[:3])
    prompt = np.random.default_rng(2).integers(0, CFG["vocab_size"], 13)
    table = np.array([3, 5, 1, 7, 0, 0, 0, 0], np.int32)
    for start, length in ((0, 8), (8, 5)):   # the second pads into trash
        ids = np.zeros((1, 8), np.int32)
        ids[0, :length] = prompt[start:start + length]
        jk, jv, jsk, jsv, jl = jm.prefill_paged(
            jw, jnp.asarray(ids), start, length, jnp.asarray(table), jk, jv,
            jsk, jsv)
        tl = tm.prefill_paged(tw, torch.from_numpy(ids).long(), start,
                              length, torch.from_numpy(table), tk, tv, tsk,
                              tsv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    # padded tokens: zero tiles and zero scales in the trash block
    assert not tsk[:, 0, 1:].any() and not tk[:, 0, 1:].float().any()
    tok = np.array([int(prompt[-1]), 9, 0], np.int32)
    pos = np.array([13, 5, 0], np.int32)
    bt = np.zeros((3, 8), np.int32)
    bt[0] = table
    bt[1, :2] = [2, 4]
    targs = [torch.from_numpy(a) for a in (tok, pos, bt)]
    saved = [t.clone() for t in (tk, tv, tsk, tsv)]
    tl = tm.decode_paged(tw, *targs, tk, tv, tsk, tsv)
    jl, jk2, jv2, jsk2, jsv2 = jm.decode_paged(
        jw, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(bt), jk, jv,
        jsk, jsv, kernel="pallas")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    _assert_pools_close(tk, tsk, jk2, jsk2, kv_dtype)
    _assert_pools_close(tv, tsv, jv2, jsv2, kv_dtype)
    # the plain attention inside the model writes the same pools and gives
    # the same logits (on the CPU the wrapper is the plain version)
    tl2 = tm.decode_paged(tw, *targs, *saved, kernel=False)
    np.testing.assert_array_equal(tl2.numpy(), tl.numpy())
    for a, b in zip(saved, (tk, tv, tsk, tsv)):
        np.testing.assert_array_equal(_bytes(a), _bytes(b))


# -- engines ------------------------------------------------------------------
def _specs():
    rng = np.random.default_rng(0)
    rand = lambda n: rng.integers(0, 64, n).tolist()  # noqa: E731
    system = rand(9)
    p0 = rand(10)
    return [
        (p0, dict(max_new_tokens=1)),      # donates p0, tail block partial
        (system + rand(3), dict(max_new_tokens=6)),
        (rand(5), dict(max_new_tokens=7)),
        (p0 + rand(5), dict(max_new_tokens=6)),   # full hits + COW of p0
        (system + rand(6), dict(max_new_tokens=6)),
        (system + rand(2), dict(max_new_tokens=4)),
    ]


def _serve(eng, counters, specs):
    before = counters.snapshot()
    handles = [eng.add_request(p, **kw) for p, kw in specs]
    steps = 0
    while not all(h.is_finished for h in handles):
        eng.step()
        steps += 1
        assert steps < 300, "engine did not converge"
    moved = counters.delta(before)
    return ([h.tokens for h in handles],
            {k: moved.get(k, 0) for k in COMPARED},
            {k: counters.get(k) for k in GAUGES})


@pytest.mark.parametrize("knobs", [
    dict(kv_dtype="int8"), dict(kv_dtype="fp8"), dict(weight_dtype="int8"),
    dict(kv_dtype="int8", weight_dtype="int8")])
def test_quantized_engine_matches_jax_engine(models, knobs):
    """Greedy tokens, prefix hits, a COW adoption (scale rows cloned with
    the tiles) and the quant counters and gauges, against the JAX paged
    engine with the same knobs."""
    jm, tm = models
    specs = _specs()
    teng = LLMEngine(tm, **ENGINE, **knobs)
    ttok, tmoved, tgauge = _serve(teng, tcounters, specs)
    jeng = JEngine(jm, **ENGINE, **knobs)
    jtok, jmoved, jgauge = _serve(jeng, jcounters, specs)
    assert ttok == jtok
    assert tmoved == jmoved
    assert tmoved["serving.kv.cow_copies"] > 0
    assert tmoved["serving.kv.prefix_hits"] > 0
    assert len({t for toks in ttok for t in toks}) >= 5   # tokens vary
    st = teng.stats()
    assert (st["kv_dtype"], st["weight_dtype"]) == (
        knobs.get("kv_dtype"), knobs.get("weight_dtype"))
    quant = "kv_dtype" in knobs
    assert (tmoved[QUANT[0]] > 0 and tmoved[QUANT[1]] > 0) == quant
    if quant:
        assert tgauge == jgauge
        # the pool bytes count the scale pools, as the arena gauge does
        assert st["kv_pool_bytes"] == tgauge["serving.kv.quant.arena_bytes"]
        assert tgauge["serving.kv.quant.bytes_saved"] > 0
        assert teng.pool_k.dtype == tpa.KV_DTYPES[knobs["kv_dtype"]]


def test_cow_clones_scale_rows(models):
    _, tm = models
    eng = LLMEngine(tm, **ENGINE, kv_dtype="int8")
    sk, sv = eng.scales
    for t in (eng.pool_k, eng.pool_v):
        t.copy_(torch.randint(-127, 128, t.shape, dtype=torch.int8))
    for t in (sk, sv):
        t.uniform_(0.1, 1.0)
    src_k, src_s = eng.pool_k[:, 5].clone(), sk[:, 5].clone()
    eng._copy_block(5, 9, 3)
    np.testing.assert_array_equal(eng.pool_k[:, 9, :3], src_k[:, :3])
    np.testing.assert_array_equal(sk[:, 9, :3], src_s[:, :3])
    assert not eng.pool_k[:, 9, 3:].any() and not sk[:, 9, 3:].any()
    assert not sv[:, 9, 3:].any() and bool((sv[:, 9, :3] > 0).all())


def test_block_pool_kv_dtype_validation():
    assert BlockPool(4, 4, kv_dtype="fp8").kv_dtype == "fp8"
    assert BlockPool(4, 4).kv_dtype is None
    with pytest.raises(ValueError, match="kv_dtype"):
        BlockPool(4, 4, kv_dtype="int4")
