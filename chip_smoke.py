#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the
script exits non-zero:

1. device — requires CUDA; prints the card's name and power limit
   (``nvidia-smi``); turns TF32 off so fp32 products are fp32.
2. build — builds every CUDA kernel of the serving path from the sources
   in the checkout (``paddle_tpu_torch/kernels/csrc``).
3. kernel_vs_plain — each kernel against its plain PyTorch version on
   the card, over a grid of shapes and at the engine's shapes.
4. small_reference — a small fp32 model's paged prefill/decode on the
   card against the same model on the CPU (where the kernel's plain
   version runs).
5. engine — GPT-3 1.3B in bf16 at full width and depth, random weights
   from seed 0, serving 16 greedy requests through
   ``LLMEngine(model, kv_layout="paged")``; kernel launch counts are set
   to 0 just before and read just after.  Then one decode step on clones
   of the engine's pools, once through the kernel and once through the
   plain attention, compared in bf16; and ``torch.profiler`` over four
   decode-only engine steps (the device's busy share, the top device ops).
6. times — each kernel's time per launch at the engine's shapes beside
   its plain version's, a PyTorch library call's and its bound.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import GPTConfig, GPTForCausalLM, LLMEngine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.profiler import counters

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor)
#: FLOP/s, the type the paged decode kernel computes in.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: kernel vs plain version: both compute in fp32 from the same inputs and
#: differ only in the order of their fp32 sums (<= 1024 keys, <= 128
#: dims, unit-scale values)
KERNEL_ATOL = 1e-4


def emit(record):
    print(json.dumps(record), flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return name, card


def build_phase():
    t0 = time.perf_counter()
    _build.load("paged_attention")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": _build.BUILD_LOGS.get("paged_attention", "(cached)")})


def _paged_case(gen, B, nh, hd, bs, max_blocks, q_dtype, kv_dtype,
                trash_row):
    dev = "cuda"
    n_blocks = B * max_blocks + 1
    q = torch.randn(B, nh, hd, generator=gen, device=dev).to(q_dtype)
    pk = torch.randn(n_blocks, bs, nh, hd, generator=gen,
                     device=dev).to(kv_dtype)
    pv = torch.randn(n_blocks, bs, nh, hd, generator=gen,
                     device=dev).to(kv_dtype)
    bt = (torch.randperm(n_blocks - 1, generator=gen, device=dev)[
        :B * max_blocks] + 1).reshape(B, max_blocks).to(torch.int32)
    last = max_blocks * bs - 1
    choices = torch.tensor([0, bs - 1, bs, last], device=dev)
    pos = torch.randint(0, last + 1, (B,), generator=gen, device=dev)
    pos[:min(B, 4)] = choices[:min(B, 4)]
    pos = pos.to(torch.int32)
    if trash_row and B > 1:
        bt[-1] = 0
        pos[-1] = 0
    return q, pk, pv, bt, pos


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [dict(B=B, nh=3, hd=hd, bs=bs, max_blocks=6, q_dtype=dt,
                  kv_dtype=dt, trash_row=True)
             for hd in (8, 64, 96, 128) for bs in (4, 16)
             for dt in (fp32, bf16) for B in (1, 7, 16)]
    # head dims off the grid: scalar loads (33), 8 dims a lane (200, 256)
    cases += [dict(B=7, nh=2, hd=hd, bs=16, max_blocks=5, q_dtype=dt,
                   kv_dtype=dt, trash_row=True)
              for hd in (33, 200, 256) for dt in (fp32, bf16)]
    cases += [dict(B=4, nh=2, hd=128, bs=16, max_blocks=5, q_dtype=qd,
                   kv_dtype=kd, trash_row=True)
              for qd in (fp32, bf16) for kd in (fp32, bf16) if qd != kd]
    # the engine's shape: 8 rows, GPT-3 1.3B heads, 1024 tokens in 16s
    cases.append(dict(B=8, nh=16, hd=128, bs=16, max_blocks=64,
                      q_dtype=bf16, kv_dtype=bf16, trash_row=True))
    worst = 0.0
    for case in cases:
        q, pk, pv, bt, pos = _paged_case(gen, **case)
        out = pa.paged_decode_attention(q, pk, pv, bt, pos, scale=0.3)
        ref = pa.paged_decode_attention_reference(q, pk, pv, bt, pos,
                                                  scale=0.3)
        torch.cuda.synchronize()
        if out.dtype != torch.float32 or out.shape != ref.shape:
            raise AssertionError(f"paged_decode_attention: {out.dtype} "
                                 f"{tuple(out.shape)} for {case}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"paged_decode_attention: non-finite "
                                 f"output for {case}")
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        if err > KERNEL_ATOL:
            raise AssertionError(f"paged_decode_attention: max abs err "
                                 f"{err} > {KERNEL_ATOL} for {case}")
    emit({"phase": "kernel_vs_plain", "kernel": "paged_decode_attention",
          "cases": len(cases), "max_abs_err": worst, "atol": KERNEL_ATOL})
    return worst


def small_reference_phase():
    """A small fp32 model's paged prefill + decode on the card (through
    the kernel) against the same weights on the CPU (plain version)."""
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=128, initializer_range=0.1)
    models = {d: GPTForCausalLM(cfg, device=d,
                                generator=torch.Generator().manual_seed(1))
              for d in ("cuda", "cpu")}
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 45)
    bs, max_blocks, n_blocks = 16, 8, 12
    table = np.array([3, 9, 1, 5, 0, 0, 0, 0], np.int32)
    bt = np.zeros((3, max_blocks), np.int32)
    bt[0] = table
    bt[1, :2] = [2, 4]
    tok = np.array([prompt[-1], 7, 0], np.int32)
    pos = np.array([45, 20, 0], np.int32)     # row 2 idle on the trash block
    out = {}
    for d, m in models.items():
        w = m.decode_state()
        shape = (cfg.num_layers, n_blocks, bs, cfg.num_heads,
                 cfg.hidden_size // cfg.num_heads)
        pk = torch.zeros(shape, device=d)
        pv = torch.zeros(shape, device=d)
        logits = []
        for start, length in ((0, 32), (32, 13)):
            ids = np.zeros((1, 32), np.int64)
            ids[0, :length] = prompt[start:start + length]
            logits.append(m.prefill_paged(
                w, torch.from_numpy(ids).to(d), start, length,
                torch.from_numpy(table).to(d), pk, pv))
        logits.append(m.decode_paged(
            w, *(torch.from_numpy(a).to(d) for a in (tok, pos, bt)), pk, pv))
        out[d] = [t.cpu() for t in logits] + [pk.cpu(), pv.cpu()]
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(out["cuda"],
                                                       out["cpu"])]
    scale = max(float(t.abs().max()) for t in out["cpu"][:3])
    tol = 1e-4 * max(1.0, scale)   # fp32 on both sides; sums reordered
    emit({"phase": "small_reference", "max_abs_err": max(errs),
          "atol": tol, "logit_scale": scale})
    if not all(bool(torch.isfinite(t).all()) for t in out["cuda"]):
        raise AssertionError("small_reference: non-finite values on the card")
    if max(errs) > tol:
        raise AssertionError(f"small_reference: card vs CPU {errs} > {tol}")


def engine_phase():
    cfg = GPTConfig.gpt3_1_3b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = LLMEngine(model, kv_layout="paged", max_slots=8, max_seq_len=1024,
                    block_size=16, prefill_chunk=128)
    V, L = cfg.vocab_size, cfg.num_layers

    rng = np.random.default_rng(0)
    system = rng.integers(0, V, 256)
    prompts = []
    for i in range(16):
        if i % 2 == 0:   # half share a 256-token system prompt
            n = int(rng.integers(256 + 16, 701))
            prompts.append(np.concatenate(
                [system, rng.integers(0, V, n - 256)]))
        else:
            prompts.append(rng.integers(0, V, int(rng.integers(64, 701))))
    # warm-up: cuBLAS handles, kernel load, allocator (not counted)
    eng.generate([rng.integers(0, V, 64)], max_new_tokens=2)
    torch.cuda.synchronize()

    # -- the counted main-path run ------------------------------------------
    pa.paged_decode_attention.launches = 0
    before = counters.snapshot()
    t_run = time.perf_counter()
    handles = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    first = {}
    decode_only = []          # (seconds, tokens) of steps with no prefill
    snap, best = None, 0
    while not all(h.is_finished for h in handles):
        chunks0 = counters.get("serving.kv.prefill_chunks")
        toks0 = counters.get("serving.decode_tokens")
        t0 = time.perf_counter()
        events = eng.step()
        dt = time.perf_counter() - t0
        now = time.monotonic_ns()
        if counters.get("serving.kv.prefill_chunks") == chunks0:
            decode_only.append((dt, counters.get("serving.decode_tokens")
                                - toks0))
        for ev in events:
            if ev["type"] == "token" and ev["index"] == 0:
                first[ev["request"].rid] = now - ev["request"].arrival_ns
        running = int(eng._running.sum())
        if running > best:
            # the fullest decode batch so far, for the in-model comparison
            best = running
            snap = dict(
                bt=np.where(eng._running[:, None], eng._bt, 0),
                pos=np.where(eng._running, eng._pos, 0),
                tok=eng._tok.copy(), pk=eng.pool_k.clone(),
                pv=eng.pool_v.clone())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = pa.paged_decode_attention.launches
    moved = counters.delta(before)

    reasons = {h.finish_reason for h in handles}
    for h in handles:
        if h.finish_reason not in ("length", "eos") or not (
                len(h.tokens) == 32 or h.finish_reason == "eos"):
            raise AssertionError(f"engine: {h} finished badly: {h.error!r}")
        if not all(0 <= t < V for t in h.tokens):
            raise AssertionError(f"engine: token out of range in {h}")
    steps = moved.get("serving.decode_steps", 0)
    if moved.get("serving.kv.prefix_hits", 0) <= 0:
        raise AssertionError(f"engine: no prefix hits ({moved})")
    if launches <= 0 or launches != steps * L:
        raise AssertionError(f"engine: kernel launches {launches} != "
                             f"decode_steps {steps} x {L} layers")

    ttft = np.array(sorted(first.values())) / 1e6
    d_s = sum(s for s, _ in decode_only)
    d_tok = sum(n for _, n in decode_only)
    record = {
        "phase": "engine", "model": "gpt3_1_3b bf16", "layers": L,
        "init_s": init_s, "requests": len(handles),
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": int(sum(len(h.tokens) for h in handles)),
        "finish_reasons": sorted(reasons), "wall_s": wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p95": float(np.percentile(ttft, 95)),
        "decode_only_steps": len(decode_only),
        "decode_tokens_per_s": d_tok / d_s if d_s else None,
        "decode_step_ms_p50": (float(np.median([s for s, _ in decode_only]))
                               * 1e3 if decode_only else None),
        "output_tokens_per_s": sum(len(h.tokens) for h in handles) / wall,
        "kernel_launches": launches, "decode_steps": steps,
        "counters": {k: v for k, v in moved.items()
                     if k.startswith(("serving.kv.prefix", "serving.kv.cow",
                                      "serving.kv.prefill", "serving.decode",
                                      "serving.kv.blocks_evicted"))},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(record)

    # -- kernel against plain inside the model ------------------------------
    w = eng._w
    dev = "cuda"
    args = [torch.from_numpy(np.ascontiguousarray(snap[k]).astype(
        np.int32)).to(dev) for k in ("tok", "pos", "bt")]
    logits = {}
    for kernel in (True, False):
        pk, pv = snap["pk"].clone(), snap["pv"].clone()
        logits[kernel] = model.decode_paged(w, *args, pk, pv, kernel=kernel)
        del pk, pv
    torch.cuda.synchronize()
    ref = logits[False]
    if not (bool(torch.isfinite(logits[True]).all())
            and bool(torch.isfinite(ref).all())):
        raise AssertionError("in-model decode: non-finite logits")
    err = float((logits[True] - ref).abs().max())
    scale = float(ref.abs().max())
    # the kernel's and the plain attention outputs agree to fp32 rounding
    # but are cast to bf16 before the projection; a value near a rounding
    # boundary flips by one bf16 ulp (2**-8 relative) and 24 layers carry
    # such flips to the logits: allow 8 bf16 ulps of the logit scale
    tol = 8 * 2.0 ** -8 * max(1.0, scale)
    agree = float((logits[True].argmax(-1) == ref.argmax(-1)).float().mean())
    emit({"phase": "in_model", "rows_running": best, "max_abs_err": err,
          "atol": tol, "logit_scale": scale, "argmax_agreement": agree})
    if err > tol:
        raise AssertionError(f"in-model decode: kernel vs plain {err} > {tol}")
    profile_phase(eng, rng)
    return record, snap


def profile_phase(eng, rng):
    """Where a decode step's time goes: ``torch.profiler`` over four
    engine steps that only decode (8 rows), the device's busy share of
    their wall time and the device ops that take it."""
    V = eng.config.vocab_size
    handles = [eng.add_request(rng.integers(0, V, 64), max_new_tokens=12)
               for _ in range(eng.max_slots)]
    for _ in range(2):   # admit + one-chunk prefill, then a first decode
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    while not all(h.is_finished for h in handles):
        eng.step()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # device-side events only: a CPU op's row repeats its kernels' time
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in ops)
    emit({"phase": "profile", "steps": 4, "rows": eng.max_slots,
          "wall_us": wall_us, "device_us": busy,
          "device_busy_share": busy / wall_us if busy else None,
          "top_device_ops": [{"name": e.key[:80], "us": dev_us(e),
                              "calls": e.count} for e in ops[:10]
                             if dev_us(e) > 0]})


def _time_ms(fn, n, warmup=3):
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def times_phase(snap, max_err, launches):
    """Per-launch times at the engine's decode shapes.  Launches rotate
    over the 24 layers' pools, as decode does, so the K/V read does not
    sit in the 50 MB L2 between launches."""
    pk_all, pv_all = snap["pk"], snap["pv"]
    L, n_blocks, bs, nh, hd = pk_all.shape
    bt = torch.from_numpy(snap["bt"].astype(np.int32)).cuda()
    pos = torch.from_numpy(snap["pos"].astype(np.int32)).cuda()
    B, max_blocks = bt.shape
    S = max_blocks * bs
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = (torch.randn(B, nh, hd, generator=gen, device="cuda")
         / math.sqrt(hd)).to(pk_all.dtype)

    def kernel(i):
        l = i % L
        pa.paged_decode_attention(q, pk_all[l], pv_all[l], bt, pos,
                                  scale=1.0)

    def plain(i):
        l = i % L
        pa.paged_decode_attention_reference(q, pk_all[l], pv_all[l], bt,
                                            pos, scale=1.0)

    # library yardstick: SDPA over pre-gathered contiguous K/V, boolean mask
    idx = bt.long()
    gk = [pk_all[l][idx].reshape(B, S, nh, hd).transpose(1, 2).contiguous()
          for l in range(L)]
    gv = [pv_all[l][idx].reshape(B, S, nh, hd).transpose(1, 2).contiguous()
          for l in range(L)]
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library(i):
        l = i % L
        F.scaled_dot_product_attention(q4, gk[l], gv[l], attn_mask=mask,
                                       scale=1.0)

    # in turns within this one call: plain, kernel, library, kernel, plain
    runs = {"plain": [], "kernel": [], "library": []}
    for name, fn, n in (("plain", plain, 48), ("kernel", kernel, 480),
                        ("library", library, 240), ("kernel", kernel, 480),
                        ("plain", plain, 48), ("library", library, 240)):
        runs[name].append(_time_ms(fn, n))
    ms = {k: float(np.mean(v)) for k, v in runs.items()}

    live = (pos.long() + 1)
    keys = int(live.sum())
    nblk = int((pos.long() // bs + 1).sum())
    itemsize = pk_all.element_size()
    bytes_moved = (q.numel() * q.element_size()      # q
                   + 2 * keys * nh * hd * itemsize    # live K and V
                   + nblk * 4 + B * 4                 # table entries, pos
                   + B * nh * hd * 4)                 # fp32 output
    flops = 4 * keys * nh * hd                        # q.k and p.v
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    emit({"phase": "times", "kernel": "paged_decode_attention",
          "shape": {"B": B, "nh": nh, "hd": hd, "bs": bs,
                    "max_blocks": max_blocks, "live_keys": keys,
                    "dtype": str(pk_all.dtype)},
          "kernel_us": ms["kernel"] * 1e3, "plain_us": ms["plain"] * 1e3,
          "library_us": ms["library"] * 1e3, "runs_ms": runs,
          "bytes": bytes_moved, "flops": flops, "bound_us": bound * 1e3,
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
          "kernel_gb_per_s": bytes_moved / (ms["kernel"] * 1e-3) / 1e9})
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:132",
            "launches": launches, "max_abs_err": max_err,
            "max_err": max_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": ms["library"]}


def main():
    name, _card = device_phase()
    build_phase()
    max_err = kernel_phase()
    small_reference_phase()
    record, snap = engine_phase()
    row = times_phase(snap, max_err, record["kernel_launches"])
    torch.cuda.synchronize()
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
