#!/usr/bin/env python3
"""Compare variants of the flash-attention kernels on one NVIDIA GPU.

    python3 flash_variants.py [--source NAME] [--dtype float16]
                              [--shape B,H,S,D,CAUSAL] [--unchecked]
                              VARIANT.cu [VARIANT.cu ...]

Each VARIANT.cu is a whole replacement of
``paddle_tpu_torch/kernels/csrc/NAME.cu`` (a text edit of it, say) with
the same C interface; NAME is ``flash_attention`` (the default: K1–K3
at head dims 64/96/128) or ``flash_attention_d256`` (K1–K3 at head dim
256).  The script builds the checked-in source and every variant
with the package's ``nvcc`` flags (``csrc/`` on the include path), one
process each, all started together, into ``build/variants/``
(git-ignored), and prints per variant ptxas's registers and spills of
the Hopper kernels.  A variant that includes ``flash_hopper.cuh`` takes
the copy beside it if there is one (another commit's), else the
checked-in one.  It then holds each variant's K1, K2 and K3 to their
plain versions with ``chip_smoke.py``'s per-element tolerance over a
few shapes (one and several tiles, odd tile counts, causal and not, dO
[B, H, S, D]-contiguous, the timed shape), K1–K3 also to the same bits
on a second run, drops a variant that fails, and says whether each
variant's outputs are bit for bit the checked-in source's on every case
(``bits_equal_to_source``); a variant without K2 (an older
``flash_attention_d256.cu``) runs the checked-in source's K2, whose time
is not its own.  Last it times K1–K3 of every variant left at its shape
(``flash_attention``: the 760M training shape, B 8, S 1024, 16 heads of
96; ``flash_attention_d256``: B 2, H 16, S 1024, D 256; causal) in
turns, first to last and back, beside SDPA's flash backward, with
``chip_smoke.py``'s device timer.  The operands are bf16, or fp16 with
``--dtype float16``: then the cases add operands that are all ties
between bf16 values, with subnormals; K1–K3 of ``flash_attention`` must
give the bits of the route on the wrapper's rounded copies (dtype code
2) of the same library, and that route is timed beside them
(``k1_copies``, ``k2_copies``, ``k3_copies``).  ``--shape`` times
another shape (CAUSAL 0 or 1; BERT-large's is 16,16,512,64,0);
``--unchecked`` skips the checks, to time diagnostic edits that are
wrong on purpose (a handshake without its work, say).  One JSON line per
result; the last holds the times in µs.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

OUT = Path(__file__).resolve().parent / "build" / "variants"
#: per source: checked cases (B, H, S, D, causal, layout: None, or
#: "bhsd" for dO [B, H, S, D]-contiguous) and the timed (B, H, S, D)
SOURCES = {
    "flash_attention": (
        [(2, 3, 256, d, c, None) for d in fa.KERNEL_HEAD_DIMS
         for c in (False, True)]
        + [(1, 1, 128, 96, True, None), (2, 3, 384, 96, True, None),
           (2, 3, 384, 128, False, None), (5, 7, 2048, 96, True, "bhsd"),
           (cs.TRAIN_B, 16, cs.TRAIN_S, 96, True, None)],
        (cs.TRAIN_B, 16, cs.TRAIN_S, 96)),
    "flash_attention_d256": (
        [(1, 1, 128, 256, c, None) for c in (False, True)]
        + [(3, 5, 384, 256, c, None) for c in (False, True)]
        + [(5, 7, 1024, 256, True, None), (2, 4, 512, 256, True, "bhsd"),
           (2, 16, 1024, 256, True, None)],
        (2, 16, 1024, 256)),
}


def build(name, src):
    """nvcc one source into ``OUT/<name>.so``: (name, exit code, log)."""
    out = OUT / f"{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return name, proc.returncode, proc.stderr


#: the library name a variant without K2 (an older source) sends its K2
#: launches to: the checked-in source's build
K2_OF_SOURCE = "k2_of_source"
_ROUTED = fa._library


def has_k2(lib):
    return getattr(lib, "flash_bwd_dq_launch", None) is not None


def use(source, lib, fallback=None):
    """Route the wrappers in ``fa`` that take ``source`` to ``lib``, and
    K2 to ``fallback`` if ``lib`` has none."""
    _build._LIBS[source] = fa._bind(lib)
    fa._library = _ROUTED
    if not has_k2(lib) and fallback is not None:
        _build._LIBS[K2_OF_SOURCE] = fa._bind(fallback)
        fa._library = lambda D, dtype, kernel="fwd": (
            K2_OF_SOURCE if kernel == "dq" else _ROUTED(D, dtype, kernel))


def check(case, gen, dtype):
    """(worst err/tol of K1, dQ, dK, dV; the outputs) on one case; None
    if a kernel gives other bits on a second run, or (fp16) K1, K2 or K3
    other bits than on the wrapper's rounded copies."""
    B, H, S, D, causal, layout = case
    q, k, v = cs._qkv_views(gen, B, S, H, D, dtype)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    if layout == "bhsd":
        do = do.contiguous()
    if layout == "ties":
        cs._ties_and_subnormals(gen, (q, k))
        cs._ties_and_subnormals(gen, (v, do), head=0)
    sc = 1.0 / math.sqrt(D)
    rout, rlse = fa._flash_fwd_reference(q, k, v, causal, sc)
    delta = fa._delta(rout, do)
    args = (q, k, v, do, rlse, delta, causal, sc)

    def run():
        return [*fa.flash_fwd(q, k, v, causal, sc), fa.flash_bwd_dq(*args),
                *fa.flash_bwd_dkv(*args)]

    got, again = run(), run()
    refs = [rout, fa._bwd_dq_reference(*args),
            *fa._bwd_dkv_reference(*args)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        return None
    if fa._dtype_code("fwd", D, dtype) == fa.F16_IN_KERNEL:
        with cs._wrapper_rounding():
            copies = run()
        if not all(map(torch.equal, got, copies)):
            return None
    outs = [got[0], *got[2:]]
    return [float(((g.float() - r.float()).abs()
                   / cs._flash_tol(r, dtype)).max())
            for g, r in zip(outs, refs)], got


def main(source, paths, dtype, shape=None, checked=True):
    cs.device_phase()
    OUT.mkdir(parents=True, exist_ok=True)
    cases, timed = SOURCES[source]
    B, H, S, D, causal = shape or (*timed, True)
    f16_in_kernel = fa._dtype_code("fwd", D, dtype) == fa.F16_IN_KERNEL
    if f16_in_kernel:
        cases = cases + [(2, 4, 256, d, c, "ties")
                         for d in fa.KERNEL_HEAD_DIMS for c in (False, True)]
    sources = {"source": _build.CSRC / f"{source}.cu"}
    sources.update((Path(p).stem, Path(p)) for p in paths)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda kv: build(*kv), sources.items()))
    cs.emit({"phase": "build", "source": source,
             "seconds": time.perf_counter() - t0})
    libs = {}
    for name, rc, log in built:
        if rc != 0:
            cs.emit({"variant": name, "build": "failed", "log": log[-4000:]})
            continue
        ptxas = {k.split("hopper")[1].split("EEE")[0]: v
                 for k, v in cs._ptxas(log).items() if "hopper" in k}
        cs.emit({"variant": name, "ptxas": ptxas})
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))

    reference = {}  # the checked-in source's outputs, by case
    for name in list(libs) if checked else ():
        use(source, libs[name], libs.get("source"))
        gen = torch.Generator(device="cuda").manual_seed(5)
        worst, same = [0.0] * 4, True
        try:
            for i, case in enumerate(cases):
                res = check(case, gen, dtype)
                if res is None:
                    raise AssertionError(
                        f"two runs differ at {case}" + (
                            ", or fp16 K1–K3 differ from the rounding "
                            "copies route" if f16_in_kernel else ""))
                ratios, outs = res
                worst = [max(a, b) for a, b in zip(worst, ratios)]
                if name == "source":
                    reference[i] = outs
                elif "source" in libs:
                    same = same and all(map(torch.equal, outs, reference[i]))
                del res, outs
            if max(worst) > 1.0:
                raise AssertionError(f"err/tol {worst}")
            cs.emit({"variant": name, "check": "ok",
                     "dtype": str(dtype).removeprefix("torch."),
                     "worst_err_over_tol": dict(zip(
                         ("k1", "dq", "dk", "dv"), worst)),
                     **({"bits_equal_to_rounding_copies": True}
                        if f16_in_kernel else {}),
                     **({} if name == "source"
                        else {"bits_equal_to_source": same})})
        except (AssertionError, RuntimeError) as e:
            cs.emit({"variant": name, "check": "failed", "error": str(e)})
            del libs[name]
    reference.clear()

    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = cs._qkv_views(gen, B, S, H, D, dtype)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    sc = 1.0 / math.sqrt(D)
    out, lse = fa._flash_fwd_reference(q, k, v, causal, sc)
    delta = fa._delta(out, do)
    args = (q, k, v, do, lse, delta, causal, sc)
    fns = {"k1": lambda i: fa.flash_fwd(q, k, v, causal, sc),
           "k2": lambda i: fa.flash_bwd_dq(*args),
           "k3": lambda i: fa.flash_bwd_dkv(*args)}
    if f16_in_kernel:
        def copies(fn):
            def call(i):
                with cs._wrapper_rounding():
                    fn(i)
            return call
        fns.update(k1_copies=copies(fns["k1"]), k2_copies=copies(fns["k2"]),
                   k3_copies=copies(fns["k3"]))
    times = {n: {k: [] for k in fns} for n in libs}
    for name in list(libs) + list(libs)[::-1]:
        use(source, libs[name], libs.get("source"))
        for kn, fn in fns.items():
            if kn.startswith("k2") and not has_k2(libs[name]):
                continue  # the checked-in K2, timed as "source"
            times[name][kn].append(cs._device_ms(fn, 10,
                                                 cs._time_ms(fn, 30)) * 1e3)
    ql, kl, vl = (t.contiguous().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                            scale=sc)
        lib_bwd = lambda i: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                retain_graph=True)
        sdpa = [cs._device_ms(lib_bwd, 10, cs._time_ms(lib_bwd, 30)) * 1e3
                for _ in range(2)]
    cs.emit({"phase": "times", "source": source, "card": cs.CARD,
             "shape": {"B": B, "S": S, "H": H, "D": D, "causal": causal,
                       "dtype": str(dtype).removeprefix("torch.")},
             "checked": checked,
             "times": "device us per launch, in turns (queued CUDA events)",
             "kernel_us": times, "sdpa_flash_backward_us": sdpa})


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA GPU")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="flash_attention",
                    choices=sorted(SOURCES))
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16"))
    ap.add_argument("--shape", type=lambda x: tuple(map(int, x.split(","))))
    ap.add_argument("--unchecked", action="store_true")
    ap.add_argument("variants", nargs="*")
    a = ap.parse_args()
    shape = a.shape and (*a.shape[:4], bool(a.shape[4]))
    main(a.source, a.variants, getattr(torch, a.dtype), shape,
         not a.unchecked)
