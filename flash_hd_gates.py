#!/usr/bin/env python3
"""Calibrate flash_hd_in_model's self-calibrated gates on one NVIDIA GPU.

    python3 flash_hd_gates.py

``chip_smoke.py``'s flash_hd_in_model runs a 2-layer encoder of 16 heads
of 256 (B 4 x S 1024) forward and backward in bf16 and fp32, through
K1–K3 and through their plain versions, and holds the two paths' outputs
and input gradients to each other with ``_self_calibrated``, whose third
gate bounds each row of one path's bf16 result by the other path's own
bf16 noise in that row.  This script runs that model on three inputs
(seeds 13, 14, 15; 13 is the phase's) with four attention paths in bf16:

* ``d256``: the kernels as the wrapper routes them (K1 and K3 in
  ``flash_attention_d256.cu``, K2 in ``flash_attention_mma.cu``);
* ``mma``: K1–K3 all in ``flash_attention_mma.cu`` (the ``mma.sync``
  instances that ``flash_attention_d256.cu`` replaced at D 256);
* ``coarse1``, ``coarse2``: the plain versions with every bf16 product
  operand cut to 7 or 6 mantissa bits (faults the gate is there to
  catch: one path rounding coarser than bf16),

and prints for each, against the plain bf16 path, the third gate's
worst row by its max (bound: twice the other path's row max noise) and
by its RMS (bound: ``ROW_RMS_FACTOR`` times the other path's row RMS
noise), each with the floor, for the output and the input gradient.
One JSON line per (input, path).  Then, on the K1 inputs of the first
input's bf16 run (each layer's q, k, v), K1 of ``d256`` and of ``mma``
against an fp64 softmax attention of the same bf16 operands: RMS, max
and mean signed error, and the share of outputs bit-equal to the plain
version's.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import flash_attention as fa

SEEDS = (13, 14, 15)
FLASH_FWD = fa.flash_fwd


def capturing(into):
    """K1's wrapper, keeping a copy of each call's operands."""
    def flash_fwd(q, k, v, causal, scale):
        into.append((q.clone(), k.clone(), v.clone(), causal, scale))
        return FLASH_FWD(q, k, v, causal, scale)
    flash_fwd.launches = 0
    return flash_fwd


def k1_against_fp64(q, k, v, causal, scale, paths):
    """K1 of the ``d256`` and ``mma`` paths on (q, k, v) against fp64
    attention over the same bf16 values."""
    s = q.double() @ k.double().transpose(-1, -2) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool,
                                      device=s.device).tril(), -torch.inf)
    exact = torch.softmax(s, -1) @ v.double()
    del s
    plain = fa._flash_fwd_reference(q, k, v, causal, scale)[0]
    out = {}
    for name in ("d256", "mma"):
        fa._library = paths[name][0]
        try:
            got = fa.flash_fwd(q, k, v, causal, scale)[0]
        finally:
            fa._library = paths["d256"][0]
        err = got.double() - exact
        out[name] = {"rms_err": float(err.pow(2).mean().sqrt()),
                     "max_err": float(err.abs().max()),
                     "mean_err": float(err.mean()),
                     "bit_equal_to_plain": float((got == plain).double()
                                                 .mean())}
    out["exact_rms"] = float(exact.pow(2).mean().sqrt())
    return out


def coarse_operand(bits_dropped):
    """``fa._operand`` with 16-bit operands cut to ``8 - bits_dropped``
    mantissa bits (bf16 first, then the low bits cleared)."""
    keep = ~((1 << bits_dropped) - 1)

    def operand(x, low):
        if not low:
            return x.float()
        bits = x.to(torch.bfloat16).view(torch.int16) & keep
        return bits.view(torch.bfloat16).float()
    return operand


def main():
    cs.device_phase()
    routed, plain_operand = fa._library, fa._operand
    paths = {
        "d256": (routed, plain_operand, False),
        "mma": (lambda D, dtype, kernel="fwd": "flash_attention_mma",
                plain_operand, False),
        "coarse1": (routed, coarse_operand(1), True),
        "coarse2": (routed, coarse_operand(2), True),
    }
    enc = cs._hd_encoder()
    captured = []  # each layer's K1 operands in the first d256 run
    for seed in SEEDS:
        xs, gs = cs._hd_inputs(seed)
        base = {key: cs._hd_run(enc, xs, gs, *key)
                for key in (("O2", True), ("O0", False), ("O0", True))}
        for name, (library, operand, plain) in paths.items():
            fa._library, fa._operand = library, operand
            if name == "d256" and not captured:
                fa.flash_fwd = capturing(captured)
            try:
                a16 = cs._hd_run(enc, xs, gs, "O2", plain)
            finally:
                fa._library, fa._operand = routed, plain_operand
                fa.flash_fwd = FLASH_FWD
            rec = {"seed": seed, "path": name, "card": cs.CARD}
            for i, what in enumerate(("output", "input_grad")):
                floor = (cs.SELF_CALIBRATED_FLOOR if i == 0
                         else cs.BERT_GRAD_FLOOR)
                args = (a16[i], base[("O2", True)][i],
                        base[("O0", False)][i], base[("O0", True)][i], floor)
                by_max, max_ok = cs._self_calibrated_record(*args, "max")
                by_rms, rms_ok = cs._self_calibrated_record(*args, "rms")
                rec[what] = {
                    "row_max": [by_max["a16_vs_b32_over_bound"],
                                by_max["b16_vs_a32_over_bound"]],
                    "row_max_passes": max_ok,
                    "row_rms": [by_rms["a16_vs_b32_over_bound"],
                                by_rms["b16_vs_a32_over_bound"]],
                    "row_rms_passes": rms_ok}
            cs.emit(rec)
        del base
    del enc
    for layer, (q, k, v, causal, scale) in enumerate(captured):
        cs.emit({"layer": layer, "card": cs.CARD,
                 **k1_against_fp64(q, k, v, causal, scale, paths)})


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("flash_hd_gates: needs a CUDA GPU")
    main()
