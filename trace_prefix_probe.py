"""Which kernels does ``torch.profiler`` drop from a trace as a process
ages, and does ``chip_smoke._profile``'s pre-roll take the loss?

One GPT-3 760M-width step (2 layers, batch 2 x 1024, forward and backward
through K1-K3) is traced at each age in ``--ages`` (seconds after start):
bare (no pre-roll), with a time margin before and after the call, and
through ``chip_smoke._profile``.  A bare trace's kernel names are aligned
with the first bare trace's, and what is missing is printed as index
ranges of the reference; ``_profile``'s line gives the pre-roll kernels it
kept and the K1-K3 launches it saw.  One JSON line per trace, the card's
name and power limit first.

    python3 trace_prefix_probe.py [--ages 0 280 400]
"""
import argparse
import difflib
import json
import subprocess
import time

import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build

ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]


def bare(fn, margin_s):
    """The kernels of one traced call of ``fn``, in device order."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTS) as prof:
        time.sleep(margin_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.start_ns())
    return [e.name()[:60] for e in evs]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ages", type=float, nargs="+", default=[0, 280, 400])
    args = ap.parse_args()
    t0 = time.perf_counter()
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.build("flash_attention")
    _build.load("flash_attention")
    cfg = cs._train_cfg(num_layers=2)
    model = cs.GPTForCausalLM(cfg, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    crit = cs.GPTPretrainingCriterion()
    ids, labels = cs._batch(cfg, 2, 1024, seed=1)

    def step():
        crit(model(ids), labels).backward()

    step()
    ref = None
    for age in args.ages:
        while time.perf_counter() - t0 < age + 20:
            time.sleep(1)
        for margin_s in (0.0, 0.1, 0.5):
            names = bare(step, margin_s)
            ref = ref or names
            lost = [[i1, i2] for tag, i1, i2, _, _ in difflib.SequenceMatcher(
                None, ref, names, autojunk=False).get_opcodes()
                    if tag != "equal"]
            print(json.dumps({"age_s": time.perf_counter() - t0,
                              "trace": "bare", "margin_s": margin_s,
                              "kernels": len(names), "reference": len(ref),
                              "missing_ranges": lost}), flush=True)
        cs._reset_flash_counts()
        prof = cs._profile(step, top=0)
        print(json.dumps({
            "age_s": time.perf_counter() - t0, "trace": "_profile",
            "preroll_kernels": cs.PREROLL_KERNELS,
            "preroll_kernels_kept": prof["preroll_kernels_kept"],
            "flash_kernels_run": prof["flash_kernels_run"],
            "flash_launches_counted": {fn.__name__: fn.launches
                                       for fn in cs.FLASH_KERNELS}}),
              flush=True)


if __name__ == "__main__":
    main()
