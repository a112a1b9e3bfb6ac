"""Operand preflight checks + the mask-fill constant (port of
``paddle_tpu/kernels/_shapes.py``).

* **Preflight** — a kernel launched with inconsistent operands reads out
  of bounds on the card instead of failing.  The validators here run in
  the wrapper, before the launch, and raise a ``ValueError`` that names
  the offending dimension and the kernel.
* **``NEG_INF``** — the additive mask fill.  ``neg_inf(dtype)`` is
  ``finfo(dtype).min``, the most negative *finite* value, so
  ``exp(fill - m)`` underflows to exactly 0 and an online softmax never
  computes ``inf - inf`` (the CUDA kernel masks with ``-FLT_MAX``, the
  same value).
"""

from __future__ import annotations

import torch


def neg_inf(dtype=torch.float32) -> float:
    """Most negative finite value of ``dtype`` — the dtype-aware mask
    fill (``torch.finfo(dtype).min``)."""
    return float(torch.finfo(dtype).min)


#: fp32 mask fill shared by the kernels' plain versions and the model's
#: attention (its logits are fp32).  Use ``neg_inf(dtype)`` for others.
NEG_INF = neg_inf(torch.float32)


def check_divides(kernel: str, **dims):
    """Each kwarg is ``name=(size, block)``: ``block`` must be a positive
    divisor of ``size``.  Raises ``ValueError`` naming the offending dim."""
    for name, (size, block) in dims.items():
        size, block = int(size), int(block)
        if block < 1:
            raise ValueError(
                f"{kernel}: block for dim '{name}' must be >= 1, got "
                f"{block}")
        if size % block:
            raise ValueError(
                f"{kernel}: dim '{name}'={size} is not divisible by its "
                f"block shape {block}; pick a block that divides {size}")


def check_equal(kernel: str, **dims):
    """Each kwarg is ``name=(got, want)``: operand-consistency preflight.
    Raises ``ValueError`` naming the offending dim."""
    for name, (got, want) in dims.items():
        if int(got) != int(want):
            raise ValueError(
                f"{kernel}: dim '{name}'={got} does not match the "
                f"required {want} (operand shapes disagree)")
