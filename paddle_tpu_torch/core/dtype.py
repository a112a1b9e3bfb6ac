"""Paddle dtype names over ``torch.dtype`` (port of
``paddle_tpu/core/dtype.py``).

``convert_dtype`` takes a Paddle name (``"float32"``, ``"bf16"``, ...),
a ``torch.dtype`` or a numpy dtype and returns the ``torch.dtype``.
Paddle's defaults for data without a dtype are kept by ``core.tensor``:
float64 data becomes float32 and Python ints become int64.

Promotion of two tensors is ``torch.promote_types``: it is jnp's lattice
for these types (wider float wins, int + float gives the float, fp16 +
bf16 gives fp32).  Where torch and jnp differ is a 0-d tensor, which
torch ranks below a tensor of the same category (bf16 ``[n]`` × fp32
0-d stays bf16 in torch, becomes fp32 in jnp): ``core.tensor``'s binary
ops cast both operands to ``torch.promote_types`` first.
"""

from __future__ import annotations

import numpy as np
import torch

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_NAME_TO_DTYPE = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "bool": bool_,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
}


def convert_dtype(dtype):
    """A user's dtype (Paddle name, ``torch.dtype``, numpy dtype or
    type) as a ``torch.dtype``; ``None`` stays ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _NAME_TO_DTYPE:
            raise ValueError(f"unknown dtype string: {dtype!r}")
        return _NAME_TO_DTYPE[dtype]
    name = np.dtype(dtype).name   # numpy types, ml_dtypes' bfloat16
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    return str(convert_dtype(dtype)).removeprefix("torch.")
