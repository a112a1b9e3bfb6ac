"""RMSNorm forward (port of ``paddle_tpu/kernels/rms_norm.py``).

Two functions, as in the reference:

* :func:`rms_norm_reference` — the plain math:
  ``(x·rsqrt(mean(x²) + eps)).astype(x.dtype) * w`` with the mean in
  fp32; the result's dtype is the promotion of ``x``'s and ``w``'s.
* :func:`rms_norm` — the wrapper of the hand-written CUDA kernel
  ``csrc/rms_norm.cu`` (replaces the Pallas ``_rms_kernel``), with the
  kernel's semantics: the output is stored in ``x.dtype``.  On a CPU
  tensor it calls the plain version; on a CUDA tensor it launches the
  kernel or raises.  ``rms_norm.launches`` counts the kernel launches.

The TPU kernel cannot store a product wider than ``x`` (x bf16, w fp32)
into its ``x.dtype`` output and refuses it; :func:`rms_norm` raises a
``TypeError`` for it on every device.  It takes (fp32, fp32), (bf16,
bf16) and (fp32, bf16).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_FLOATS = (torch.float32, torch.bfloat16)


def rms_norm_reference(x, w, eps=1e-6):
    """Plain RMSNorm of ``x[..., H]`` with weight ``w[H]``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _lib():
    lib = _build.load("rms_norm")
    fn = lib.rms_norm_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, I, P, I, I, ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
        lib.rms_norm_error_string.argtypes = [ctypes.c_int]
        lib.rms_norm_error_string.restype = ctypes.c_char_p
    return lib


def rms_norm(x, w, eps=1e-6, block_rows=256):
    """RMSNorm of ``x[..., H]`` with weight ``w[H]``, stored in
    ``x.dtype``.  ``block_rows`` is the TPU kernel's tiling knob; it is
    accepted and ignored (the CUDA kernel picks its own row grouping)."""
    del block_rows
    H = x.shape[-1]
    if tuple(w.shape) != (H,):
        raise ValueError(f"rms_norm: w has shape {tuple(w.shape)}, want "
                         f"({H},)")
    if torch.promote_types(x.dtype, w.dtype) != x.dtype:
        raise TypeError(f"rms_norm: w {w.dtype} is wider than x {x.dtype}; "
                        "the product cannot be stored in x's dtype")
    if x.device != w.device:
        raise ValueError(f"rms_norm: x on {x.device}, w on {w.device}")
    dev = x.device
    if dev.type == "cpu":
        return rms_norm_reference(x, w, eps).to(x.dtype)
    if dev.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {dev}")
    if x.dtype not in _FLOATS or w.dtype not in _FLOATS:
        raise TypeError(f"rms_norm: x {x.dtype} / w {w.dtype} must be "
                        "float32 or bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm: x and w must be contiguous")
    rows = x.numel() // max(H, 1)
    if H < 1 or not 1 <= rows <= 2 ** 31 - 1:
        raise ValueError(f"rms_norm: {rows} rows of {H} outside the "
                         "kernel's range")
    y = torch.empty_like(x)
    vec = (H % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
           and y.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rms_norm_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
            int(w.dtype == torch.bfloat16), y.data_ptr(), rows, H,
            float(eps), int(vec), stream)
    if err != 0:
        msg = lib.rms_norm_error_string(err).decode()
        raise RuntimeError(f"rms_norm launch failed: CUDA error {err} "
                           f"({msg})")
    count_launch(rms_norm)
    return y


#: kernel launches since the counter was last set to 0 (CUDA tensors
#: only; the CPU path never moves it).
rms_norm.launches = 0
