"""Kernels of the port: each hand-written CUDA kernel beside its plain
PyTorch version (see ``paged_attention``)."""

import threading

_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, n=1, kv_dtype=None):
    """Add ``n`` to ``wrapper.launches`` (or, with ``kv_dtype``, to
    ``wrapper.quant_launches[kv_dtype]``) under one lock: fleet replicas
    step their engines from several threads, and ``+=`` on an attribute
    is a read and a write another thread can come between."""
    with _COUNT_LOCK:
        if kv_dtype is None:
            wrapper.launches += n
        else:
            wrapper.quant_launches[kv_dtype] += n


def launch_counted():
    """Every kernel wrapper that counts its launches in ``.launches``
    (K1–K3, K4, K5): a captured CUDA graph records what its capture
    counted and adds it on each replay (``jit.CompiledTrainStep``)."""
    from . import flash_attention, paged_attention, rms_norm
    return (flash_attention.flash_fwd, flash_attention.flash_bwd_dq,
            flash_attention.flash_bwd_dkv,
            paged_attention.paged_decode_attention, rms_norm.rms_norm)
