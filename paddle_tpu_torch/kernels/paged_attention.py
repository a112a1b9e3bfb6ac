"""Paged decode attention (port of ``paddle_tpu/kernels/paged_attention.py``).

The decode step attends every row's single query over its logical
sequence, which lives in physical blocks of a shared pool
``[n_blocks, bs, nh, hd]`` named by the row's int32 block table.  Two
versions of the same function live here:

* :func:`paged_decode_attention_reference` — the plain version: gather
  ``pool[bt] -> [B, S, nh, hd]``, mask ``kpos > pos`` with the finite
  ``NEG_INF``, fp32 softmax, fp32 weighted sum.  The CPU path, and what
  the CUDA kernel is held against on the card.
* :func:`paged_decode_attention` — the wrapper of the hand-written CUDA
  kernel ``csrc/paged_attention.cu`` (replaces the Pallas
  ``_decode_kernel``): it walks the block tables over the pool directly,
  so the ``[B, S]`` gathered view is never materialized.  On a CPU
  tensor it calls the plain version; on a CUDA tensor it launches the
  kernel or raises.  ``paged_decode_attention.launches`` counts the
  kernel launches.

Quantized pools (``scale_k``/``scale_v``) are a later slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._shapes import NEG_INF, check_divides, check_equal

_FLOATS = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256
_QUANT_TODO = ("quantized KV pools (scale_k/scale_v) are not ported yet: "
               "ROADMAP.md A3 (quantized KV, kernel K4q)")


def paged_decode_attention_reference(q, pool_k, pool_v, bt, pos, *, scale):
    """Plain gather-mask-softmax decode attention.

    q ``[B, nh, hd]``, pool_k/pool_v ``[n_blocks, bs, nh, hd]``, bt ``[B,
    max_blocks]`` and pos ``[B]`` integer.  Returns fp32 ``[B, nh, hd]``:
    row ``b`` attends over keys ``kpos <= pos[b]`` of its gathered
    sequence.  The math of ``GPT.decode_paged``'s gather twin, with the
    probabilities kept in fp32 for the value sum, as the kernel does."""
    B, nh, hd = q.shape
    bs = pool_k.shape[1]
    S = bt.shape[1] * bs
    idx = bt.long()
    gk = pool_k[idx].reshape(B, S, nh, hd).float()
    gv = pool_v[idx].reshape(B, S, nh, hd).float()
    logits = torch.einsum("bhd,bshd->bhs", q.float(), gk) * scale
    kpos = torch.arange(S, device=q.device)
    live = kpos[None, :] <= pos.long()[:, None]                  # [B, S]
    logits = torch.where(live[:, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, gv)


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, I, P, P, P, I, I, I, I, I,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def paged_decode_attention(q, pool_k, pool_v, bt, pos, scale_k=None,
                           scale_v=None, *, scale):
    """Paged decode attention for B rows over the shared pool.

    q ``[B, nh, hd]`` fp32/bf16 (the rows' single query tokens),
    pool_k/pool_v ``[n_blocks, bs, nh, hd]`` fp32/bf16 (one layer's pool,
    already holding each row's new K/V at ``pos``), bt ``[B, max_blocks]``
    int32, pos ``[B]`` int32.  Returns fp32 ``[B, nh, hd]``.

    The caller guarantees that every ``bt`` value is below ``n_blocks``
    and that ``pos[b] < max_blocks * bs``: the wrapper checks shapes,
    dtypes, devices and contiguity, but never reads the tables back to
    the host.  Rows with nothing to attend are tabled to the trash block
    0 at position 0.
    """
    if scale_k is not None or scale_v is not None:
        raise NotImplementedError(_QUANT_TODO)
    B, nh, hd = q.shape
    n_blocks, bs = pool_k.shape[0], pool_k.shape[1]
    max_blocks = bt.shape[1]
    check_equal(
        "paged_attention",
        pool_v_blocks=(pool_v.shape[0], n_blocks),
        pool_v_block_size=(pool_v.shape[1], bs),
        pool_k_heads=(pool_k.shape[2], nh),
        pool_v_heads=(pool_v.shape[2], nh),
        pool_k_head_dim=(pool_k.shape[3], hd),
        pool_v_head_dim=(pool_v.shape[3], hd),
        table_rows=(bt.shape[0], B),
        pos_rows=(pos.shape[0], B))
    check_divides("paged_attention", block_size=(bs, 1))
    devices = {t.device for t in (q, pool_k, pool_v, bt, pos)}
    if len(devices) != 1:
        raise ValueError(f"paged_attention: operands on several devices "
                         f"{sorted(map(str, devices))}")
    dev = q.device
    if dev.type == "cpu":
        return paged_decode_attention_reference(q, pool_k, pool_v, bt, pos,
                                                scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {dev}")
    if q.dtype not in _FLOATS or pool_k.dtype not in _FLOATS:
        raise TypeError(f"paged_attention: q {q.dtype} / pools "
                        f"{pool_k.dtype} must be float32 or bfloat16")
    if pool_v.dtype != pool_k.dtype:
        raise TypeError(f"paged_attention: pool_v {pool_v.dtype} != "
                        f"pool_k {pool_k.dtype}")
    if bt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"paged_attention: bt {bt.dtype} / pos "
                        f"{pos.dtype} must be int32")
    if not 1 <= hd <= _MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head dim {hd} outside "
                         f"[1, {_MAX_HEAD_DIM}]")
    if not 1 <= B <= 65535:
        raise ValueError(f"paged_attention: {B} rows outside the kernel's "
                         "grid range [1, 65535]")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("bt", bt), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
        if name in ("q", "pool_k", "pool_v") and t.data_ptr() % 16:
            # the kernel reads these in vectors of up to 16 bytes
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             "aligned")
    out = torch.empty((B, nh, hd), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), int(q.dtype == torch.bfloat16),
            pool_k.data_ptr(), pool_v.data_ptr(),
            int(pool_k.dtype == torch.bfloat16), bt.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, nh, hd, bs, max_blocks,
            float(scale), stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"CUDA error {err} ({msg})")
    paged_decode_attention.launches += 1
    return out


#: kernel launches since the counter was last set to 0 (CUDA tensors
#: only; the CPU path never moves it).
paged_decode_attention.launches = 0
