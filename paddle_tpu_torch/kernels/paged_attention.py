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
  kernels ``csrc/paged_attention.cu`` (replaces the Pallas
  ``_decode_kernel``): they walk the block tables over the pool
  directly, so the ``[B, S]`` gathered view is never materialized.  The
  keys of a row are split into runs of ``blocks_per_split`` blocks
  (:func:`split_count`, from shapes alone): each CTA reduces one split
  to its online-softmax state ``(m, l, acc)`` in fp32 scratch, and the
  CTA that completes a (row, head) merges its splits in split order, in
  the same launch (flash-decoding).  On a CPU tensor the wrapper calls
  the plain version; on a CUDA tensor it launches the kernel or raises.
  ``paged_decode_attention.launches`` counts the wrapper's launches on
  float pools (K4), ``paged_decode_attention.quant_launches[kv_dtype]``
  those on int8/fp8 pools (K4q).
* :func:`paged_decode_attention_splits` and :func:`merge_splits` — a
  plain mirror of the kernel's split and merge arithmetic, for the
  tests; the main path never calls it.

Quantized KV (``kv_dtype`` "int8" or "fp8" e4m3) stores the pools one
byte a value with one fp32 scale per (block, position): per-token
symmetric absmax, quantized on insert by the model
(:func:`quantize_kv`).  The scale is a scalar per key token, so it
commutes with both attention contractions: the kernel multiplies each
key's logit by its K scale and each probability by its V scale in
registers, and the 1-byte tiles are never widened in device memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch
from ._shapes import NEG_INF, check_divides, check_equal

#: query dtype -> code of the C entry point
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 256
#: keys a split of the CUDA kernel aims at, and the most blocks one may
#: own (the kernel keeps a split's table entries in shared memory)
SPLIT_KEYS = 64
MAX_SPLIT_BLOCKS = 64
#: the most splits a (row, head) may have in the CUDA kernel: 4096 x 64
#: keys
MAX_SPLITS = 4096

#: serving ``kv_dtype`` string -> pool storage dtype.
KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

#: symmetric quantization range per kv_dtype (int8 integer grid; fp8
#: e4m3 max finite value).
KV_QMAX = {"int8": 127.0, "fp8": 448.0}

#: pool-type code of the C entry point, by pool dtype
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3, torch.float16: 4}


def quantize_kv(x, kv_dtype):
    """Per-token symmetric quantization of ``x[..., nh, hd]``: returns
    ``(q[..., nh, hd] in KV_DTYPES[kv_dtype], scale[...] fp32)`` where
    ``scale`` is one absmax-derived scalar per leading index (token).
    All-zero tokens (padded prefill tail) quantize to zeros with a unit
    epsilon scale.  int8 rounds half to even, as ``jnp.round``."""
    qmax = KV_QMAX[kv_dtype]
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = amax.clamp_min(1e-8) / qmax
    y = xf / scale[..., None, None]
    if kv_dtype == "int8":
        y = torch.round(y)
    return y.clamp(-qmax, qmax).to(KV_DTYPES[kv_dtype]), scale


def kv_dtype_of(dtype):
    """Map a pool storage dtype back to its ``kv_dtype`` name (None for
    unquantized full/half-precision pools)."""
    for name, d in KV_DTYPES.items():
        if d == dtype:
            return name
    return None


def dequantize_kv(q, scale):
    """Inverse of :func:`quantize_kv`: fp32 values from quantized tiles
    ``q[..., nh, hd]`` and per-token scales ``scale[...]``."""
    return q.float() * scale[..., None, None]


def paged_decode_attention_reference(q, pool_k, pool_v, bt, pos,
                                     scale_k=None, scale_v=None, *, scale):
    """Plain gather-mask-softmax decode attention.

    q ``[B, nh, hd]``, pool_k/pool_v ``[n_blocks, bs, nh, hd]``, bt ``[B,
    max_blocks]`` and pos ``[B]`` integer; with int8/fp8 pools,
    scale_k/scale_v ``[n_blocks, bs]`` fp32 per-token scales.  Returns
    fp32 ``[B, nh, hd]``: row ``b`` attends over keys ``kpos <= pos[b]``
    of its gathered sequence.  The math of ``GPT.decode_paged``'s gather
    twin (quantized pools gathered and dequantized to fp32), with the
    probabilities kept in fp32 for the value sum, as the kernel does."""
    B, nh, hd = q.shape
    bs = pool_k.shape[1]
    S = bt.shape[1] * bs
    idx = bt.long()
    if scale_k is None:
        gk = pool_k[idx].float()
        gv = pool_v[idx].float()
    else:
        gk = dequantize_kv(pool_k[idx], scale_k[idx])
        gv = dequantize_kv(pool_v[idx], scale_v[idx])
    gk = gk.reshape(B, S, nh, hd)
    gv = gv.reshape(B, S, nh, hd)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), gk) * scale
    kpos = torch.arange(S, device=q.device)
    live = kpos[None, :] <= pos.long()[:, None]                  # [B, S]
    logits = torch.where(live[:, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, gv)


def split_count(block_size, max_blocks):
    """``(blocks_per_split, n_split)`` of the CUDA kernel's grid: about
    ``SPLIT_KEYS`` keys a split, so the grid ``(nh, B, n_split)`` is a
    function of shapes alone (never of ``pos``).  At the engine's shape
    (64 blocks of 16) that is 4 blocks a split and 16 splits."""
    bps = max(1, min(-(-SPLIT_KEYS // block_size), max_blocks,
                     MAX_SPLIT_BLOCKS))
    return bps, -(-max_blocks // bps)


def paged_decode_attention_splits(q, pool_k, pool_v, bt, pos, scale_k=None,
                                  scale_v=None, *, scale, blocks_per_split):
    """Plain mirror of the CUDA kernel's split reduction: the
    online-softmax state of each run of ``blocks_per_split`` blocks of
    each (row, head).

    Returns fp32 ``(m [B, nh, n_split], l [B, nh, n_split], acc [B, nh,
    n_split, hd])``: ``m`` the split's max logit, ``l`` the sum of
    ``exp(logit - m)`` and ``acc`` the sum of ``exp(logit - m) · v`` over
    the split's live keys (K4q: logits scaled by ``sk``, values by
    ``sv``).  A split with no live key (it starts past ``pos[b]``) holds
    ``(NEG_INF, 0, 0)``; the kernel leaves its scratch unwritten and
    :func:`merge_splits` skips it either way."""
    B, nh, hd = q.shape
    bs = pool_k.shape[1]
    max_blocks = bt.shape[1]
    n_split = -(-max_blocks // blocks_per_split)
    S = n_split * blocks_per_split * bs
    idx = torch.zeros((B, n_split * blocks_per_split), dtype=torch.long,
                      device=q.device)
    idx[:, :max_blocks] = bt.long()
    if scale_k is None:
        gk, gv = pool_k[idx].float(), pool_v[idx].float()
    else:
        gk = dequantize_kv(pool_k[idx], scale_k[idx])
        gv = dequantize_kv(pool_v[idx], scale_v[idx])
    gk = gk.reshape(B, n_split, -1, nh, hd)
    gv = gv.reshape(B, n_split, -1, nh, hd)
    logits = torch.einsum("bhd,bcshd->bhcs", q.float(), gk) * scale
    kpos = torch.arange(S, device=q.device).reshape(n_split, -1)
    live = kpos[None] <= pos.long().clamp_max(max_blocks * bs - 1)[
        :, None, None]                                    # [B, c, s]
    live = live[:, None]                                  # [B, 1, c, s]
    neg = torch.full((), NEG_INF, device=q.device)
    logits = torch.where(live, logits, neg)
    m = logits.amax(-1)
    p = torch.where(live, torch.exp(logits - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = torch.einsum("bhcs,bcshd->bhcd", p, gv)
    return m, l, acc


def merge_splits(m, l, acc, pos, *, block_size, blocks_per_split,
                 max_blocks):
    """Plain mirror of the CUDA kernel's merge: the live splits of each
    (row, head) into fp32 ``[B, nh, hd]`` = ``sum_s acc_s · exp(m_s - M)
    / max(sum_s l_s · exp(m_s - M), 1e-30)``, M the splits' max (the
    kernel folds 16 splits at a time into a running max: the same sums up
    to fp32 rounding)."""
    n_split = m.shape[-1]
    keys = blocks_per_split * block_size
    n = (pos.long() + 1).clamp_max(max_blocks * block_size)
    live = torch.arange(n_split, device=m.device)[None] < (
        -(-n // keys))[:, None]                            # [B, n_split]
    live = live[:, None]
    neg = torch.full((), NEG_INF, device=m.device)
    big = torch.where(live, m, neg).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - big), torch.zeros((),
                                                         device=m.device))
    total = (l * w).sum(-1).clamp_min(1e-30)
    return (acc * w[..., None]).sum(-2) / total[..., None]


#: per device, the kernel's int32 split counts, one per (row, head): zero
#: between launches (the last CTA of a (row, head) sets its count back)
_COUNTS: dict[torch.device, torch.Tensor] = {}


def _split_counts(dev, n):
    buf = _COUNTS.get(dev)
    if buf is None or buf.numel() < n:
        buf = _COUNTS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=dev)
    return buf


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, I, P, P, P, P, P, P, P, I, I, I, I, I,
                       I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def paged_decode_attention(q, pool_k, pool_v, bt, pos, scale_k=None,
                           scale_v=None, *, scale):
    """Paged decode attention for B rows over the shared pool.

    q ``[B, nh, hd]`` fp32/bf16/fp16 (the rows' single query tokens),
    pool_k/pool_v ``[n_blocks, bs, nh, hd]`` (one layer's pool, already
    holding each row's new K/V at ``pos``): fp32/bf16/fp16, or int8/fp8 with
    their per-token fp32 scales scale_k/scale_v ``[n_blocks, bs]``.  bt
    ``[B, max_blocks]`` int32, pos ``[B]`` int32.  Returns fp32 ``[B,
    nh, hd]``.

    The caller guarantees that every ``bt`` value is below ``n_blocks``
    and that ``pos[b] < max_blocks * bs``: the wrapper checks shapes,
    dtypes, devices and contiguity, but never reads the tables back to
    the host.  Rows with nothing to attend are tabled to the trash block
    0 at position 0.
    """
    B, nh, hd = q.shape
    n_blocks, bs = pool_k.shape[0], pool_k.shape[1]
    max_blocks = bt.shape[1]
    kv_dtype = kv_dtype_of(pool_k.dtype)
    scales = tuple(t for t in (scale_k, scale_v) if t is not None)
    if len(scales) != (0 if kv_dtype is None else 2):
        raise ValueError(f"paged_attention: {pool_k.dtype} pools take "
                         + ("no scales" if kv_dtype is None
                            else "both scale_k and scale_v"))
    if any(t.dim() != 2 for t in scales):
        raise ValueError("paged_attention: scale_k/scale_v must be "
                         "[n_blocks, block_size]")
    check_equal(
        "paged_attention",
        pool_v_blocks=(pool_v.shape[0], n_blocks),
        pool_v_block_size=(pool_v.shape[1], bs),
        pool_k_heads=(pool_k.shape[2], nh),
        pool_v_heads=(pool_v.shape[2], nh),
        pool_k_head_dim=(pool_k.shape[3], hd),
        pool_v_head_dim=(pool_v.shape[3], hd),
        table_rows=(bt.shape[0], B),
        pos_rows=(pos.shape[0], B),
        **({"scale_k_blocks": (scale_k.shape[0], n_blocks),
            "scale_k_positions": (scale_k.shape[1], bs),
            "scale_v_blocks": (scale_v.shape[0], n_blocks),
            "scale_v_positions": (scale_v.shape[1], bs)} if scales else {}))
    check_divides("paged_attention", block_size=(bs, 1))
    devices = {t.device for t in (q, pool_k, pool_v, bt, pos, *scales)}
    if len(devices) != 1:
        raise ValueError(f"paged_attention: operands on several devices "
                         f"{sorted(map(str, devices))}")
    dev = q.device
    if dev.type == "cpu":
        return paged_decode_attention_reference(q, pool_k, pool_v, bt, pos,
                                                scale_k, scale_v, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {dev}")
    if q.dtype not in _Q_CODES or pool_k.dtype not in _POOL_CODES:
        raise TypeError(f"paged_attention: q {q.dtype} must be float32, "
                        f"bfloat16 or float16, pools {pool_k.dtype} "
                        "float32, bfloat16, float16, int8 or float8_e4m3fn")
    if (q.dtype == torch.float16) != (pool_k.dtype == torch.float16) and \
            kv_dtype is None:
        # the kernel is built for the pairs an fp16 model serves with
        raise TypeError(f"paged_attention: q {q.dtype} with pools "
                        f"{pool_k.dtype}: float16 q takes float16, int8 or "
                        "float8_e4m3fn pools, float16 pools a float16 q")
    if pool_v.dtype != pool_k.dtype:
        raise TypeError(f"paged_attention: pool_v {pool_v.dtype} != "
                        f"pool_k {pool_k.dtype}")
    if bt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"paged_attention: bt {bt.dtype} / pos "
                        f"{pos.dtype} must be int32")
    if any(t.dtype != torch.float32 for t in scales):
        raise TypeError("paged_attention: scale_k/scale_v must be float32")
    if not 1 <= hd <= _MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head dim {hd} outside "
                         f"[1, {_MAX_HEAD_DIM}]")
    if not 1 <= B <= 65535:
        raise ValueError(f"paged_attention: {B} rows outside the kernel's "
                         "grid range [1, 65535]")
    named = (("q", q), ("pool_k", pool_k), ("pool_v", pool_v), ("bt", bt),
             ("pos", pos)) + tuple(zip(("scale_k", "scale_v"), scales))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
        if name in ("q", "pool_k", "pool_v") and t.data_ptr() % 16:
            # the kernel reads these in vectors of up to 16 bytes
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             "aligned")
    bps, n_split = split_count(bs, max_blocks)
    if n_split > MAX_SPLITS:
        raise ValueError(f"paged_attention: {max_blocks} blocks of {bs} "
                         f"make {n_split} splits, above the kernel's "
                         f"{MAX_SPLITS}")
    part = torch.empty((B, nh, n_split, hd + 2), dtype=torch.float32,
                       device=dev)
    out = torch.empty((B, nh, hd), dtype=torch.float32, device=dev)
    count = _split_counts(dev, B * nh)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), _Q_CODES[q.dtype],
            pool_k.data_ptr(), pool_v.data_ptr(), _POOL_CODES[pool_k.dtype],
            scale_k.data_ptr() if scales else None,
            scale_v.data_ptr() if scales else None, bt.data_ptr(),
            pos.data_ptr(), part.data_ptr(), count.data_ptr(),
            out.data_ptr(), B, nh, hd, bs, max_blocks, bps, float(scale),
            stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"CUDA error {err} ({msg})")
    count_launch(paged_decode_attention, kv_dtype=kv_dtype)
    return out


#: kernel launches since the counters were last set to 0 (CUDA tensors
#: only; the CPU path never moves them): ``launches`` over fp32/bf16/fp16
#: pools (K4), ``quant_launches[kv_dtype]`` over int8/fp8 pools (K4q).
paged_decode_attention.launches = 0
paged_decode_attention.quant_launches = dict.fromkeys(KV_DTYPES, 0)


def sharded_paged_decode_attention(mesh, axis, q, pool_k, pool_v, bt, pos,
                                   scale_k=None, scale_v=None, *, scale):
    """Head-sharded :func:`paged_decode_attention` (the JAX version's
    ``shard_map`` over ``axis``).  ``q [B, nh/n, hd]`` and the pools
    ``[n_blocks, bs, nh/n, hd]`` are this rank's head slice (the serving
    arena holds them so), block tables, positions and scales are
    replicated: each rank launches K4 (K4q over int8/fp8 pools) on its
    slice and returns its ``[B, nh/n, hd]``.  No collective: the
    tensor-parallel all-reduce comes after the projection."""
    if q.shape[1] != pool_k.shape[2]:
        raise ValueError(f"sharded_paged_decode_attention: q holds "
                         f"{q.shape[1]} heads, the pool slice "
                         f"{pool_k.shape[2]} (mesh {axis}="
                         f"{mesh.degree(axis)})")
    return paged_decode_attention(q, pool_k, pool_v, bt, pos, scale_k,
                                  scale_v, scale=scale)


def reset_launch_counts():
    """Set K4's and K4q's launch counters to 0."""
    paged_decode_attention.launches = 0
    for k in paged_decode_attention.quant_launches:
        paged_decode_attention.quant_launches[k] = 0
