"""Paged decode attention in the PyTorch port against the JAX reference.

The port's plain version (the CPU path of its CUDA kernel's wrapper) is
held against the JAX ``paged_decode_attention`` Pallas kernel run in
interpret mode, on the same numpy inputs, and so is a plain mirror of
the CUDA kernel's split-K arithmetic (per-split online-softmax states
and their merge).  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against the plain version.

Tolerance: atol 1e-5 for fp32, bf16, int8 and fp8 pools.  Both sides
compute in fp32 (bf16 q and pools, and the 1-byte values times their
per-token scales, are widened exactly to fp32 before any arithmetic), so
they differ only in the order of fp32 sums over at most 20 keys of unit
scale.  The int8/fp8 pools are quantized by each package's own
``quantize_kv`` (bit-equal: ``tests/test_torch_quant_serving.py``).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as tpa

ATOL = 1e-5


@pytest.fixture()
def interpret_mode():
    jpa._INTERPRET[0] = True
    yield
    jpa._INTERPRET[0] = False


def _random_case(rng, B=3, nh=2, hd=8, n_blocks=16, bs=4, max_blocks=5):
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    pool_k = rng.standard_normal((n_blocks, bs, nh, hd)).astype(np.float32)
    pool_v = rng.standard_normal((n_blocks, bs, nh, hd)).astype(np.float32)
    # distinct physical blocks per row, deliberately out of order
    perm = rng.permutation(n_blocks)[:B * max_blocks]
    bt = perm.reshape(B, max_blocks).astype(np.int32)
    pos = rng.integers(0, max_blocks * bs, size=B).astype(np.int32)
    return q, pool_k, pool_v, bt, pos


def _case(kind, rng):
    q, pk, pv, bt, pos = _random_case(rng)
    bs, max_blocks = pk.shape[1], bt.shape[1]
    if kind == "pos0":
        pos[:] = 0
    elif kind == "block_boundaries":
        # last slot of a block, first slot of the next, the very last slot
        pos[:] = [bs - 1, bs, max_blocks * bs - 1]
    elif kind == "shared_blocks":
        # rows 1 and 2 share row 0's first two physical blocks (a prefix)
        bt[1:, :2] = bt[0, :2]
        pos[:] = [2 * bs + 1, 3 * bs - 1, bs + 2]
    elif kind == "trash_row":
        # an idle row tabled to the trash block 0 at position 0
        bt[2] = 0
        pos[2] = 0
    return q, pk, pv, bt, pos


_KINDS = ["random", "pos0", "block_boundaries", "shared_blocks",
          "trash_row"]


#: the float pool dtypes of both packages (fp16: B-ii's instance)
_FLOATS = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16),
           "float16": (jnp.float16, torch.float16)}


def _as_bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8",
                                   "fp8"])
@pytest.mark.parametrize("kind", _KINDS)
def test_plain_version_matches_jax_kernel(interpret_mode, kind, dtype):
    rng = np.random.default_rng(_KINDS.index(kind))
    q, pk, pv, bt, pos = _case(kind, rng)
    scale = 1.0 / np.sqrt(q.shape[-1])
    if dtype in tpa.KV_DTYPES:   # fp32 q over quantized pools and scales
        jpools = [jpa.quantize_kv(jnp.asarray(p), dtype) for p in (pk, pv)]
        tpools = [tpa.quantize_kv(torch.from_numpy(p), dtype)
                  for p in (pk, pv)]
        ref = np.asarray(jpa.paged_decode_attention(
            jnp.asarray(q), jpools[0][0], jpools[1][0], jnp.asarray(bt),
            jnp.asarray(pos), jpools[0][1], jpools[1][1], scale=scale))
        args = (torch.from_numpy(q), tpools[0][0], tpools[1][0],
                torch.from_numpy(bt), torch.from_numpy(pos), tpools[0][1],
                tpools[1][1])
    else:
        jdt, tdt = _FLOATS[dtype]
        ref = np.asarray(jpa.paged_decode_attention(
            jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
            jnp.asarray(bt), jnp.asarray(pos), scale=scale))
        if dtype == "bfloat16":
            q, pk, pv = _as_bf16(q), _as_bf16(pk), _as_bf16(pv)
        args = (torch.from_numpy(q).to(tdt), torch.from_numpy(pk).to(tdt),
                torch.from_numpy(pv).to(tdt), torch.from_numpy(bt),
                torch.from_numpy(pos))
    out = tpa.paged_decode_attention_reference(*args, scale=scale)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    # the wrapper takes the plain version on CPU tensors
    np.testing.assert_array_equal(
        tpa.paged_decode_attention(*args, scale=scale).numpy(), out.numpy())


def test_pos0_returns_first_value():
    rng = np.random.default_rng(11)
    q, pk, pv, bt, pos = _random_case(rng, B=2)
    pos[:] = 0
    out = tpa.paged_decode_attention_reference(
        *map(torch.from_numpy, (q, pk, pv, bt, pos)), scale=0.5)
    np.testing.assert_allclose(out.numpy(), pv[bt[:, 0], 0], atol=1e-6)


def test_cpu_tensors_never_launch_the_kernel():
    rng = np.random.default_rng(12)
    q, pk, pv, bt, pos = (torch.from_numpy(a) for a in _random_case(rng))
    tpa.paged_decode_attention(q, pk, pv, bt, pos, scale=0.3)
    (qk, sk), (qv, sv) = (tpa.quantize_kv(p, "fp8") for p in (pk, pv))
    tpa.paged_decode_attention(q, qk, qv, bt, pos, sk, sv, scale=0.3)
    assert tpa.paged_decode_attention.launches == 0
    assert tpa.paged_decode_attention.quant_launches == {"int8": 0,
                                                         "fp8": 0}


def test_quantized_pools_need_matching_scales():
    rng = np.random.default_rng(13)
    q, pk, pv, bt, pos = (torch.from_numpy(a) for a in _random_case(rng))
    qk, sk = tpa.quantize_kv(pk, "int8")
    qv, sv = tpa.quantize_kv(pv, "int8")
    with pytest.raises(ValueError, match="no scales"):
        tpa.paged_decode_attention(q, pk, pv, bt, pos, sk, sv, scale=1.0)
    with pytest.raises(ValueError, match="scale_k and scale_v"):
        tpa.paged_decode_attention(q, qk, qv, bt, pos, scale=1.0)
    with pytest.raises(ValueError, match="scale_v_positions"):
        tpa.paged_decode_attention(q, qk, qv, bt, pos, sk, sv[:, :-1],
                                   scale=1.0)


def test_shape_mismatch_names_the_dim():
    rng = np.random.default_rng(14)
    q, pk, pv, bt, pos = (torch.from_numpy(a) for a in _random_case(rng))
    with pytest.raises(ValueError, match="table_rows"):
        tpa.paged_decode_attention(q, pk, pv, bt[:2], pos, scale=1.0)


# ---------------------------------------------------------------------------
# the CUDA kernel's split-K arithmetic (plain mirror), against the JAX kernel
# ---------------------------------------------------------------------------
def _split_inputs(dtype, rng):
    """fp32 q over pools of ``dtype``: row 0 ends in the first block (its
    later splits are all masked), row 1 at the last slot, row 2 is an idle
    row tabled to the trash block 0 at position 0."""
    q, pk, pv, bt, pos = _random_case(rng)
    bs, max_blocks = pk.shape[1], bt.shape[1]
    pos[:] = [2, max_blocks * bs - 1, 0]
    bt[2] = 0
    scale = 1.0 / np.sqrt(q.shape[-1])
    if dtype in tpa.KV_DTYPES:
        jpools = [jpa.quantize_kv(jnp.asarray(p), dtype) for p in (pk, pv)]
        tpools = [tpa.quantize_kv(torch.from_numpy(p), dtype)
                  for p in (pk, pv)]
        ref = np.asarray(jpa.paged_decode_attention(
            jnp.asarray(q), jpools[0][0], jpools[1][0], jnp.asarray(bt),
            jnp.asarray(pos), jpools[0][1], jpools[1][1], scale=scale))
        args = (torch.from_numpy(q), tpools[0][0], tpools[1][0],
                torch.from_numpy(bt), torch.from_numpy(pos), tpools[0][1],
                tpools[1][1])
    else:
        jdt, tdt = _FLOATS[dtype]
        ref = np.asarray(jpa.paged_decode_attention(
            jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
            jnp.asarray(bt), jnp.asarray(pos), scale=scale))
        if dtype == "bfloat16":
            q, pk, pv = _as_bf16(q), _as_bf16(pk), _as_bf16(pv)
        args = (torch.from_numpy(q).to(tdt), torch.from_numpy(pk).to(tdt),
                torch.from_numpy(pv).to(tdt), torch.from_numpy(bt),
                torch.from_numpy(pos))
    return args, ref, scale


# split sizes in blocks: one block (bs keys), 4 blocks, and more blocks
# than any row has (a single split)
_SPLIT_BLOCKS = {"bs": 1, "4bs": 4, "beyond_rows": 7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8",
                                   "fp8"])
@pytest.mark.parametrize("split", list(_SPLIT_BLOCKS))
def test_split_mirror_matches_jax_kernel(interpret_mode, split, dtype):
    rng = np.random.default_rng(20 + list(_SPLIT_BLOCKS).index(split))
    args, ref, scale = _split_inputs(dtype, rng)
    bps = _SPLIT_BLOCKS[split]
    bs, max_blocks = args[1].shape[1], args[3].shape[1]
    m, l, acc = tpa.paged_decode_attention_splits(
        *args, scale=scale, blocks_per_split=bps)
    n_split = -(-max_blocks // bps)
    B, nh, hd = args[0].shape
    assert m.shape == l.shape == (B, nh, n_split)
    assert acc.shape == (B, nh, n_split, hd)
    # splits that start past pos hold the empty state, which the merge
    # skips: row 0 (pos 2) and the trash row (pos 0) live in split 0 only
    pos = args[4].long()
    live = torch.arange(n_split)[None] * bps * bs <= pos[:, None]
    assert live[:, 0].all()
    for b in (0, 2):
        assert live[b].sum() == 1
        assert (m[b, :, 1:] == tpa.NEG_INF).all()
        assert (l[b, :, 1:] == 0).all() and (acc[b, :, 1:] == 0).all()
    out = tpa.merge_splits(m, l, acc, args[4], block_size=bs,
                           blocks_per_split=bps, max_blocks=max_blocks)
    assert out.dtype == torch.float32 and np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    # and the plain version the CPU path runs
    np.testing.assert_allclose(
        out.numpy(), tpa.paged_decode_attention_reference(
            *args, scale=scale).numpy(), rtol=0, atol=ATOL)


def test_split_count_depends_on_shapes_only():
    # about SPLIT_KEYS keys a split: 4 blocks of 16 at the engine's shape
    assert tpa.SPLIT_KEYS == 64
    assert tpa.split_count(16, 64) == (4, 16)
    assert tpa.split_count(16, 512) == (4, 128)
    assert tpa.split_count(4, 6) == (6, 1)        # fewer blocks than a split
    assert tpa.split_count(4, 64) == (16, 4)
    assert tpa.split_count(3, 100) == (22, 5)     # 66 keys a split
    assert tpa.split_count(128, 8) == (1, 8)      # blocks above SPLIT_KEYS
    assert tpa.split_count(1, 1000) == (tpa.MAX_SPLIT_BLOCKS, 16)
    # the grid follows (block size, table width) alone: no pos argument
    assert list(inspect.signature(tpa.split_count).parameters) == [
        "block_size", "max_blocks"]
