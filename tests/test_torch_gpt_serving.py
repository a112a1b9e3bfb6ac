"""GPT paged prefill/decode of the PyTorch port against the JAX package.

Both packages get the same weights (the JAX model's ``state_dict`` as
numpy arrays, loaded by ``load_numpy_state``) and the same numpy inputs.
One ``prefill_paged`` chunk, a second chunk that reads the first chunk's
blocks, then one ``decode_paged`` step over three rows (two live, one
idle row tabled to the trash block) must give the same logits and the
same pool contents.  JAX decode runs both through its plain gather
(``kernel="off"``) and through the Pallas kernel in interpret mode.

Tolerance: fp32, atol 1e-4 and rtol 1e-4 — two fp32 implementations of
the same 2-layer model whose matmuls and softmax sums run in different
orders.  bf16 (the dtype the card serves): each package is also run in
fp32 on the same bf16 weights and inputs, and the port's bf16 logits and
pools are held to the JAX package's within twice the JAX package's own
distance (max abs) from its fp32 run — the reference's bf16 rounding
noise, measured per case — plus the fp32 tolerance at the case's scale,
with equal greedy tokens.  The bound does not grow with the port's own
error; measured, the port's distance is at most 1.61 times the
reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.2)
BS, N_BLOCKS, MAX_BLOCKS = 4, 12, 8


@pytest.fixture()
def interpret_mode():
    jpa._INTERPRET[0] = True
    yield
    jpa._INTERPRET[0] = False


def _models(use_rope):
    paddle.seed(5 + use_rope)
    jm = JGPT(JConfig(use_flash_attention=False, use_rope=use_rope, **CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(use_rope=use_rope, **CFG), device="cpu")
    tm.load_numpy_state({k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("use_rope", [False, True])
def test_prefill_and_decode_match_jax(interpret_mode, use_rope):
    jm, tm = _models(use_rope)
    jw, tw = jm.decode_state(), tm.decode_state()
    L, nh = CFG["num_layers"], CFG["num_heads"]
    hd = CFG["hidden_size"] // nh
    shape = (L, N_BLOCKS, BS, nh, hd)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    rng = np.random.default_rng(use_rope)
    prompt = rng.integers(0, CFG["vocab_size"], 13)
    table = np.array([3, 5, 1, 7, 0, 0, 0, 0], np.int32)

    # chunk 1: tokens [0, 8); chunk 2: tokens [8, 13) padded to 8, which
    # reads chunk 1's blocks and writes its padded tail to the trash block
    for start, length in ((0, 8), (8, 5)):
        ids = np.zeros((1, 8), np.int32)
        ids[0, :length] = prompt[start:start + length]
        jk, jv, jl = jm.prefill_paged(jw, jnp.asarray(ids), start, length,
                                      jnp.asarray(table), jk, jv)
        tl = tm.prefill_paged(tw, torch.from_numpy(ids).long(), start,
                              length, torch.from_numpy(table), tk, tv)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
        np.testing.assert_allclose(_np(tv), _np(jv), **TOL)

    # decode: row 0 continues the prompt at position 13, row 1 is a second
    # live row over other blocks, row 2 is idle (trash block, position 0)
    tok = np.array([int(prompt[-1]), 9, 0], np.int32)
    pos = np.array([13, 5, 0], np.int32)
    bt = np.zeros((3, MAX_BLOCKS), np.int32)
    bt[0] = table
    bt[1, :2] = [2, 4]
    targs = [torch.from_numpy(a) for a in (tok, pos, bt)]
    tl = tm.decode_paged(tw, *targs, tk, tv)
    assert np.isfinite(_np(tl)).all()
    for kernel in ("off", "pallas"):
        jl, jk2, jv2 = jm.decode_paged(
            jw, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(bt), jk, jv,
            kernel=kernel)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_allclose(_np(tk), _np(jk2), **TOL)
        np.testing.assert_allclose(_np(tv), _np(jv2), **TOL)

    # the plain attention inside the model gives the same logits
    tk2, tv2 = tk.clone(), tv.clone()
    tl2 = tm.decode_paged(tw, *targs, tk2, tv2, kernel=False)
    np.testing.assert_allclose(_np(tl2), _np(tl), rtol=0, atol=1e-6)


def _bf16_pair(use_rope, dtype):
    """Both packages in ``dtype`` on the same bf16-rounded weights."""
    paddle.seed(15 + use_rope)
    src = JGPT(JConfig(use_flash_attention=False, use_rope=use_rope, **CFG))
    w = {k: np.asarray(jnp.asarray(v.numpy(), jnp.bfloat16)
                       .astype(jnp.float32))
         for k, v in src.state_dict().items()}
    jm = JGPT(JConfig(use_flash_attention=False, use_rope=use_rope,
                      dtype=dtype, **CFG))
    jm.set_state_dict(w)
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(use_rope=use_rope, dtype=dtype, **CFG),
                        device="cpu")
    tm.load_numpy_state(w)
    return jm, tm


def _paged_steps(jm, tm, dtype, use_rope):
    """Two prefill chunks and one three-row decode step (the sequence of
    ``test_prefill_and_decode_match_jax``) in ``dtype``, JAX decode
    through the Pallas kernel.  Returns ``{name: (port, jax)}`` as fp32
    numpy."""
    jw, tw = jm.decode_state(), tm.decode_state()
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    hd = CFG["hidden_size"] // CFG["num_heads"]
    shape = (CFG["num_layers"], N_BLOCKS, BS, CFG["num_heads"], hd)
    jk, jv = jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)
    tk, tv = torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)
    rng = np.random.default_rng(10 + use_rope)
    prompt = rng.integers(0, CFG["vocab_size"], 13)
    table = np.array([3, 5, 1, 7, 0, 0, 0, 0], np.int32)
    out = {}
    for start, length in ((0, 8), (8, 5)):
        ids = np.zeros((1, 8), np.int32)
        ids[0, :length] = prompt[start:start + length]
        jk, jv, jl = jm.prefill_paged(jw, jnp.asarray(ids), start, length,
                                      jnp.asarray(table), jk, jv)
        tl = tm.prefill_paged(tw, torch.from_numpy(ids).long(), start,
                              length, torch.from_numpy(table), tk, tv)
        out[f"prefill_logits_{start}"] = (tl, jl)
    tok = np.array([int(prompt[-1]), 9, 0], np.int32)
    pos = np.array([13, 5, 0], np.int32)
    bt = np.zeros((3, MAX_BLOCKS), np.int32)
    bt[0] = table
    bt[1, :2] = [2, 4]
    tl = tm.decode_paged(tw, *[torch.from_numpy(a) for a in (tok, pos, bt)],
                         tk, tv)
    jl, jk, jv = jm.decode_paged(jw, jnp.asarray(tok), jnp.asarray(pos),
                                 jnp.asarray(bt), jk, jv, kernel="pallas")
    out.update(decode_logits=(tl, jl), pool_k=(tk, jk), pool_v=(tv, jv))
    return {k: (a.float().numpy(), np.asarray(jnp.asarray(b, jnp.float32)))
            for k, (a, b) in out.items()}


@pytest.mark.parametrize("use_rope", [False, True])
def test_prefill_and_decode_bf16_within_fp32_distance(interpret_mode,
                                                      use_rope):
    runs = {d: _paged_steps(*_bf16_pair(use_rope, d), d, use_rope)
            for d in ("float32", "bfloat16")}
    for name, (tb, jb) in runs["bfloat16"].items():
        jf = runs["float32"][name][1]
        noise = np.abs(jb - jf).max()
        err = np.abs(tb - jb).max()
        tol = 2 * noise + TOL["atol"] + TOL["rtol"] * np.abs(jf).max()
        assert 0 < noise and err <= tol, (name, err, noise)
        if "logits" in name:         # greedy tokens
            np.testing.assert_array_equal(tb.argmax(-1), jb.argmax(-1))


def test_load_numpy_state_rejects_wrong_names():
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    arrays = {k: v.detach().numpy() for k, v in tm.named_parameters()}
    arrays["bogus"] = arrays.pop("wte")
    with pytest.raises(KeyError, match="bogus"):
        tm.load_numpy_state(arrays)


def test_init_from_explicit_generator():
    make = lambda seed: GPTForCausalLM(  # noqa: E731
        GPTConfig(**CFG), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    a, b, c = make(3), make(3), make(4)
    # the torch parameters behind the Layer's Parameter attributes
    a, b, c = (dict(torch.nn.Module.named_parameters(x)) for x in (a, b, c))
    assert torch.equal(a["qkv_w"], b["qkv_w"]) and not torch.equal(
        a["qkv_w"], c["qkv_w"])
    assert torch.all(a["ln1_w"] == 1) and torch.all(a["qkv_b"] == 0)
    std = float(a["fc1_w"].detach().std())
    assert abs(std - CFG["initializer_range"]) < 0.02
