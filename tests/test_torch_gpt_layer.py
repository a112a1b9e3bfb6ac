"""GPT as a paddle-style ``Layer`` in the PyTorch port against the JAX
package: Paddle's dygraph loop (``tests/test_models_io.py``'s
``TestGPTSingle``: ``model(ids)`` on Tensors, the criterion,
``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``), the
``state_dict`` names and shapes, ``amp.decorate``/``auto_cast``; that the
train step and the engines still take the Layer; prompts given as
tensors; and the fp16 model served on the paged path.

Weights are moved across with ``set_state_dict`` of the JAX model's
``state_dict``; ids are numpy arrays from a seed.  Tolerances are stated
where they are used.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu.serving import LLMEngine as JEngine
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import (CompiledTrainStep, GPTConfig, GPTForCausalLM,
                              GPTPretrainingCriterion, LLMEngine)
from paddle_tpu_torch.serving.engine import prompt_ids

#: ``TestGPTSingle``'s model
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, use_flash_attention=False)
LR, STEPS = 1e-2, 5


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _models(seed=0, dtype="float32", **over):
    cfg = {**CFG, **over}
    jp.seed(seed)
    jm = JGPT(JConfig(dtype=dtype, **cfg))
    tm = GPTForCausalLM(GPTConfig(dtype=dtype, **cfg))
    missing, unexpected = tm.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    assert not missing and not unexpected
    return jm, tm


def _ids(seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                                shape).astype(np.int64)


def test_dygraph_loop_matches_jax():
    """Five AdamW steps of Paddle's dygraph loop in both packages, fp32:
    losses within 1e-5 relative (the same math in another order);
    parameters within 1% of lr, except that Adam's sign-like step may
    take an element whose gradient is within rounding of 0 up to 2·lr
    a step the other way — at most 1e-4 of a tensor's elements, and the
    key bias (``qkv_b[:, H:2H]``, true gradient 0: rounding noise in
    both) is held to that bound only."""
    jm, tm = _models()
    ids = _ids()
    assert isinstance(tm, tp.nn.Layer)
    losses = []
    for pkg, model, crit in ((jp, jm, JCrit()),
                             (tp, tm, GPTPretrainingCriterion())):
        x = pkg.to_tensor(ids)
        out = model(x)
        assert isinstance(out, pkg.Tensor) and out.shape == [2, 16, 64]
        opt = pkg.optimizer.AdamW(LR, parameters=model.parameters())
        run = []
        for _ in range(STEPS):
            loss = crit(model(x), x)
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(float(loss.numpy()))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[1][-1] < losses[1][0]
    H = CFG["hidden_size"]
    bound = 2 * STEPS * LR
    for n, p in tm.state_dict().items():
        want = np.asarray(jm.state_dict()[n].numpy())
        diff = np.abs(p.numpy() - want)
        assert diff.max() <= bound, (n, diff.max())
        if n == "qkv_b":
            diff = np.delete(diff, np.s_[H:2 * H], axis=1)
        assert int((diff > 0.01 * LR).sum()) <= 1e-4 * diff.size, n


@pytest.mark.parametrize("over", [{}, dict(use_rope=True),
                                  dict(tie_word_embeddings=False)])
def test_state_dict_keys_and_shapes_equal_jax(over):
    jm, tm = _models(**over)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(tsd) == list(jsd)
    for n, p in tsd.items():
        assert isinstance(p, tp.Parameter) and p.shape == jsd[n].shape, n
        np.testing.assert_array_equal(p.numpy(), jsd[n].numpy())
    # set_state_dict round trip, and torch's own view of the same tensors
    other = GPTForCausalLM(GPTConfig(**{**CFG, **over}))
    other.set_state_dict(tsd)
    for (n, a), (_, b) in zip(torch.nn.Module.named_parameters(tm),
                              torch.nn.Module.named_parameters(other)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_and_auto_cast_as_jax(level):
    """``decorate`` O2 casts every GPT parameter to bf16 in both packages
    (GPT has no norm sublayer); under ``auto_cast`` the forward's logits
    take the dtype JAX's take, within 2**-5 of their scale of JAX's
    (both round the same tensors to bf16 through 2 layers; one bf16 ulp
    is 2**-8 relative)."""
    jm, tm = _models(seed=3)
    ids = _ids(3)
    out = []
    for pkg, model in ((jp, jm), (tp, tm)):
        if level == "O2":
            model = pkg.amp.decorate(model, level="O2", dtype="bfloat16")
        dtypes = {n: str(p.dtype).replace("torch.", "").replace(
            "paddle.", "") for n, p in model.state_dict().items()}
        with pkg.amp.auto_cast(level=level, dtype="bfloat16"):
            logits = model(pkg.to_tensor(ids))
        out.append((dtypes, str(logits.dtype).split(".")[-1],
                    logits.numpy().astype(np.float32)))
    (jd, jl, jv), (td, tl, tv) = out
    assert {n: d.split(".")[-1] for n, d in td.items()} == \
        {n: d.split(".")[-1] for n, d in jd.items()}
    if level == "O2":
        assert set(td.values()) == {"bfloat16"}
    assert tl == jl
    np.testing.assert_allclose(tv, jv, rtol=0,
                               atol=2.0 ** -5 * float(np.abs(jv).max()))


def test_train_step_and_engine_take_the_layer():
    """``CompiledTrainStep`` (torch tensors in, the torch parameters
    updated in place) gives the dygraph loop's step bit for bit, and the
    paged engine serves the Layer: its greedy tokens are ``generate``'s."""
    _, a = _models(seed=4)
    _, b = _models(seed=4)
    ids = _ids(4)
    crit = GPTPretrainingCriterion()
    step = CompiledTrainStep(a, lambda m, x: crit(m(x), x),
                             tp.AdamW(LR, parameters=a.parameters()))
    opt = tp.AdamW(LR, parameters=b.parameters())
    for _ in range(2):
        step(torch.from_numpy(ids))
        loss = crit(b(tp.to_tensor(ids)), tp.to_tensor(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
    for (n, x), (_, y) in zip(torch.nn.Module.named_parameters(a),
                              torch.nn.Module.named_parameters(b)):
        assert torch.equal(x, y), n
    a.eval()
    prompt = _ids(5, (9,)).tolist()
    eng = LLMEngine(a, kv_layout="paged", max_slots=2, max_seq_len=16,
                    block_size=4, prefill_chunk=8, min_bucket=8)
    h = eng.add_request(prompt, max_new_tokens=5)
    while not h.is_finished:
        eng.step()
    want = a.generate(torch.tensor([prompt]), max_new_tokens=5)
    assert h.tokens == want[0, len(prompt):].tolist()


def test_prompt_ids_takes_tensors_lists_and_arrays():
    """The one helper every serving entry point reads a prompt through
    (a CUDA tensor is copied to the host: ``chip_smoke.py`` pins that on
    the card); the engine serves a Tensor prompt as its list."""
    want = np.array([3, 1, 4, 1, 5], np.int32)
    for prompt in (want.tolist(), want, want.astype(np.int64),
                   torch.from_numpy(want.astype(np.int64))[None],
                   tp.to_tensor(want)):
        got = prompt_ids(prompt)
        assert got.dtype == np.int32 and got.tolist() == want.tolist()
    _, tm = _models(seed=6)
    tm.eval()
    out = []
    for prompt in (want.tolist(), tp.to_tensor(want), torch.tensor(want)):
        eng = LLMEngine(tm, kv_layout="paged", max_slots=2, max_seq_len=16,
                        block_size=4, prefill_chunk=8, min_bucket=8)
        h = eng.add_request(prompt, max_new_tokens=4)
        while not h.is_finished:
            eng.step()
        out.append(h.tokens)
    assert out[0] == out[1] == out[2]


@pytest.mark.parametrize("kw", [
    dict(kv_layout="paged"),
    dict(kv_layout="paged", kv_dtype="int8", weight_dtype="int8"),
    dict(kv_layout="slots")], ids=["paged", "paged-int8", "slots"])
def test_fp16_paged_engine_matches_jax_engine(kw):
    """``GPTConfig(dtype="float16")`` served on the paged path (K4's plain
    version over fp16 pools here, the fp16 kernel instance on the card),
    with int8 KV and weights (K4q with an fp16 query) and in the slot
    layout: greedy tokens equal the JAX engine's, request for request
    (initializer_range 0.3 keeps the logit gaps far above fp16's
    rounding, as the engine tests do)."""
    jm, tm = _models(seed=21, dtype="float16", num_heads=4,
                     initializer_range=0.3)
    jm.eval()
    tm.eval()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, n).tolist() for n in (5, 9, 3, 12)]
    kw = dict(kw, max_slots=3, max_seq_len=16, min_bucket=8)
    if kw["kv_layout"] == "paged":
        kw.update(block_size=4, prefill_chunk=8)
    else:
        del kw["kv_layout"]
    tokens = []
    for eng in (JEngine(jm, **kw), LLMEngine(tm, **kw)):
        hs = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        steps = 0
        while not all(h.is_finished for h in hs):
            eng.step()
            steps += 1
            assert steps < 100
        tokens.append([h.tokens for h in hs])
    assert tokens[1] == tokens[0]
    assert len({t for toks in tokens[1] for t in toks}) >= 4
