"""GPT training in the PyTorch port against the JAX package.

A tiny GPT (vocab 64, hidden 64, 2 layers, 2 heads of 32, max_seq_len
128) on a batch of 2 x 128 tokens, so both packages take their flash
attention path: the JAX Pallas kernels in interpret mode, the port's
wrappers their plain versions (on CPU tensors).  The JAX model's weights
are loaded into the port (``load_numpy_state``) and both get the same
numpy token ids.  One module fixture runs the JAX side once per dtype:
eager forward, loss and ``backward()``, then three
``CompiledTrainStep`` + ``AdamW(1e-3)`` steps, keeping the model and
optimizer state after the second.

Tolerances (each stated where it is used):
* fp32: the two packages run the same fp32 math in different orders.
  Logits, loss and grads agree to 1e-5 of their scale.  After Adam
  steps, an element whose gradient is within rounding of 0 can take
  the other sign of ``mhat / sqrt(vhat)`` and move up to ``2 * lr`` per
  step apart, so parameters must agree to 1% of ``lr`` except for a
  1e-4 share of elements held to that bound (``_assert_params``).
* bf16: both packages round the same tensors to bf16, but a value at a
  rounding boundary can land one bf16 ulp (2**-8 relative) apart and
  carry through the layers; tolerances are stated in bf16 ulps of the
  compared value's scale, and Adam's sign-like update then holds
  masters only to its bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu_torch.optimizer
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit import CompiledTrainStep as JStep
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu_torch import (Adam, AdamW, CompiledTrainStep, GPTConfig,
                              GPTForCausalLM, GPTPretrainingCriterion)
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.profiler import counters

import _torch_mesh_workers as W

CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=128, initializer_range=0.1)
B, S, LR, STEPS = 2, 128, 1e-3, 3
BF16_ULP = 2.0 ** -8
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int64)
    labels = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int64)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return ids, labels, mask


def _f32(x):
    """numpy fp32 of a JAX Tensor/array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    x = x.numpy() if hasattr(x, "numpy") else x
    return np.asarray(x).astype(np.float32)


def _jax_run(dtype):
    """The JAX side: weights, eager loss/grads, and a 3-step trajectory."""
    paddle.seed(11)
    jm = JGPT(JConfig(dtype=dtype, **CFG))
    crit = JCrit()
    ids, labels, mask = _batch()
    jids, jlab = paddle.to_tensor(ids), paddle.to_tensor(labels)
    out = {"weights": {k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()},
           "names": {p.name: n for n, p in jm.named_parameters()}}
    logits = jm(jids)
    out["logits"] = _f32(logits)
    out["loss_masked"] = float(_f32(crit(logits, jlab,
                                         paddle.to_tensor(mask))))
    loss = crit(logits, jlab)
    loss.backward()
    out["loss"] = float(_f32(loss))
    out["grads"] = {n: _f32(p.grad) for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_gradient()

    opt = paddle.optimizer.AdamW(LR, parameters=jm.parameters())
    step = JStep(jm, lambda m, x, y: crit(m(x), y), opt)
    out["losses"] = []
    for i in range(STEPS):
        out["losses"].append(float(_f32(step(jids, jlab))))
        if i == 1:
            out["after2"] = ({k: np.asarray(v.numpy())
                              for k, v in jm.state_dict().items()},
                             opt.state_dict())
    out["final"] = ({k: _f32(v) for k, v in jm.state_dict().items()},
                    opt.state_dict())
    return out


@pytest.fixture(scope="module")
def jax_runs():
    jfa._INTERPRET[0] = True
    try:
        return {d: _jax_run(d) for d in ("float32", "bfloat16")}
    finally:
        jfa._INTERPRET[0] = False


def _port(weights, dtype, **cfg):
    m = GPTForCausalLM(GPTConfig(dtype=dtype, **{**CFG, **cfg}),
                       device="cpu")
    m.load_numpy_state(weights)
    return m


def _loss_fn(crit):
    return lambda m, x, y: crit(m(x), y)


#: Adam moves an element by at most lr (times 1 + lr*decay) per step,
#: whatever its gradient: two runs can differ by at most twice that
ADAM_BOUND = 2 * STEPS * LR * 1.01


def _assert_params(got_params, ref, what):
    """fp32 parameters against JAX's: within 1% of lr, except that at
    most 1e-4 of a tensor's elements may sit anywhere within
    ``ADAM_BOUND`` — an element whose gradient is within rounding of 0
    can take the other sign of ``mhat / sqrt(vhat)`` (one fc2_w element
    of 32768 moves 0.07 lr here).  The key bias (``qkv_b[:, H:2H]``)
    shifts every logit of a row alike, so its true gradient is 0 and both
    packages feed Adam pure rounding noise: it is held to the bound
    only."""
    H = CFG["hidden_size"]
    for n, got in got_params.items():
        want = ref[n]
        diff = np.abs(got - want)
        assert diff.max() <= ADAM_BOUND, (what, n, diff.max())
        if n == "qkv_b":
            diff = np.delete(diff, np.s_[H:2 * H], axis=1)
        off = int((diff > 0.01 * LR).sum())
        assert off <= 1e-4 * diff.size, (what, n, off, diff.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_jax(jax_runs, dtype):
    ref = jax_runs[dtype]
    m = _port(ref["weights"], dtype)
    ids, labels, mask = _batch()
    crit = GPTPretrainingCriterion()
    logits = m(torch.from_numpy(ids))
    assert logits.dtype == _TORCH_DTYPE[dtype]
    assert tuple(logits.shape) == (B, S, CFG["vocab_size"])
    scale = float(np.abs(ref["logits"]).max())
    # fp32: reordered fp32 sums; bf16: 4 ulps of the logit scale
    atol = 1e-5 * scale if dtype == "float32" else 4 * BF16_ULP * scale
    np.testing.assert_allclose(_f32(logits), ref["logits"], atol=atol,
                               rtol=0)
    loss = crit(logits, torch.from_numpy(labels))
    masked = crit(logits, torch.from_numpy(labels), torch.from_numpy(mask))
    assert loss.dtype == torch.float32
    # the loss is an fp32 mean of per-token terms of the logits above
    tol = 1e-6 if dtype == "float32" else 1e-3
    assert abs(loss.item() - ref["loss"]) <= tol * abs(ref["loss"])
    assert abs(masked.item() - ref["loss_masked"]) <= tol * abs(
        ref["loss_masked"])


def test_grads_match_jax_eager_backward(jax_runs):
    ref = jax_runs["float32"]
    m = _port(ref["weights"], "float32")
    ids, labels, _ = _batch()
    loss = GPTPretrainingCriterion()(m(torch.from_numpy(ids)),
                                     torch.from_numpy(labels))
    loss.backward()
    for n, p in m.named_parameters():
        g = ref["grads"][n]
        # fp32 sums in another order: 1e-5 of the largest grad entry
        np.testing.assert_allclose(_f32(p.grad), g, rtol=0,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=n)


def _train(ref, dtype, steps=STEPS, after=None):
    m = _port(ref["weights"] if after is None else after[0], dtype)
    crit = GPTPretrainingCriterion()
    opt = AdamW(LR, parameters=m.named_parameters())
    if after is not None:
        opt.load_numpy_state(after[1], ref["names"])
    step = CompiledTrainStep(m, _loss_fn(crit), opt)
    ids, labels, _ = _batch()
    losses = [float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
              for _ in range(steps)]
    return m, opt, losses


def test_trajectory_matches_jax_compiled_train_step(jax_runs):
    ref = jax_runs["float32"]
    before = counters.snapshot()
    m, opt, losses = _train(ref, "float32")
    moved = counters.delta(before)
    assert moved["jit.steps"] == moved["jit.host.dispatches"] == STEPS
    assert moved["optimizer.steps"] == STEPS
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6, atol=0)
    assert losses[-1] < losses[0]
    _assert_params({n: _f32(p) for n, p in m.named_parameters()},
                   ref["final"][0], "params")
    assert opt.state_dict()["step"] == ref["final"][1]["step"] == STEPS


def test_bf16_trajectory_and_optimizer_state_match_jax(jax_runs):
    ref = jax_runs["bfloat16"]
    m, opt, losses = _train(ref, "bfloat16")
    # the loss is an fp32 mean over bf16 logits: 1e-3 relative
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-3, atol=0)
    assert losses[-1] < losses[0]
    jparams, jstate = ref["final"]
    state = opt.state_dict()
    names = ref["names"]
    # In bf16 the gradients of the two packages differ by about a bf16
    # ulp of their scale, so an element whose gradient is below that can
    # take either sign of mhat / sqrt(vhat).  So the masters' updates
    # (master - initial weight, ~2.5 lr per element after 3 steps) are
    # held together: their difference within 0.15 of JAX's update by
    # norm (measured <= 0.112; a port that left the masters still would
    # be at 1), at most 3% of a tensor's elements more than lr/2 apart
    # (measured <= 2.4%: 3 of ln1_w's 128) and none beyond Adam's bound.
    # The key bias is left out, as in ``_assert_params``.  Each parameter
    # equals its own master in bf16 (the in-place write-back) and is
    # within the bound of JAX's parameter.
    H = CFG["hidden_size"]
    masters = {names[jn]: _f32(state["master_weights"][names[jn]])
               for jn in jstate["master_weights"]}
    for jn, want in jstate["master_weights"].items():
        n = names[jn]
        init = ref["weights"][n].astype(np.float32)
        got, want = masters[n], want.astype(np.float32)
        assert np.abs(got - want).max() <= ADAM_BOUND, n
        if n == "qkv_b":
            got, want, init = (np.delete(a, np.s_[H:2 * H], axis=1)
                               for a in (got, want, init))
        rel = (np.linalg.norm((got - init) - (want - init))
               / np.linalg.norm(want - init))
        assert rel <= 0.15, (n, rel)
        off = float(np.mean(np.abs(got - want) > 0.5 * LR))
        assert off <= 0.03, (n, off)
    for n, p in torch.nn.Module.named_parameters(m):
        assert torch.equal(p, torch.from_numpy(masters[n]).to(p.dtype)), n
        scale = float(np.abs(jparams[n]).max())
        np.testing.assert_allclose(_f32(p), jparams[n], rtol=0, err_msg=n,
                                   atol=ADAM_BOUND + BF16_ULP * scale)
    for acc in ("moment1", "moment2"):
        for jn, val in jstate["accumulators"][acc].items():
            port = _f32(state["accumulators"][acc][names[jn]])
            scale = float(np.abs(val).max())
            # moments are sums of bf16 gradients: 8 bf16 ulps of the scale
            np.testing.assert_allclose(port, val, rtol=0,
                                       atol=8 * BF16_ULP * scale,
                                       err_msg=f"{acc} {names[jn]}")
    for acc in ("beta1_pow", "beta2_pow"):
        for jn, val in jstate["accumulators"][acc].items():
            assert float(state["accumulators"][acc][names[jn]]) == float(val)


def test_optimizer_state_carries_over_from_jax(jax_runs):
    """Two JAX steps, then the model and optimizer state into the port,
    then one more step on each side: the port resumes the JAX run."""
    ref = jax_runs["float32"]
    m, opt, losses = _train(ref, "float32", steps=1, after=ref["after2"])
    assert opt.state_dict()["step"] == STEPS
    np.testing.assert_allclose(losses, ref["losses"][2:], rtol=1e-6)
    _assert_params({n: _f32(p) for n, p in m.named_parameters()},
                   ref["final"][0], "params")
    jstate = ref["final"][1]
    state = opt.state_dict()
    for jn, val in jstate["accumulators"]["moment2"].items():
        port = _f32(state["accumulators"]["moment2"][ref["names"][jn]])
        np.testing.assert_allclose(port, val, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(val).max()))


def test_load_numpy_state_maps_by_name_not_order(jax_runs):
    ref = jax_runs["float32"]
    _, jstate = ref["after2"]
    m = _port(ref["weights"], "float32")
    opt = AdamW(LR, parameters=m.named_parameters())
    opt.load_numpy_state(jstate, ref["names"])
    state = opt.state_dict()
    for jn, val in jstate["accumulators"]["moment1"].items():
        np.testing.assert_array_equal(
            _f32(state["accumulators"]["moment1"][ref["names"][jn]]), val)
    with pytest.raises(KeyError, match="generated_tensor"):
        opt.load_numpy_state(jstate, {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,wd", [("Adam", 0.01), ("AdamW", 0.1)])
def test_optimizer_update_matches_jax_eager(name, wd, dtype):
    """Three eager steps on the same parameters and gradients: ``Adam``
    (L2 into the gradient) and ``AdamW`` (decoupled decay), with fp32
    masters for bf16 parameters.  The same fp32 elementwise formula runs
    on both sides: 1e-6 relative, and bf16 parameters equal their masters
    rounded to bf16."""
    rng = np.random.default_rng(4)
    shapes = [(4, 3), (5,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jparams = [JParameter(jnp.asarray(w, jd)) for w in init]
    tparams = [torch.from_numpy(w).to(td).requires_grad_() for w in init]
    jopt = getattr(paddle.optimizer, name)(1e-2, parameters=jparams,
                                           weight_decay=wd)
    topt = {"Adam": Adam, "AdamW": AdamW}[name](1e-2, parameters=tparams,
                                                weight_decay=wd)
    for step_grads in grads:
        for jp, tp, g in zip(jparams, tparams, step_grads):
            jp.grad = JTensor._wrap(jnp.asarray(g, jd))
            tp.grad = torch.from_numpy(g).to(td)
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
    jstate, tstate = jopt.state_dict(), topt.state_dict()
    for i, (jp, tp) in enumerate(zip(jparams, tparams)):
        assert tp.grad is None
        np.testing.assert_allclose(_f32(tp), _f32(jp), rtol=1e-6, atol=0)
        for acc in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_allclose(
                _f32(tstate["accumulators"][acc][f"param_{i}"]),
                _f32(jstate["accumulators"][acc][jp.name]), rtol=1e-6,
                atol=0, err_msg=acc)
        if dtype == "bfloat16":
            master = tstate["master_weights"][f"param_{i}"]
            np.testing.assert_allclose(
                _f32(master), _f32(jstate["master_weights"][jp.name]),
                rtol=1e-6, atol=0)
            assert torch.equal(tp.detach(), master.to(td))
        else:
            assert tstate["master_weights"] == {}


def _grads(cfg, dropout_seed=None):
    torch.manual_seed(0)
    m = GPTForCausalLM(GPTConfig(**{**CFG, **cfg}), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    ids, labels, _ = _batch()
    gen = (None if dropout_seed is None
           else torch.Generator().manual_seed(dropout_seed))
    loss = GPTPretrainingCriterion()(m(torch.from_numpy(ids),
                                       generator=gen),
                                     torch.from_numpy(labels))
    loss.backward()
    return float(loss), {n: p.grad for n, p in
                         torch.nn.Module.named_parameters(m)}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("mode", [True, "selective", "selective_lean"])
def test_recompute_gives_the_grads_of_no_recompute(mode, dropout):
    """Recompute replays the same math (and, with dropout, the same
    masks: they are drawn before each block and reused), so loss and
    grads are those of ``recompute=False`` up to fp32 reordering."""
    launches = tfa.flash_fwd.launches
    loss0, g0 = _grads(dict(dropout=dropout), dropout_seed=7)
    loss1, g1 = _grads(dict(dropout=dropout, recompute=mode),
                       dropout_seed=7)
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7,
                                   msg=n)
    assert tfa.flash_fwd.launches == launches   # CPU: plain versions


def test_dropout_mask_rate_and_scale():
    """The RNG streams differ from JAX's, so dropout is held by its
    distribution: keep rate 1 - p within 5 binomial sigmas, kept values
    scaled by 1 / (1 - p), and eval mode or p = 0 is the identity."""
    from paddle_tpu_torch.models.gpt import _dropout, _keep_mask
    p, n = 0.3, 200_000

    def drop(seed):
        gen = torch.Generator().manual_seed(seed)
        return _dropout(torch.ones(n), p, _keep_mask((n,), p, gen, "cpu"))

    out = drop(123)
    kept = out != 0
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - p)) < 5 * sigma
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / (1 - p)))
    # another seed, another mask; the same seed, the same mask
    assert not torch.equal(out, drop(124))
    assert torch.equal(out, drop(123))

    ids = torch.from_numpy(_batch()[0])
    m = GPTForCausalLM(GPTConfig(**{**CFG, "dropout": 0.5}), device="cpu")
    plain = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    plain.set_state_dict(m.state_dict())
    gen = torch.Generator().manual_seed(1)
    assert not torch.allclose(m(ids, generator=gen), plain(ids))
    m.eval()
    torch.testing.assert_close(m(ids), plain(ids), rtol=0, atol=0)


#: the degrees of the pipeline mesh the train step now trains over
_PP2 = {"pp": 2}


@pytest.mark.parametrize("kw,item", [
    (dict(lazy_mode=True), "A4"), (dict(optimizer="LBFGS"), "A4"),
    (dict(mesh=_PP2), "A7"), (dict(sparse_grad=True), "A4")])
def test_unported_train_step_options_name_their_roadmap_item(kw, item,
                                                              tmp_path):
    """The options the training loop once refused now train.  A mesh
    with a pipeline axis: two gloo ranks (``tests/_torch_mesh_workers.py``
    ``pp_gpipe_smoke``) build the GPT under ``build_mesh({"pp": 2})``
    (one layer a stage) and train it two ``CompiledTrainStep(mesh=)``
    steps through GPipe (M lowered to the 2 rows, with the JAX
    warning), losses within rtol 1e-5 and parameters within
    :func:`_assert_params`' bounds of this process's meshless steps from
    the same weights; what the mesh step still refuses there (a model
    built without the mesh) names its ROADMAP item (A7e-models; the JAX
    parity is ``tests/test_torch_pp_train.py``'s).  The three A4
    options train the dygraph GPT as the JAX package does, in fp32 from
    the same weights (plain attention in both: the loop is the point),
    two steps: ``AdamW(lazy_mode=True)`` over dense gradients (the dense
    rule, in both), ``LBFGS`` with a closure, and a SelectedRows gradient
    set on the tied embedding (AdamW densifies it).  Parameters within
    1e-5 of their scale (the same fp32 math in another order)."""
    cfg = {**CFG, "use_flash_attention": False}
    m = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    if "mesh" in kw:
        ids, labels, _ = _batch()
        pl = {"cfg": cfg, "lr": LR, "state": m.gather_numpy_state(),
              "degrees": kw["mesh"], "ids": np.stack([ids, ids]),
              "labels": np.stack([labels, labels])}
        ranks = W.spawn("pp_gpipe_smoke", 2, tmp_path, pl)
        step = CompiledTrainStep(m, _loss_fn(GPTPretrainingCriterion()),
                                 AdamW(LR, parameters=m.parameters()))
        want = [float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
                for _ in range(2)]
        ref = m.gather_numpy_state()
        for losses, state, refused in ranks.results():
            np.testing.assert_allclose(losses, want, rtol=1e-5)
            _assert_params(state, ref, "pp2 GPipe vs meshless")
            assert refused.startswith("NotImplementedError"), refused
            assert item in refused and "A7e-models" in refused, refused
        return
    from paddle_tpu.core.selected_rows import SelectedRows as JSR
    from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR
    paddle.seed(11)
    jm = JGPT(JConfig(**cfg))
    init0 = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    m.load_numpy_state(init0)
    ids, labels, _ = _batch()
    rows = np.array([3, 7, 3, 60])
    vals = np.random.default_rng(1).standard_normal(
        (4, CFG["hidden_size"])).astype(np.float32)
    out = []
    for pkg, model, crit, sr in (
            (paddle, jm, JCrit(), lambda: JSR(rows, jnp.asarray(vals),
                                              CFG["vocab_size"])),
            (paddle_tpu_torch, m, GPTPretrainingCriterion(),
             lambda: TSR(torch.from_numpy(rows), torch.from_numpy(vals),
                         CFG["vocab_size"]))):
        x, y = pkg.to_tensor(ids), pkg.to_tensor(labels)
        if "optimizer" in kw:
            opt = pkg.optimizer.LBFGS(learning_rate=LR, history_size=4,
                                      parameters=model.parameters())

            def closure():
                opt.clear_grad()
                loss = crit(model(x), y)
                loss.backward()
                return loss

            for _ in range(2):
                opt.step(closure)
        else:
            opt = pkg.optimizer.AdamW(LR, parameters=model.parameters(),
                                      **({} if "sparse_grad" in kw else kw))
            for _ in range(2):
                if "sparse_grad" in kw:
                    model.wte.grad = sr()
                else:
                    crit(model(x), y).backward()
                opt.step()
                opt.clear_grad()
        out.append({k: _f32(v) for k, v in model.state_dict().items()})
    if "optimizer" not in kw:
        _assert_params(out[1], out[0], str(kw))   # AdamW's bounds
        return
    # LBFGS: each tensor's change from the start within 1e-4 of its
    # largest change (its direction comes from dots over every gradient),
    # plus the fp32 rounding of the parameter itself (1e-6 of its scale)
    for n, want in out[0].items():
        step = float(np.abs(want - init0[n]).max())
        np.testing.assert_allclose(
            out[1][n] - init0[n], want - init0[n], rtol=0, err_msg=n,
            atol=1e-4 * step + 1e-6 * float(np.abs(init0[n]).max()))


@pytest.mark.parametrize("cfg", [dict(pp_schedule="1f1b")])
def test_unported_model_parallelism_names_a7(cfg):
    """The pipeline options build (they once raised, naming ROADMAP.md
    A7e), and without a mesh (pp 1, as in the JAX package) the model
    trains exactly as without them: three ``CompiledTrainStep`` + AdamW
    steps, the same losses and parameters bit for bit (the schedules act
    on a pp mesh only: ``tests/test_torch_pp_train.py``)."""
    ids, labels, _ = (torch.from_numpy(t) for t in _batch())
    runs = []
    for over in ({}, cfg):
        m = GPTForCausalLM(GPTConfig(**{**CFG, **over}), device="cpu")
        assert m.pipeline_stages is None
        step = CompiledTrainStep(m, _loss_fn(GPTPretrainingCriterion()),
                                 AdamW(LR, parameters=m.parameters()))
        losses = [float(step(ids, labels)) for _ in range(STEPS)]
        runs.append((losses, {n: t.detach().clone()
                              for n, t in m._weights().items()}))
    (l0, w0), (l1, w1) = runs
    assert l0 == l1
    for n in w0:
        assert torch.equal(w0[n], w1[n]), n


@pytest.mark.parametrize("flag", ["sequence_parallel", "context_parallel"])
def test_parallel_flags_train_without_a_mesh_as_without_them(flag):
    """``sequence_parallel`` and ``context_parallel`` build, and without a
    mesh (sep 1, as in the JAX package) the model trains exactly as
    without the flag: three ``CompiledTrainStep`` + AdamW steps under a
    loss mask, the same losses and parameters bit for bit (the flags act
    only on a sequence split: ``tests/test_torch_cp_train.py``)."""
    ids, labels, mask = (torch.from_numpy(t) for t in _batch())
    runs = []
    for cfg in ({}, {flag: True}):
        m = GPTForCausalLM(GPTConfig(**{**CFG, **cfg}), device="cpu")
        crit = GPTPretrainingCriterion()
        step = CompiledTrainStep(m, lambda m, x, y, w: crit(m(x), y, w),
                                 AdamW(LR, parameters=m.parameters()))
        losses = [float(step(ids, labels, mask)) for _ in range(STEPS)]
        runs.append((losses, {n: t.detach().clone()
                              for n, t in m._weights().items()}))
    (l0, w0), (l1, w1) = runs
    assert l0 == l1
    for n in w0:
        assert torch.equal(w0[n], w1[n]), n
