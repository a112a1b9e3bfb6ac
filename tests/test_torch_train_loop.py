"""The training loop of the port against the JAX package's:
``CompiledTrainStep`` with a GradScaler, train metrics, fused windows
and ``FLAGS_check_nan_inf``, on a tiny GPT (vocab 64, hidden 32, 2
layers, 4 heads).

Two JAX runs, once per module:

* ``scaler``: fp16 weights, flash attention (the JAX Pallas kernels in
  interpret mode; the port's plain versions round 2-byte operands to
  bf16 as they do), batch 2 x 128, ``GradScaler(2**21,
  incr_every_n_steps=2)`` whose first steps overflow, ``AdamW(1e-3)``,
  8 single steps with metrics.
* ``fused``: fp32, plain attention, batch 2 x 16, ``AdamW`` over a
  ``StepDecay`` schedule with ``ClipGradByGlobalNorm(1.0)``, metrics,
  ``fused_steps=4`` over 10 batches (a priming window, a fused window
  and a tail of 2).

Tolerances, stated where used: the scale, skip and lr series are equal;
fp32 losses and metric scalars within 1e-5 relative; fp16 losses within
2**-9 relative (fp16 logits, an fp32 mean).  Parameters are held at
bounds set from readings of these runs (:func:`_check_fp32_params`,
:func:`_check_fp16_masters`), apart from the key third of ``qkv_b``: its
gradient is zero in exact arithmetic (softmax is shift-invariant in the
keys), so both runs step Adam on rounding noise there and it is held
only to Adam's bound (an element moves at most about lr a step, so two
runs differ by at most 2 lr a step).  The port's fused windows equal its
own single steps bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.io import Window as JWindow
from paddle_tpu.jit import CompiledTrainStep as JStep
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import (AdamW, CompiledTrainStep, GPTConfig,
                              GPTForCausalLM, GPTPretrainingCriterion, flags,
                              optimizer)
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.io import Window
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, Adam, lr as tlr
from paddle_tpu_torch.profiler import counters

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4)
K, N = 4, 10
SCALER = dict(init_loss_scaling=2.0 ** 21, incr_every_n_steps=2)
SCALER_STEPS, LR = 8, 1e-3
SERIES = ("loss", "grad_norm", "lr", "scaler_scale", "scaler_skip")


def _batches(n, B, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab_size"], (n, B, S)).astype(np.int64),
            rng.integers(0, CFG["vocab_size"], (n, B, S)).astype(np.int64))


def _weights(jm):
    return ({k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()},
            {p.name: n for n, p in jm.named_parameters()})


def _series(logger):
    return {k: logger.series(k) for k in SERIES}


def _jax_scaler_run():
    paddle.seed(3)
    jm = JGPT(JConfig(dtype="float16", max_seq_len=128, **CFG))
    weights, names = _weights(jm)
    crit = JCrit()
    scaler = paddle.amp.GradScaler(**SCALER)
    opt = paddle.optimizer.AdamW(LR, parameters=jm.parameters())
    step = JStep(jm, lambda m, x, y: crit(m(x), y), opt, scaler=scaler,
                 metrics=True)
    ids, labels = _batches(SCALER_STEPS, 2, 128, seed=1)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
              for x, y in zip(ids, labels)]
    step.sync()
    state = opt.state_dict()
    return {"weights": weights, "names": names, "losses": losses,
            "series": _series(step.metrics),
            "scaler": scaler.state_dict(),
            "masters": {names[k]: np.asarray(v, np.float32)
                        for k, v in state["master_weights"].items()}}


def _jax_fused_run():
    paddle.seed(5)
    jm = JGPT(JConfig(max_seq_len=16, use_flash_attention=False, **CFG))
    weights, names = _weights(jm)
    crit = JCrit()
    sched = jlr.StepDecay(0.01, step_size=3, gamma=0.5)
    opt = paddle.optimizer.AdamW(sched, parameters=jm.parameters(),
                                 grad_clip=jclip.ClipGradByGlobalNorm(1.0))
    step = JStep(jm, lambda m, x, y: crit(m(x), y), opt, fused_steps=K,
                 metrics=True)
    ids, labels = _batches(N, 2, 16, seed=2)
    losses = []
    for lo in range(0, N, K):
        hi = min(lo + K, N)
        w = JWindow((paddle.to_tensor(ids[lo:hi]),
                     paddle.to_tensor(labels[lo:hi])), hi - lo)
        losses.extend(np.asarray(step(w).numpy()).tolist())
        for _ in range(hi - lo):
            sched.step()
    step.sync()
    return {"weights": weights, "names": names, "losses": losses,
            "series": _series(step.metrics),
            "params": {n: np.asarray(p.numpy(), np.float32)
                       for n, p in jm.named_parameters()}}


@pytest.fixture(scope="module")
def jax_runs():
    jfa._INTERPRET[0] = True
    try:
        return {"scaler": _jax_scaler_run(), "fused": _jax_fused_run()}
    finally:
        jfa._INTERPRET[0] = False


# -- the port's side ----------------------------------------------------------
def _model(weights, **cfg):
    m = GPTForCausalLM(GPTConfig(**{**CFG, **cfg}), device="cpu")
    m.load_numpy_state(weights)
    return m


def _loss_fn():
    crit = GPTPretrainingCriterion()
    return lambda m, x, y: crit(m(x), y)


def _fused_setup(weights, k, dropout=0.0, metrics=True):
    m = _model(weights, max_seq_len=16, use_flash_attention=False,
               dropout=dropout)
    sched = tlr.StepDecay(0.01, step_size=3, gamma=0.5)
    opt = AdamW(sched, parameters=m.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(m, _loss_fn(), opt, fused_steps=k,
                             metrics=metrics)
    return m, sched, opt, step


def _run_single(step, sched, ids, labels):
    losses = []
    for x, y in zip(ids, labels):
        losses.append(step(torch.from_numpy(x), torch.from_numpy(y)))
        sched.step()
    return torch.stack(losses)


def _run_windows(step, sched, ids, labels, k=K):
    losses = []
    for lo in range(0, len(ids), k):
        hi = min(lo + k, len(ids))
        losses.append(step(Window((torch.from_numpy(ids[lo:hi]),
                                   torch.from_numpy(labels[lo:hi])),
                                  hi - lo)))
        for _ in range(hi - lo):
            sched.step()
    return torch.cat(losses)


def _parts(name, diff):
    """``|got - want|`` of one parameter, the key third of ``qkv_b``
    apart (hidden 32: q, k, v are thirds of its last axis)."""
    if name != "qkv_b":
        return {name: diff}
    h = CFG["hidden_size"]
    return {"qkv_b q/v": np.concatenate([diff[..., :h], diff[..., 2 * h:]],
                                        -1),
            "qkv_b k": diff[..., h:2 * h]}


def _check_fp32_params(got, want, sum_lr):
    """fp32 training: every element within 1e-3 of the lr summed over the
    steps (readings: at most 3.0e-4 of it, fc1_w), the key bias within
    Adam's bound (reading: 1.0e-3 of it)."""
    for name, w in want.items():
        for part, d in _parts(name, np.abs(got[name] - w)).items():
            bound = (2 * sum_lr if part == "qkv_b k" else 1e-3 * sum_lr)
            assert float(d.max()) <= bound, (part, float(d.max()), bound)


def _check_fp16_masters(got, want, steps, lr):
    """fp16 training: a gradient at fp16's rounding floor can change sign
    between the runs, and Adam's normalised step turns that into a move
    of about lr; elsewhere the masters agree to a small share of lr.  Per
    tensor but the key bias: the median difference within lr / 64
    (readings: at most lr / 250, the q/v bias), at most 1% of the
    elements beyond lr / 4 (readings: at most 0.16%, qkv_w); every
    element within Adam's bound 2 * steps * lr (readings: 1.48 lr, the
    key bias 3.33 lr, with a median of 0.80 lr)."""
    for name, w in want.items():
        for part, d in _parts(name, np.abs(got[name] - w)).items():
            assert float(d.max()) <= 2 * steps * lr * 1.01, (part, d.max())
            if part == "qkv_b k":
                continue
            assert float(np.median(d)) <= lr / 64, (part, np.median(d))
            assert float(np.mean(d > lr / 4)) <= 0.01, (
                part, float(np.mean(d > lr / 4)))


def test_grad_scaler_skips_and_scales_like_jax(jax_runs):
    """fp16 training under a GradScaler inside CompiledTrainStep: the
    same overflow steps are skipped, the scale follows the same series,
    a skipped step leaves the parameters and the optimizer state bit for
    bit as they were, and the rest trains as JAX does."""
    ref = jax_runs["scaler"]
    m = _model(ref["weights"], dtype="float16", max_seq_len=128)
    scaler = GradScaler(**SCALER)
    opt = AdamW(LR, parameters=m.named_parameters())
    step = CompiledTrainStep(m, _loss_fn(), opt, scaler=scaler,
                             metrics=True)
    ids, labels = _batches(SCALER_STEPS, 2, 128, seed=1)
    losses, skipped = [], 0
    for x, y in zip(ids, labels):
        before = ([p.detach().clone() for p in torch.nn.Module.parameters(m)],
                  opt.state_dict())
        losses.append(float(step(torch.from_numpy(x), torch.from_numpy(y))))
        step.metrics_flush()
        if step.metrics.latest("scaler_skip") == 1.0 and before[1]["step"]:
            skipped += 1
            after = opt.state_dict()
            for a, b in zip(before[0], torch.nn.Module.parameters(m)):
                assert torch.equal(a, b)
            for acc, store in before[1]["accumulators"].items():
                for n, t in store.items():
                    assert torch.equal(t, after["accumulators"][acc][n])
            for n, t in before[1]["master_weights"].items():
                assert torch.equal(t, after["master_weights"][n])
    series = _series(step.metrics)
    for name in ("scaler_scale", "scaler_skip", "lr"):
        assert series[name] == ref["series"][name], name
    assert skipped >= 1, "no skipped step after the first"
    skips = [v for _, v in series["scaler_skip"]]
    assert 0.0 in skips and 1.0 in skips
    scales = [v for _, v in series["scaler_scale"]]
    assert max(scales[i + 1] / scales[i] for i in range(len(scales) - 1)) \
        == 2.0, "the scale never grew"
    assert scaler.state_dict() == ref["scaler"]
    np.testing.assert_allclose(losses, ref["losses"], rtol=2.0 ** -9)
    steps_taken = int(SCALER_STEPS - sum(skips))
    masters = opt.state_dict()["master_weights"]
    _check_fp16_masters({n: t.numpy() for n, t in masters.items()},
                        ref["masters"], steps_taken, LR)


def test_eager_grad_scaler_matches_jax():
    """``scaler.step(optimizer)`` by hand, on fp16 parameters whose third
    gradient overflows: the port reads the overflow back and skips
    ``optimizer.step`` as the JAX eager scaler does; scale, counts and
    parameters follow JAX's (fp16 parameters: 2**-10 relative)."""
    rng = np.random.default_rng(7)
    init = rng.standard_normal((6, 4)).astype(np.float16)
    grads = [rng.standard_normal((6, 4)).astype(np.float32)
             for _ in range(5)]
    grads[2][1, 1] = np.inf
    jp = JParameter(jnp.asarray(init))
    tp = torch.from_numpy(init).requires_grad_()
    js = paddle.amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2)
    ts = GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2)
    jo = paddle.optimizer.Adam(0.01, parameters=[jp])
    to = Adam(0.01, parameters=[tp])
    for g in grads:
        # the gradient a backward of the scaled loss would give
        jp.grad = JTensor._wrap(jnp.asarray(g * js._scale, jnp.float16))
        tp.grad = torch.from_numpy(
            g * float(ts.get_loss_scaling())).to(torch.float16)
        js.step(jo)
        ts.step(to)
        jo.clear_grad()
        to.clear_grad()
        assert ts.state_dict() == js.state_dict()
    np.testing.assert_allclose(tp.detach().float().numpy(),
                               np.asarray(jp._data, np.float32),
                               rtol=2.0 ** -10)
    assert to.state_dict()["step"] == jo.state_dict()["step"] == 4


def test_fused_windows_match_jax_fused_step(jax_runs):
    """``fused_steps=4`` over 10 batches (priming window, fused window,
    tail of 2) with a schedule and a global-norm clip: losses and every
    metric series as JAX's, parameters within 1e-3 of the summed lr."""
    ref = jax_runs["fused"]
    m, sched, opt, step = _fused_setup(ref["weights"], K)
    ids, labels = _batches(N, 2, 16, seed=2)
    losses = _run_windows(step, sched, ids, labels)
    step.sync()
    np.testing.assert_allclose(losses.numpy(), ref["losses"], rtol=1e-5)
    series = _series(step.metrics)
    assert series["lr"] == ref["series"]["lr"]
    for name in SERIES:
        got, want = zip(*series[name]), zip(*ref["series"][name])
        (gs, gv), (ws, wv) = got, want
        assert gs == ws == tuple(range(1, N + 1)), name
        np.testing.assert_allclose(gv, wv, rtol=1e-5, err_msg=name)
    lrs = [v for _, v in series["lr"]]
    assert lrs[2] != lrs[3], "the schedule did not move inside a window"
    _check_fp32_params({n: p.detach().numpy()
                        for n, p in m.named_parameters()},
                       ref["params"], sum(lrs))
    assert opt.state_dict()["step"] == N
    rec = step.metrics.latest("tok_s")
    assert rec is not None and rec > 0


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_k4_windows_equal_k1_steps_bit_for_bit(jax_runs, dropout):
    """The port's fused windows against its own single steps, a schedule
    moving inside the windows: equal losses and parameters, bit for bit
    (with dropout too: the windows draw the same masks in the same
    order)."""
    w = jax_runs["fused"]["weights"]
    ids, labels = _batches(N, 2, 16, seed=2)
    m1, s1, o1, st1 = _fused_setup(w, 1, dropout)
    l1 = _run_single(st1, s1, ids, labels)
    m4, s4, o4, st4 = _fused_setup(w, K, dropout)
    l4 = _run_windows(st4, s4, ids, labels)
    assert torch.equal(l1, l4)
    for (n, a), b in zip(torch.nn.Module.named_parameters(m1),
                         torch.nn.Module.parameters(m4)):
        assert torch.equal(a, b), n
    assert o1.state_dict()["step"] == o4.state_dict()["step"] == N
    assert s1.last_lr == s4.last_lr


@pytest.mark.parametrize("name", ["NAdam", "RAdam"])
def test_step_count_optimizers_in_windows_equal_single_steps(jax_runs,
                                                             name):
    """NAdam and RAdam read their step count from a device tensor, so a
    window (a CUDA graph on the card) gives its single steps' bits."""
    w = jax_runs["fused"]["weights"]
    ids, labels = _batches(N, 2, 16, seed=8)
    out = []
    for k in (1, K):
        m = _model(w, max_seq_len=16, use_flash_attention=False)
        sched = tlr.StepDecay(0.01, step_size=3, gamma=0.5)
        opt = getattr(optimizer, name)(sched, parameters=m.parameters())
        step = CompiledTrainStep(m, _loss_fn(), opt, fused_steps=k)
        losses = (_run_single if k == 1 else _run_windows)(
            step, sched, ids, labels)
        out.append((losses, [p.detach().clone()
                             for p in torch.nn.Module.parameters(m)]))
    (l1, p1), (l4, p4) = out
    assert torch.equal(l1, l4)
    assert all(torch.equal(a, b) for a, b in zip(p1, p4))


def test_each_step_of_a_window_draws_fresh_dropout_masks(jax_runs):
    """lr 0 and one batch repeated over a window: the parameters never
    move, so the four losses differ only by their dropout masks."""
    m = _model(jax_runs["fused"]["weights"], max_seq_len=16,
               use_flash_attention=False, dropout=0.3)
    step = CompiledTrainStep(m, _loss_fn(), SGD(0.0, parameters=[
        *m.parameters()]), fused_steps=K)
    ids, labels = _batches(1, 2, 16, seed=3)
    win = Window((torch.from_numpy(ids).repeat(K, 1, 1),
                  torch.from_numpy(labels).repeat(K, 1, 1)), K)
    step(win)                     # priming
    losses = step(win).tolist()   # fused
    assert len(set(losses)) == K, losses


def test_window_counters_priming_steady_and_tail(jax_runs):
    w = jax_runs["fused"]["weights"]
    ids, labels = _batches(3 * K + 2, 2, 16, seed=4)
    _, _, _, step = _fused_setup(w, K, metrics=False)

    def window(lo, hi):
        return Window((torch.from_numpy(ids[lo:hi]),
                       torch.from_numpy(labels[lo:hi])), hi - lo)

    moved = []
    for lo, hi in ((0, K), (K, 2 * K), (2 * K, 3 * K), (3 * K, 3 * K + 2)):
        before = counters.snapshot()
        out = step(window(lo, hi))
        assert out.shape == (hi - lo,)
        moved.append(counters.delta(before))
    prime, first, steady, tail = moved
    assert prime["jit.fused_fallback_steps"] == prime["jit.steps"] == K
    assert prime["jit.host.dispatches"] == K
    assert "jit.fused_windows" not in prime
    for d in (first, steady):
        assert d["jit.host.dispatches"] == 1
        assert d["jit.steps"] == d["optimizer.steps"] == K
        assert d["jit.fused_windows"] == 1
        assert "jit.fused_fallback_steps" not in d
    assert tail["jit.fused_fallback_steps"] == tail["jit.steps"] == 2
    assert tail["jit.host.dispatches"] == 2


def test_raw_stacked_args_and_windows_on_an_unfused_step(jax_runs):
    w = jax_runs["fused"]["weights"]
    ids, labels = _batches(K, 2, 16, seed=5)
    _, _, _, fused = _fused_setup(w, K, metrics=False)
    out = fused(torch.from_numpy(ids), torch.from_numpy(labels))
    assert out.shape == (K,)
    _, s1, _, single = _fused_setup(w, 1, metrics=False)
    ref = [single(torch.from_numpy(x), torch.from_numpy(y))
           for x, y in zip(ids, labels)]
    _, _, _, unfused = _fused_setup(w, 1, metrics=False)
    got = unfused(Window((torch.from_numpy(ids), torch.from_numpy(labels)),
                         K))
    assert torch.equal(got, torch.stack(ref))
    assert torch.equal(out, got)


def test_check_nan_inf_names_the_step_inside_a_window(jax_runs):
    """A loss poisoned at global step 7 (index 2 of the second window):
    the window runs and then raises naming that step, as JAX does."""
    w = jax_runs["fused"]["weights"]
    m = _model(w, max_seq_len=16, use_flash_attention=False)
    crit = GPTPretrainingCriterion()
    step = CompiledTrainStep(m, lambda m, x, y, s: crit(m(x), y) * s,
                             SGD(0.01, parameters=[*m.parameters()]),
                             fused_steps=K)
    ids, labels = _batches(2 * K, 2, 16, seed=6)
    poison = torch.ones(2 * K)
    poison[K + 2] = float("nan")
    args = (torch.from_numpy(ids), torch.from_numpy(labels), poison)
    step(*(a[:K] for a in args))                 # priming, clean
    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        before = counters.snapshot()
        with pytest.raises(FloatingPointError,
                           match=r"FLAGS_check_nan_inf: non-finite .*train "
                                 r"step 7 \(step 2 of a 4-step fused "
                                 r"window\): grad:fc1_b, .*\(\+25 more\)"):
            step(*(a[K:] for a in args))
        assert counters.delta(before)["jit.nan_inf_hits"] == 1
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})


def test_scaler_skip_inside_a_fused_window_equals_single_steps(jax_runs):
    """fp16, a GradScaler and a loss scaled up at global step 6 (index 1
    of the second window) so that its gradients overflow: K=4 windows
    give the single steps' losses, parameters, optimizer state and scale,
    bit for bit."""
    w = {k: v.astype(np.float16) for k, v in
         jax_runs["fused"]["weights"].items()}
    ids, labels = _batches(2 * K, 2, 16, seed=7)
    boost = torch.ones(2 * K)
    boost[K + 1] = 1e4
    crit = GPTPretrainingCriterion()

    def run(k):
        m = _model(w, max_seq_len=16, use_flash_attention=False,
                   dtype="float16")
        scaler = GradScaler(init_loss_scaling=2.0 ** 10,
                            incr_every_n_steps=2)
        opt = AdamW(1e-3, parameters=m.named_parameters())
        step = CompiledTrainStep(m, lambda m, x, y, b: crit(m(x), y) * b,
                                 opt, scaler=scaler, fused_steps=k,
                                 metrics=True)
        args = (torch.from_numpy(ids), torch.from_numpy(labels), boost)
        if k == 1:
            losses = torch.stack([step(*(a[i] for a in args))
                                  for i in range(2 * K)])
        else:
            losses = torch.cat([step(*(a[lo:lo + K] for a in args))
                                for lo in (0, K)])
        step.sync()
        return m, opt, scaler, losses, step.metrics.series("scaler_skip")

    m1, o1, sc1, l1, skip1 = run(1)
    m4, o4, sc4, l4, skip4 = run(K)
    assert skip1 == skip4
    assert [s for s, v in skip1 if v] == [K + 2]
    assert torch.equal(l1, l4)
    for a, b in zip(torch.nn.Module.parameters(m1),
                    torch.nn.Module.parameters(m4)):
        assert torch.equal(a, b)
    s1, s4 = o1.state_dict(), o4.state_dict()
    for acc in s1["accumulators"]:
        for n, t in s1["accumulators"][acc].items():
            assert torch.equal(t, s4["accumulators"][acc][n]), (acc, n)
    assert sc1.state_dict() == sc4.state_dict()
