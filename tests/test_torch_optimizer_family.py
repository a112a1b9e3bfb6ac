"""The port's dense optimizer family against the JAX package's, five
eager steps on the same parameters and numpy gradients.

Both run the same fp32 elementwise formulas in the same order, so
parameters, masters and accumulators agree within fp32 rounding:
``RTOL`` relative to each tensor's scale after five steps.  For bf16
parameters (fp32 masters) the masters are held so, and each bf16
parameter must equal its own master rounded to bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = [(4, 3), (5,), (2, 3, 2)]
STEPS = 5
RTOL = 1e-5

#: the 13 dense classes with the options they are built with (the same
#: on both sides); ``wd`` marks the classes that take ``weight_decay``
FAMILY = [
    ("SGD", dict(learning_rate=0.05), True),
    ("Momentum", dict(learning_rate=0.05, momentum=0.9), True),
    ("Momentum", dict(learning_rate=0.05, momentum=0.8,
                      use_nesterov=True), True),
    ("Adam", dict(learning_rate=0.01), True),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.1), False),
    ("Adagrad", dict(learning_rate=0.05,
                     initial_accumulator_value=0.1), True),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9), True),
    ("Adamax", dict(learning_rate=0.01), True),
    ("RMSProp", dict(learning_rate=0.01, momentum=0.5), True),
    ("RMSProp", dict(learning_rate=0.01, centered=True), True),
    ("ASGD", dict(learning_rate=0.01, batch_num=2), True),
    ("NAdam", dict(learning_rate=0.01), True),
    ("RAdam", dict(learning_rate=0.01), True),
    ("Rprop", dict(learning_rate=0.01), False),
    ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.05), False),
]
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    x = x._data if hasattr(x, "_data") else x
    return np.asarray(x).astype(np.float32)


def _data(seed=4, steps=STEPS):
    rng = np.random.default_rng(seed)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return init, grads


def _params(init, dtype):
    jd, td = DT[dtype]
    return ([JParameter(jnp.asarray(w, jd)) for w in init],
            [torch.from_numpy(w).to(td).requires_grad_() for w in init])


def _run(jopt, tparams_opt, jparams, tparams, grads, dtype, scheds=()):
    jd, td = DT[dtype]
    for step_grads in grads:
        for jp, tp, g in zip(jparams, tparams, step_grads):
            jp.grad = JTensor._wrap(jnp.asarray(g, jd))
            tp.grad = torch.from_numpy(g).to(td)
        jopt.step()
        jopt.clear_grad()
        tparams_opt.step()
        tparams_opt.clear_grad()
        for s in scheds:
            s.step()


def _close(got, want, what):
    want = _f32(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_f32(got), want, rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


def _assert_match(jopt, to, jparams, tparams, dtype):
    jstate, tstate = jopt.state_dict(), to.state_dict()
    assert tstate["step"] == jstate["step"]
    assert set(tstate["accumulators"]) == set(jstate["accumulators"])
    for i, (jp, tp) in enumerate(zip(jparams, tparams)):
        assert tp.grad is None
        name = f"param_{i}"
        for acc, store in jstate["accumulators"].items():
            _close(tstate["accumulators"][acc][name], store[jp.name],
                   f"{acc} {i}")
        if dtype == "bfloat16":
            master = tstate["master_weights"][name]
            _close(master, jstate["master_weights"][jp.name], f"master {i}")
            assert torch.equal(tp.detach(), master.to(tp.dtype)), i
        else:
            assert tstate["master_weights"] == {}
            _close(tp, jp, f"param {i}")


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("name,kw,wd", FAMILY,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(FAMILY)])
def test_five_steps_match_jax(name, kw, wd, dtype):
    init, grads = _data()
    jparams, tparams = _params(init, dtype)
    extra = dict(weight_decay=0.01) if wd else {}
    jopt = getattr(paddle.optimizer, name)(parameters=jparams, **kw,
                                           **extra)
    to = getattr(topt, name)(parameters=tparams, **kw, **extra)
    _run(jopt, to, jparams, tparams, grads, dtype)
    _assert_match(jopt, to, jparams, tparams, dtype)


def test_every_dense_optimizer_is_ported():
    """The 13 dense classes, and LBFGS (once refused naming A4): one
    ``step(closure)`` calls the closure once and, with no history yet,
    moves by ``-lr * g`` — JAX's single step with no line search."""
    assert len({n for n, _, _ in FAMILY}) == 13
    g0 = np.array([0.5, -2.0], np.float32)
    calls = []
    x = torch.zeros(2, requires_grad=True)

    def closure():
        calls.append(1)
        x.grad = torch.from_numpy(g0)

    jx = JParameter(jnp.zeros(2, jnp.float32))

    def jclosure():
        jx.grad = JTensor._wrap(jnp.asarray(g0))

    topt.LBFGS(learning_rate=0.3, parameters=[x]).step(closure)
    paddle.optimizer.LBFGS(learning_rate=0.3, parameters=[jx]).step(
        jclosure)
    assert len(calls) == 1
    np.testing.assert_array_equal(_f32(x), _f32(jx))
    np.testing.assert_allclose(_f32(x), -0.3 * g0, rtol=1e-7)


@pytest.mark.parametrize("history", [2, 100])
def test_lbfgs_with_closure_matches_jax(history):
    """Ten ``step(closure)`` calls on a least-squares problem (fp32,
    ``history_size`` 2 trims the history; 100 keeps it all): parameters
    after every step as JAX's within ``RTOL`` of their scale (the same
    dots summed in another order), and the loss falls toward the
    optimum."""
    rng = np.random.default_rng(12)
    # scaled so that the first step, -lr * g, does not overshoot
    A = (0.1 * rng.standard_normal((32, 8))).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    x0 = rng.standard_normal(8).astype(np.float32)
    jx = JParameter(jnp.asarray(x0))
    tx = torch.from_numpy(x0.copy()).requires_grad_()
    jo = paddle.optimizer.LBFGS(learning_rate=1.0, history_size=history,
                                parameters=[jx])
    to = topt.LBFGS(learning_rate=1.0, history_size=history,
                    parameters=[tx])
    jA, jb = paddle.to_tensor(A), paddle.to_tensor(b)
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    losses = []

    def jclosure():
        jo.clear_grad()
        r = paddle.matmul(jA, jx) - jb
        loss = (r * r).sum()
        loss.backward()
        return loss

    def tclosure():
        to.clear_grad()
        loss = ((tA @ tx - tb) ** 2).sum()
        loss.backward()
        losses.append(float(loss))
        return loss

    for step in range(10):
        jo.step(jclosure)
        to.step(tclosure)
        _close(tx, jx, f"x after step {step}")
    assert len(to._s) == min(history, len(jo._s)) == len(jo._s)
    # the loss falls to within a tenth of its start's excess over the
    # least-squares optimum
    best = float(np.sum((A @ np.linalg.lstsq(A, b, rcond=None)[0] - b) ** 2))
    assert losses[-1] - best < 0.1 * (losses[0] - best)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_amsgrad_matches_jax(name):
    init, grads = _data(seed=8)
    # a shrinking gradient makes vhat fall, so the running max binds
    grads = [[g * 0.5 ** t for g in gs] for t, gs in enumerate(grads)]
    jparams, tparams = _params(init, "float32")
    jopt = getattr(paddle.optimizer, name)(0.01, parameters=jparams,
                                           amsgrad=True)
    to = getattr(topt, name)(0.01, parameters=tparams, amsgrad=True)
    _run(jopt, to, jparams, tparams, grads, "float32")
    _assert_match(jopt, to, jparams, tparams, "float32")
    assert "moment2_max" in to.state_dict()["accumulators"]


@pytest.mark.parametrize("dtype", list(DT))
def test_adamw_lr_ratio_and_apply_decay_param_fun_match_jax(dtype):
    init, grads = _data(seed=9)
    jparams, tparams = _params(init, dtype)
    jopt = paddle.optimizer.AdamW(
        0.01, parameters=jparams, weight_decay=0.2,
        lr_ratio=lambda p: 0.5 if len(p.shape) == 1 else 1.0,
        apply_decay_param_fun=lambda n: n != jparams[2].name)
    to = topt.AdamW(
        0.01, parameters=tparams, weight_decay=0.2,
        lr_ratio=lambda p: 0.5 if p.dim() == 1 else 1.0,
        apply_decay_param_fun=lambda n: n != "param_2")
    _run(jopt, to, jparams, tparams, grads, dtype)
    _assert_match(jopt, to, jparams, tparams, dtype)


@pytest.mark.parametrize("name,decay", [("SGD", "L2Decay"),
                                        ("Momentum", "L1Decay"),
                                        ("Adam", "L2Decay"),
                                        ("AdamW", "L1Decay")])
def test_regularizer_objects_match_jax(name, decay):
    """Both packages take the regularizer's coefficient and add it as
    ``coeff * w`` (AdamW: decoupled decay), for L1Decay too (ROADMAP.md
    C)."""
    init, grads = _data(seed=10)
    jparams, tparams = _params(init, "float32")
    jopt = getattr(paddle.optimizer, name)(
        0.01, parameters=jparams,
        weight_decay=getattr(paddle.optimizer, decay)(0.05))
    to = getattr(topt, name)(0.01, parameters=tparams,
                             weight_decay=getattr(topt, decay)(0.05))
    _run(jopt, to, jparams, tparams, grads, "float32")
    _assert_match(jopt, to, jparams, tparams, "float32")


def test_parameter_groups_match_jax():
    init, grads = _data(seed=11)
    jparams, tparams = _params(init, "float32")
    jopt = paddle.optimizer.Adam(0.01, weight_decay=0.01, parameters=[
        {"params": jparams[:2]}, {"params": jparams[2:]}])
    to = topt.Adam(0.01, weight_decay=0.01, parameters=[
        {"params": tparams[:2]}, {"params": tparams[2:]}])
    assert len(to._lr_tensors) == 2
    _run(jopt, to, jparams, tparams, grads, "float32")
    _assert_match(jopt, to, jparams, tparams, "float32")


def test_group_learning_rate_and_weight_decay_act_as_in_paddle():
    """A group's ``learning_rate`` scales the lr and its ``weight_decay``
    replaces the optimizer's for its parameters: the same as separate
    optimizers with those settings, bit for bit.  (The JAX package reads
    neither key: ROADMAP.md C.)"""
    init, grads = _data(seed=12)
    _, grouped = _params(init, "float32")
    _, solo = _params(init, "float32")
    opt = topt.AdamW(0.01, weight_decay=0.1, parameters=[
        {"params": grouped[:1]},
        {"params": grouped[1:], "learning_rate": 0.5, "weight_decay": 0.0}])
    a = topt.AdamW(0.01, weight_decay=0.1, parameters=solo[:1])
    b = topt.AdamW(0.005, weight_decay=0.0, parameters=solo[1:])
    for gs in grads:
        for p, q, g in zip(grouped, solo, gs):
            p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g)
        for o in (opt, a, b):
            o.step()
            o.clear_grad()
    for p, q in zip(grouped, solo):
        assert torch.equal(p, q)


def test_scheduler_and_global_norm_clip_in_the_optimizer_match_jax():
    init, grads = _data(seed=13)
    grads = [[3.0 * g for g in gs] for gs in grads]   # the clip bites
    jparams, tparams = _params(init, "bfloat16")
    jsched = jlr.CosineAnnealingWithWarmupDecay(0.01, 0.001, 2, 4)
    tsched = tlr.CosineAnnealingWithWarmupDecay(0.01, 0.001, 2, 4)
    jopt = paddle.optimizer.AdamW(jsched, parameters=jparams,
                                  grad_clip=jclip.ClipGradByGlobalNorm(1.0))
    to = topt.AdamW(tsched, parameters=tparams,
                    grad_clip=tclip.ClipGradByGlobalNorm(1.0))
    assert to.get_lr() == jopt.get_lr() == 0.0
    _run(jopt, to, jparams, tparams, grads, "bfloat16",
         scheds=(jsched, tsched))
    _assert_match(jopt, to, jparams, tparams, "bfloat16")
    assert to.get_lr() == jopt.get_lr()


def test_state_dict_has_the_jax_layout_and_round_trips():
    """Keys as JAX's (plus the group lr tensors), the scheduler's state
    inside; saved after 3 steps and loaded into the optimizer after 5,
    two more steps replay steps 4-5 bit for bit, and loading writes into
    the tensors the optimizer already holds."""
    init, grads = _data(seed=14, steps=5)
    jparams, tparams = _params(init, "bfloat16")
    jsched = jlr.StepDecay(0.01, step_size=2, gamma=0.5)
    tsched = tlr.StepDecay(0.01, step_size=2, gamma=0.5)
    jopt = paddle.optimizer.AdamW(jsched, parameters=jparams)
    to = topt.AdamW(tsched, parameters=tparams)
    _run(jopt, to, jparams, tparams, grads[:3], "bfloat16",
         scheds=(jsched, tsched))
    jstate, saved = jopt.state_dict(), to.state_dict()
    assert set(saved) == set(jstate) | {"lr"}
    assert saved["LR_Scheduler"] == jstate["LR_Scheduler"]
    assert saved["step"] == jstate["step"] == 3
    for acc in jstate["accumulators"]:
        assert set(saved["accumulators"][acc]) == {
            f"param_{i}" for i in range(len(SHAPES))}
    weights = [p.detach().clone() for p in tparams]

    def two_more():
        for gs in grads[3:]:
            for p, g in zip(tparams, gs):
                p.grad = torch.from_numpy(g).to(p.dtype)
            to.step()
            to.clear_grad()
            tsched.step()
        return [p.detach().clone() for p in tparams], to.state_dict()

    first, first_state = two_more()
    held = {acc: dict(store) for acc, store in to._accumulators.items()}
    masters = dict(to._master_weights)
    with torch.no_grad():
        for p, w in zip(tparams, weights):
            p.copy_(w)
    to.set_state_dict(saved)
    assert tsched.last_epoch == 3 and to.state_dict()["step"] == 3
    for acc, store in to._accumulators.items():
        assert all(store[k] is held[acc][k] for k in store)
    assert all(to._master_weights[k] is masters[k] for k in masters)
    second, second_state = two_more()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for acc in first_state["accumulators"]:
        for n, t in first_state["accumulators"][acc].items():
            assert torch.equal(t, second_state["accumulators"][acc][n])
    for a, b in zip(first_state["lr"], second_state["lr"]):
        assert torch.equal(a, b)


def test_optimizer_loads_a_jax_state_dict():
    init, grads = _data(seed=15)
    jparams, tparams = _params(init, "float32")
    jopt = paddle.optimizer.Adam(0.01, parameters=jparams)
    for gs in grads[:2]:
        for jp, g in zip(jparams, gs):
            jp.grad = JTensor._wrap(jnp.asarray(g))
        jopt.step()
        jopt.clear_grad()
    to = topt.Adam(0.01, parameters=tparams)
    to.load_numpy_state(jopt.state_dict(),
                        {p.name: f"param_{i}" for i, p in
                         enumerate(jparams)})
    with torch.no_grad():
        for p, jp in zip(tparams, jparams):
            p.copy_(torch.from_numpy(_f32(jp)))
    _run(jopt, to, jparams, tparams, grads[2:], "float32")
    _assert_match(jopt, to, jparams, tparams, "float32")


@pytest.mark.parametrize("name,kw", [("NAdam", dict(beta2=0.99)),
                                     ("RAdam", dict(beta2=0.9))])
def test_device_step_count_matches_jax_after_a_resume(name, kw):
    """NAdam's and RAdam's bias corrections read the step count from a
    device tensor: loaded from a JAX state after 3 steps, 7 more steps
    follow JAX's (RAdam with beta2 0.9 crosses from its unrectified
    update to the rectified one, rho_t > 5, at step 6)."""
    init, grads = _data(seed=16, steps=10)
    jparams, tparams = _params(init, "float32")
    jopt = getattr(paddle.optimizer, name)(0.01, parameters=jparams, **kw)
    for gs in grads[:3]:
        for jp, g in zip(jparams, gs):
            jp.grad = JTensor._wrap(jnp.asarray(g))
        jopt.step()
        jopt.clear_grad()
    to = getattr(topt, name)(0.01, parameters=tparams, **kw)
    to.load_numpy_state(jopt.state_dict(),
                        {p.name: f"param_{i}" for i, p in
                         enumerate(jparams)})
    assert float(to._step_t) == 3.0
    with torch.no_grad():
        for p, jp in zip(tparams, jparams):
            p.copy_(torch.from_numpy(_f32(jp)))
    _run(jopt, to, jparams, tparams, grads[3:], "float32")
    _assert_match(jopt, to, jparams, tparams, "float32")
    assert float(to._step_t) == to.state_dict()["step"] == 10


def test_sparse_gradients_and_lazy_mode_name_a4():
    """Once refused naming ROADMAP.md A4, now ported: a SelectedRows
    gradient set on a parameter (duplicate rows) steps SGD row-wise and
    AdamW(lazy_mode=True) on the touched rows, as JAX's do, for two
    steps (fp32, ``RTOL``); untouched rows keep their start bits."""
    from paddle_tpu.core.selected_rows import SelectedRows as JSR
    from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    rows = [1, 5, 1]
    for name, kw in (("SGD", {}), ("AdamW", dict(lazy_mode=True))):
        jparams, tparams = _params([w0], "float32")
        jo = getattr(paddle.optimizer, name)(0.1, parameters=jparams, **kw)
        to = getattr(topt, name)(0.1, parameters=tparams, **kw)
        for _ in range(2):
            vals = rng.standard_normal((3, 4)).astype(np.float32)
            jparams[0].grad = JSR(rows, jnp.asarray(vals), 8)
            tparams[0].grad = None
            from paddle_tpu_torch.core.selected_rows import set_sparse_grad
            set_sparse_grad(tparams[0], TSR(torch.tensor(rows),
                                            torch.from_numpy(vals), 8))
            jo.step()
            jo.clear_grad()
            to.step()
            to.clear_grad()
        _close(tparams[0], jparams[0], name)
        untouched = [0, 2, 3, 4, 6, 7]
        np.testing.assert_array_equal(_f32(tparams[0])[untouched],
                                      w0[untouched])
