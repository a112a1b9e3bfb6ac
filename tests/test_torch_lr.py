"""The port's learning-rate schedulers against the JAX package's.

Both are pure Python, so the tolerance is none: every scheduler's first
50 values are the same Python floats.  ``peek`` previews without
stepping, as ``tests/test_train_step_fused.py`` holds the JAX one to,
and ``state_dict`` round-trips.
"""

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

N = 50


def _lambda(epoch):
    return 0.95 ** epoch


#: (class name, constructor kwargs) — every concrete scheduler
CASES = [
    ("NoamDecay", dict(d_model=64, warmup_steps=10, learning_rate=1.0)),
    ("PiecewiseDecay", dict(boundaries=[5, 20, 35],
                            values=[0.1, 0.05, 0.01, 0.001])),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.1)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=30,
                             end_lr=0.001, power=2.0)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=12,
                             end_lr=0.001, power=1.0, cycle=True)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=10,
                          start_lr=0.0, end_lr=0.1)),
    ("ExponentialDecay", dict(learning_rate=0.1, gamma=0.9)),
    ("MultiStepDecay", dict(learning_rate=0.1, milestones=[10, 25, 40],
                            gamma=0.3)),
    ("StepDecay", dict(learning_rate=0.1, step_size=7, gamma=0.5)),
    ("LambdaDecay", dict(learning_rate=0.1, lr_lambda=_lambda)),
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=20,
                                  eta_min=0.001)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.1, T_0=6,
                                         T_mult=2, eta_min=0.001)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=40)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=40,
                        anneal_strategy="linear", phase_pct=0.25)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=5, step_size_down=8)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=4, mode="triangular2")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=4, mode="exp_range", exp_gamma=0.97)),
    ("LinearLR", dict(learning_rate=0.1, total_steps=30)),
    ("CosineAnnealingWithWarmupDecay", dict(max_lr=6e-4, min_lr=6e-5,
                                            warmup_step=10,
                                            decay_step=40)),
]

#: a loss that improves, stalls and improves again: ReduceOnPlateau's
#: patience, cooldown and min_lr all act within 50 steps
_METRICS = [1.0 / (1 + i) if i < 10 or i > 30 else 0.1 for i in range(N)]


def _values(mod, name, kw):
    sched = getattr(mod, name)(**kw)
    vals = []
    for _ in range(N):
        vals.append(sched())
        sched.step()
    return vals


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_first_50_values_equal_jax(name, kw):
    got, want = _values(tlr, name, kw), _values(jlr, name, kw)
    assert got == want
    assert all(type(v) is type(w) for v, w in zip(got, want))


def test_linear_warmup_over_a_scheduler_equals_jax():
    def run(mod):
        inner = mod.CosineAnnealingDecay(learning_rate=0.1, T_max=30)
        sched = mod.LinearWarmup(learning_rate=inner, warmup_steps=8,
                                 start_lr=0.0, end_lr=0.1)
        out = []
        for _ in range(N):
            out.append(sched())
            sched.step()
        return out
    assert run(tlr) == run(jlr)


def test_reduce_on_plateau_equals_jax():
    def run(mod):
        sched = mod.ReduceOnPlateau(learning_rate=0.1, factor=0.5,
                                    patience=3, cooldown=2, min_lr=0.01)
        out = []
        for m in _METRICS:
            out.append(sched())
            sched.step(m)
        return out, sched.state_dict()
    assert run(tlr) == run(jlr)


def test_every_scheduler_is_ported():
    names = {n for n, v in vars(jlr).items()
             if isinstance(v, type) and issubclass(v, jlr.LRScheduler)}
    assert len(names) == 18
    assert names <= set(vars(tlr))
    covered = {n for n, _ in CASES} | {"LRScheduler", "ReduceOnPlateau"}
    assert covered == names


def test_peek_matches_stepping():
    sched = tlr.StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
    preview = sched.peek(6)
    vals = [float(sched.last_lr)]
    for _ in range(5):
        sched.step()
        vals.append(float(sched.last_lr))
    assert preview == vals
    assert preview == [0.1, 0.1, 0.05, 0.05, 0.025, 0.025]


def test_peek_does_not_mutate():
    sched = tlr.StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
    sched.step()
    before = (sched.last_epoch, sched.last_lr)
    first = sched.peek(5)
    assert (sched.last_epoch, sched.last_lr) == before
    assert sched.peek(5) == first


def test_peek_linear_warmup_nested_scheduler_untouched():
    inner = tlr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    sched = tlr.LinearWarmup(learning_rate=inner, warmup_steps=3,
                             start_lr=0.0, end_lr=0.1)
    inner_before = (inner.last_epoch, inner.last_lr)
    preview = sched.peek(6)
    assert (inner.last_epoch, inner.last_lr) == inner_before
    vals = [float(sched.last_lr)]
    for _ in range(5):
        sched.step()
        vals.append(float(sched.last_lr))
    assert preview == vals
    assert preview == jlr.LinearWarmup(
        learning_rate=jlr.StepDecay(learning_rate=0.1, step_size=1,
                                    gamma=0.5),
        warmup_steps=3, start_lr=0.0, end_lr=0.1).peek(6)


def test_peek_validates_k():
    with pytest.raises(ValueError):
        tlr.StepDecay(learning_rate=0.1, step_size=2).peek(0)


@pytest.mark.parametrize("name,kw", [CASES[-1], CASES[13], CASES[6]],
                         ids=["warmup_cosine", "one_cycle", "linear_warmup"])
def test_state_dict_round_trips(name, kw):
    """Restore after 17 steps into a fresh scheduler: the next 20 values
    are the uninterrupted run's, and the state equals JAX's."""
    a, b = getattr(tlr, name)(**kw), getattr(tlr, name)(**kw)
    j = getattr(jlr, name)(**kw)
    for _ in range(17):
        a.step()
        j.step()
    state = a.state_dict()
    assert state == j.state_dict()
    b.set_state_dict(state)
    for _ in range(20):
        assert b() == a()
        a.step()
        b.step()
