"""Pipeline-parallel GPT training in the port (``distributed.pipeline``:
GPipe and the interleaved schedule inside the GPT's forward,
``Pipeline1F1BTrainStep``'s 1F1B and zero-bubble) against the JAX
package's compiled schedules (``paddle_tpu/distributed/pipeline.py``,
``engine.py``), as ``tests/test_pipeline_1f1b.py``, ``test_pipeline_tp.py``,
``test_pipeline_zb.py`` and ``test_distributed.py`` run them.

Two gloo ranks (``tests/_torch_mesh_workers.py``: ``pp_2ranks``) run
pp 2; meanwhile the JAX steps run here on the 8-device virtual mesh
under ``fleet.init``/``fleet._reset()`` (pp 2 x dp 4), each once (one
module fixture), from the same fp32
weights: a 4-layer GPT (hidden 64, 4 heads, vocabulary 128, S 16, plain
attention, dropout 0), 4 AdamW steps of 16 x 16 tokens, M 4
microbatches.  Tolerances are ``tests/test_torch_mesh_train.py``'s:
losses within rtol 1e-5, atol 1e-6; every gathered parameter within
rtol 1e-5, atol LR / 20, ``qkv_b``'s key third left out (its gradient
is fp32 noise, which AdamW turns into steps of up to LR).  Two controls
must miss those limits: stage 1 receiving zeros in place of the shifted
activation, and the embedding's and head's gradients not summed over
pp.  The MoE GPT under GPipe and the four-rank runs (1F1B x tensor
parallelism, zero-bubble over pp 4) are ``tests/test_torch_pp_mp_train.py``'s.
"""

import contextlib

import numpy as np
import pytest

import _torch_mesh_workers as W

CFG = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
           max_seq_len=16, use_flash_attention=False)
LR = 1e-4
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = LR / 20
STEPS, B, S, M = 4, 16, 16, 4
AUX_W = 0.01


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_registries():
    """The JAX steps here fill the JAX package's global registries:
    cleared after the module."""
    yield
    from paddle_tpu.profiler import devicetime, flight, metrics, trace
    metrics.reset_metrics()
    flight.clear()
    trace.clear()
    devicetime.reset()


def _states(rng):
    """The JAX GPT's initial weights (seed 0), and from them the untied
    model's (an ``lm_head`` beside them) and the 2-expert MoE model's (the
    expert stacks in place of the FFN), the new weights drawn from
    ``rng`` as the JAX initializer draws them: N(0, 0.02), zero biases."""
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    jp.seed(0)
    m = GPTForCausalLM(GPTConfig(**CFG))
    state = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    L, H, V = CFG["num_layers"], CFG["hidden_size"], CFG["vocab_size"]
    F, E = 4 * H, 2

    def normal(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    untied = {**state, "lm_head": normal(H, V)}
    moe = {**state, "gate_w": normal(L, H, E), "fc1_w": normal(L, E, H, F),
           "fc1_b": np.zeros((L, E, F), np.float32),
           "fc2_w": normal(L, E, F, H),
           "fc2_b": np.zeros((L, E, H), np.float32)}
    return state, untied, moe


def _payload():
    rng = np.random.default_rng(5)
    state, untied, moe = _states(rng)
    return {"cfg": CFG, "lr": LR, "M": M, "aux_w": AUX_W,
            "ids": rng.integers(0, 128, (STEPS, B, S)).astype(np.int64),
            "labels": rng.integers(0, 128, (STEPS, B, S)).astype(np.int64),
            "state": state, "state_untied": untied, "state_moe": moe,
            "chain_w": (rng.standard_normal((4, 8, 8)) * 0.3
                        ).astype(np.float32),
            "chain_x": rng.standard_normal((8, 4, 8)).astype(np.float32)}


@contextlib.contextmanager
def _jax_fleet(**degrees):
    from paddle_tpu.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        yield
    finally:
        fleet._reset()


def _jax_train(pl, over=None, state="state", kind="step"):
    import paddle_tpu as jp
    from paddle_tpu.distributed import DistributedTrainStep
    from paddle_tpu.distributed.engine import Pipeline1F1BTrainStep
    from paddle_tpu.models import (GPTConfig, GPTForCausalLM,
                                   GPTPretrainingCriterion)
    cfg = {**CFG, **(over or {})}
    m = GPTForCausalLM(GPTConfig(**cfg))
    m.set_state_dict({k: jp.to_tensor(v) for k, v in pl[state].items()})
    opt = jp.optimizer.AdamW(LR, parameters=m.parameters())
    crit = GPTPretrainingCriterion()
    aux = cfg.get("num_experts", 0) > 0

    def loss_fn(m, x, y):
        loss = crit(m(x), y)
        return loss + AUX_W * m.moe_aux_loss() if aux else loss

    step = (DistributedTrainStep(m, loss_fn, opt) if kind == "step" else
            Pipeline1F1BTrainStep(m, opt, num_microbatches=M,
                                  schedule=kind))
    losses = [float(step(jp.to_tensor(pl["ids"][i]),
                         jp.to_tensor(pl["labels"][i])).numpy())
              for i in range(STEPS)]
    return losses, {k: np.asarray(v.numpy())
                    for k, v in m.state_dict().items()}


def _jax_apply(pl, with_aux):
    """JAX ``pipeline_apply`` (the compiled GPipe scan: the JAX package
    takes it only while tracing a step) on the pp-2 chain: output, aux,
    gradients of ``(out ** 2).sum() + 0.5 * aux``."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.state import STATE
    from paddle_tpu.distributed.pipeline import pipeline_apply
    w = jnp.asarray(pl["chain_w"]).reshape(2, -1, 8, 8)

    def stage(sp, h):
        for i in range(sp["w"].shape[0]):
            h = jnp.tanh(h @ sp["w"][i])
        return (h, (h ** 2).sum()) if with_aux else h

    def f(w, x):
        out = pipeline_apply(stage, {"w": w}, x, M, with_aux=with_aux)
        out, aux = out if with_aux else (out, jnp.zeros(()))
        return (out ** 2).sum() + 0.5 * aux, (out, aux)

    STATE.tracing_depth += 1
    try:
        (_, (out, aux)), (gw, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(w, jnp.asarray(pl["chain_x"]))
    finally:
        STATE.tracing_depth -= 1
    return (np.asarray(out), float(aux), np.asarray(gw).reshape(4, 8, 8),
            np.asarray(gx))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    pl = _payload()
    tmp = tmp_path_factory.mktemp("pp")
    two = W.spawn("pp_2ranks", 2, tmp, pl)
    jax_out = {}
    with _jax_fleet(dp=4, pp=2):
        jax_out["apply"] = {a: _jax_apply(pl, a) for a in (False, True)}
        jax_out["gpipe"] = _jax_train(pl)
        jax_out["gpipe_untied"] = _jax_train(
            pl, {"tie_word_embeddings": False}, "state_untied")
        jax_out["interleaved"] = _jax_train(
            pl, {"pp_schedule": "interleaved", "virtual_pp_degree": 2})
        jax_out["1f1b"] = _jax_train(pl, kind="1f1b")
    jax_out["logits"] = _jax_logits(pl)
    return pl, jax_out, two.results()


def _jax_logits(pl):
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    m = GPTForCausalLM(GPTConfig(**CFG))
    m.set_state_dict({k: jp.to_tensor(v) for k, v in pl["state"].items()})
    m.eval()
    return np.asarray(m(jp.to_tensor(pl["ids"][0])).numpy())


def _misses(got, want):
    """The names of the checks that ``got`` (losses, state) misses
    against ``want`` (empty: within every limit)."""
    (losses, state), (jl, js) = got[:2], want
    bad = []
    if not np.allclose(losses, jl, rtol=RTOL, atol=ATOL):
        bad.append("losses")
    for k, v in js.items():
        g = state[k]
        if k == "qkv_b":    # the key third's gradient is fp32 noise
            H = v.shape[-1] // 3
            g, v = (np.concatenate([t[..., :H], t[..., 2 * H:]], -1)
                    for t in (g, v))
        if not np.allclose(g, v, rtol=RTOL, atol=PARAM_ATOL):
            bad.append(k)
    return bad


@pytest.mark.parametrize("run,ref", [("gpipe_recompute", "gpipe"),
                                     ("1f1b_recompute", "1f1b")])
def test_recompute_in_the_stages_matches_jax_step(trained, run, ref):
    """GPipe under ``recompute="selective"`` and 1F1B under
    ``recompute=True``: the stage bodies replay their blocks in the
    backward (the JAX ``remat``), the same values as the JAX step of the
    schedule (whose remat changes no value either)."""
    _, j, res2 = trained
    for out in res2:
        assert _misses(out[run], j[ref]) == []


def test_eval_step_logits_match_jax_forward(trained):
    """``DistributedEvalStep`` on the pp-2 GPT: every rank calls the
    pipelined forward without gradients and gets the whole logits, the
    JAX model's eager forward's within rtol 1e-5, atol 1e-6."""
    _, j, res2 = trained
    for out in res2:
        np.testing.assert_allclose(out["eval"], j["logits"], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("with_aux", [False, True])
def test_pipeline_apply_matches_jax(trained, with_aux):
    """GPipe ``pipeline_apply`` at pp 2 (two tanh layers a stage, M 4,
    ``remat=True``): the output and the aux on every rank, each rank's
    stage gradients and stage 0's input gradient, against the compiled
    JAX scan's."""
    _, j, res2 = trained
    out, aux, gw, gx = j["apply"][with_aux]
    for r, res in enumerate(res2):
        o, a, g, x = res["apply"][with_aux]
        np.testing.assert_allclose(o, out, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a, aux, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, gw[2 * r:2 * r + 2], rtol=RTOL,
                                   atol=ATOL)
        if r == 0:
            np.testing.assert_allclose(x, gx, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("run", ["gpipe", "gpipe_untied", "interleaved",
                                 "1f1b"])
def test_pp2_schedules_match_jax_step(trained, run):
    """4 AdamW steps at pp 2: GPipe through ``CompiledTrainStep(mesh=)``
    with the tied embedding (the first stage's embedding gradient and
    the last stage's head gradient meet in one sum over pp), through
    ``DistributedTrainStep`` untied, the interleaved schedule (V 2, one
    layer a chunk: rank p holds layers p and p + 2) and 1F1B: losses
    and every gathered parameter against the JAX step of the same
    schedule."""
    _, j, res2 = trained
    for out in res2:
        assert _misses(out[run], j[run]) == []


def test_1f1b_holds_at_most_p_minus_s_microbatches(trained):
    """The 1F1B memory property: stage s holds P - s microbatches'
    graphs at most (GPipe holds M)."""
    _, _, res2 = trained
    assert [out["1f1b"][3] for out in res2] == [2, 1]


def test_every_rank_shifts_on_every_tick(trained):
    """Each step's ``dist.pp_shifts`` on every rank, active or not:
    GPipe 2 (M + P - 1) (a forward and a backward shift a tick), the
    interleaved schedule 2 (M + V P - 1), 1F1B and zero-bubble two a
    tick over 2 (M + P - 1) ticks."""
    _, _, res2 = trained
    want = {"gpipe": 2 * (M + 1), "interleaved": 2 * (M + 4 - 1),
            "1f1b": 4 * (M + 1)}
    for out in res2:
        for run, n in want.items():
            assert out[run][2] == [n] * STEPS, run


@pytest.mark.parametrize("control", ["no_shift", "no_pp_sum"])
def test_controls_miss_the_limits(trained, control):
    """GPipe with stage 1 receiving zeros in place of the shifted
    activation, and with the embedding's and head's gradients not summed
    over pp: each misses the limits the sound run meets."""
    _, j, res2 = trained
    for out in res2:
        assert _misses(out[control], j["gpipe"]) != []


def test_dropout_runs_are_deterministic(trained):
    """Dropout 0.1 under GPipe and under 1F1B: two identical runs give
    identical losses (each microbatch's backward runs on its forward's
    graph, masks included), finite and apart from the dropout-0
    losses."""
    _, j, res2 = trained
    for out in res2:
        for kind, (a, b) in out["dropout"].items():
            assert a == b, kind
            assert all(np.isfinite(a)), kind
            assert not np.allclose(a, j["gpipe"][0][:2], rtol=1e-4), kind
