"""Expert parallelism and the MoE GPT on the mesh, in the port
(``CompiledTrainStep(mesh=...)`` over the experts split on ``dp``,
``LLMEngine(mesh=...)`` over the expert stacks split on ``mp``) against
the JAX package's global-batch step and the port's unsharded engine.

One spawn of two gloo ranks (``tests/_torch_mesh_workers.py``:
``moe_2ranks``) runs dp2 training and then mp2 serving, while the JAX
step runs here on the global batch, from the same fp32 weights (2
layers, hidden 32, 4 heads, 4 experts top-2, capacity factor 1.0, 3
AdamW steps of 4 x 16 tokens, plain attention).

* dp2: each rank holds 2 of the 4 experts (``[L, 2, H, F]``); the
  tokens meet them by all-to-all; routing, capacity and the aux loss are
  the global batch's, as the JAX package's GSPMD program sees them.
  Losses within rtol 1e-5 and atol 1e-6 of the JAX step's, parameters
  within rtol 1e-5 and atol ``LR / 20`` (the tolerances of
  ``test_torch_mesh_train.py``, for the same reasons), the first
  batch's aux within 1e-5.  The key third of ``qkv_b`` is left out of
  the parameter check: a bias added to every key shifts each query's
  scores by one constant, which the softmax removes, so its gradient is
  zero and AdamW turns its rounding noise into steps of up to ``lr``
  in either package (2.7e-4 apart here).
* Two controls must miss those bounds: the port without a mesh with
  each half of the batch routed on its own (a per-rank capacity:
  upstream Paddle's semantics, not the JAX package's), and the dp2 step
  with the expert stacks' gradients all-reduced as a replicated
  parameter's are (summing different experts' gradients).
* mp2 serving: ``fc1_w`` split on its hidden units (``[L, E, H, F/2]``),
  paged fp32, int8 KV + weights and slots; greedy tokens equal to the
  unsharded port engine's, and so are a model built under the mesh's.
"""

import numpy as np
import pytest

import _torch_mesh_workers as W

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=16, use_flash_attention=False, num_experts=4,
           moe_top_k=2, moe_capacity_factor=1.0, initializer_range=0.3)
SERVE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=32, use_flash_attention=False, num_experts=4,
             initializer_range=0.3)
LR = 1e-4
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = LR / 20
STEPS, B, S = 3, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_registries():
    yield
    from paddle_tpu.profiler import devicetime, flight, metrics, trace
    metrics.reset_metrics()
    flight.clear()
    trace.clear()
    devicetime.reset()


def _state(cfg, seed):
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    jp.seed(seed)
    m = GPTForCausalLM(GPTConfig(**cfg))
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _payload():
    rng = np.random.default_rng(3)
    return {"cfg": CFG, "lr": LR, "state": _state(CFG, 0),
            "ids": rng.integers(0, 64, (STEPS, B, S)).astype(np.int64),
            "labels": rng.integers(0, 64, (STEPS, B, S)).astype(np.int64),
            "serve_cfg": SERVE, "serve_state": _state(SERVE, 21),
            "prompts": [rng.integers(0, 64, n).tolist()
                        for n in (10, 5, 13, 3, 7)]}


def _jax_global(pl):
    """The JAX step on the global batch (no mesh: GSPMD's semantics),
    and the first batch's aux at the initial weights."""
    import paddle_tpu as jp
    import paddle_tpu.jit as pjit
    from paddle_tpu.models import (GPTConfig, GPTForCausalLM,
                                   GPTPretrainingCriterion)
    m = GPTForCausalLM(GPTConfig(**CFG))
    m.set_state_dict({k: jp.to_tensor(v) for k, v in pl["state"].items()})
    m(jp.to_tensor(pl["ids"][0]))
    aux0 = float(m.moe_aux_loss().numpy())
    crit = GPTPretrainingCriterion()
    opt = jp.optimizer.AdamW(LR, parameters=m.parameters())
    step = pjit.CompiledTrainStep(
        m, lambda m, x, y: crit(m(x), y) + m.moe_aux_loss() * 0.01, opt)
    losses = [float(step(jp.to_tensor(x), jp.to_tensor(y)).numpy())
              for x, y in zip(pl["ids"], pl["labels"])]
    step.sync()
    return losses, {k: np.asarray(v.numpy())
                    for k, v in m.state_dict().items()}, aux0


def _per_rank_capacity(pl):
    """The port without a mesh, each half of every batch routed on its
    own and the two halves' losses averaged (what two ranks that each
    capacitate their own tokens compute)."""
    import torch
    from paddle_tpu_torch import AdamW, CompiledTrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    m = W._gpt(CFG, pl["state"])
    crit = GPTPretrainingCriterion()
    h = B // 2

    def loss_fn(m, x, y):
        return sum(crit(m(x[i:i + h]), y[i:i + h]) + 0.01 * m.moe_aux_loss()
                   for i in (0, h)) / 2

    step = CompiledTrainStep(m, loss_fn, AdamW(LR,
                                               parameters=m.parameters()))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in zip(pl["ids"], pl["labels"])]
    return losses, m.gather_numpy_state()


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    pl = _payload()
    ranks = W.spawn("moe_2ranks", 2, tmp_path_factory.mktemp("moe"), pl)
    jax_out = _jax_global(pl)
    control = _per_rank_capacity(pl)
    return pl, jax_out, control, ranks.results()


def _signal(name, v):
    """``v`` without the key third of ``qkv_b`` (its updates are noise)."""
    if name != "qkv_b":
        return v
    H = v.shape[-1] // 3
    return np.concatenate([v[..., :H], v[..., 2 * H:]], -1)


def _miss(losses, state, jl, js):
    """How far a control lies from the JAX step, in units of the bounds:
    the worst loss and the worst parameter (above 1: out of bounds)."""
    loss = max(abs(a - b) / (ATOL + RTOL * abs(b))
               for a, b in zip(losses, jl))
    par = max(float(np.max(np.abs(_signal(k, state[k]) - _signal(k, v))
                           / (PARAM_ATOL + RTOL * np.abs(_signal(k, v)))))
              for k, v in js.items())
    return loss, par


def test_dp2_expert_parallel_matches_jax_global_batch(moe_run):
    pl, (jl, js, jaux0), _, res = moe_run
    for r, out in enumerate(res):
        assert out["shapes"]["fc1_w"] == (2, 2, 32, 128)
        assert out["shapes"]["fc2_w"] == (2, 2, 128, 32)
        assert out["shapes"]["fc1_b"] == (2, 2, 128)
        assert out["shapes"]["fc2_b"] == (2, 2, 32)
        assert out["shapes"]["gate_w"] == (2, 32, 4)
        assert out["placements"]["fc1_w"][1] == "dp"
        assert out["ep_collectives"] > 0
        assert out["ep_serving"].startswith("NotImplementedError")
        # an eager forward's rows count as the whole batch unless the
        # caller says they are this rank's own
        assert out["whole_batch_refused"].startswith("NotImplementedError")
        np.testing.assert_allclose(out["losses"], jl, rtol=RTOL, atol=ATOL)
        assert abs(out["aux0"] - jaux0) <= 1e-5 * abs(jaux0)
        for k, v in js.items():
            np.testing.assert_allclose(_signal(k, out["state"][k]),
                                       _signal(k, v), rtol=RTOL,
                                       atol=PARAM_ATOL, err_msg=k)


def test_controls_miss_the_bounds(moe_run):
    """Each gate can fail: a per-rank capacity moves the losses, and
    all-reducing the expert gradients moves the parameters."""
    pl, (jl, js, _), (cl, cs), res = moe_run
    loss_miss, par_miss = _miss(cl, cs, jl, js)
    assert loss_miss > 1 and par_miss > 1, (loss_miss, par_miss)
    for out in res:
        _, par_miss = _miss(out["control_losses"], out["control_state"], jl,
                            js)
        assert par_miss > 1, par_miss


def test_mp2_moe_serving_equals_unsharded(moe_run):
    _, _, _, res = moe_run
    for out in res:
        assert out["mp2_fc1_shard"] == (2, 4, 32, 64)
        assert out["split_fc1_shard"] == (2, 4, 32, 64)
        assert out["mp2"] == out["unsharded"]
        assert out["split_model"] == out["unsharded"]
        assert out["mp2_int8"] == out["unsharded_int8"]
        assert out["mp2_slots"] == out["unsharded_slots"]
        assert len({t for toks in out["mp2"] for t in toks}) >= 5
