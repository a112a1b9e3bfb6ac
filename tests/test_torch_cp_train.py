"""Long-context GPT training over the ``sep`` mesh axis in the port
(``CompiledTrainStep(mesh=build_mesh({"sep": ...}))``, the sequence split
of ``jit/mesh.py``, the GPT's ring attention and sequence all-gather)
against the JAX package's mesh step (``paddle_tpu/jit/__init__.py``
``CompiledTrainStep(mesh=)``, whose GPT runs ``ring_attention`` under
``context_parallel``, as ``tests/test_ring_attention.py`` trains it).

Two spawns of gloo ranks (``tests/_torch_mesh_workers.py``: ``cp_sep2``
over two ranks, ``cp_dp2sep2`` over four) start together; meanwhile the
JAX mesh steps run here on meshes of the same shape over the virtual
CPU devices, from the same fp32 weights: a 2-layer GPT (hidden 32, 2
heads of 16, vocabulary 64, S 32, plain attention), 3 AdamW steps of 4
x 32 tokens under loss masks that count unequally across the sequence
chunks and the rows (padding at the end of rows, as in long-context
batches).  Tolerances are ``tests/test_torch_mesh_train.py``'s: losses
within rtol 1e-5, atol 1e-6; parameters within rtol 1e-5, atol LR / 20.

At sep 2 every route of the port is held to the one JAX run (the JAX
package computes the same values whatever the flags: GSPMD): the ring
(``context_parallel``, with and without ``sequence_parallel``), the
sequence all-gather (``sequence_parallel`` alone) and sep with neither
flag; RoPE has a JAX run of its own.  dp 2 alone and dp 2 x sep 2 hold
the masked loss to the global masked mean JAX computes
(``ROADMAP.md`` C: the per-rank mean the port took before).
"""

import numpy as np
import pytest
import torch

import _torch_mesh_workers as W

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=32, use_flash_attention=False)
LR = 1e-3
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = LR / 20
STEPS, B, S = 3, 4, 32
#: the port's routes at sep 2, by their flags
RUNS = {"cp_sp": dict(context_parallel=True, sequence_parallel=True),
        "cp_rope": dict(context_parallel=True, use_rope=True),
        "sp": dict(sequence_parallel=True),
        "neither": {}}


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


@pytest.fixture
def cpu_device():
    import paddle_tpu_torch
    from paddle_tpu_torch import device as tdevice
    prev = tdevice._CURRENT[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _state(**over):
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    jp.seed(0)
    m = GPTForCausalLM(GPTConfig(**{**CFG, **over}))
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _masks(rng):
    """Ones, then the tail of each row padded away by a length that
    differs by row and by step: the chunks of a row count unequally, and
    so do the rows."""
    m = np.ones((STEPS, B, S), np.float32)
    for i in range(STEPS):
        for b, pad in enumerate(rng.integers(0, S - 4, B)):
            m[i, b, S - pad:] = 0.0
    m[0, 2, 12:] = 0.0           # a row whose second chunk counts nothing
    return m


def _payload():
    rng = np.random.default_rng(11)
    return {"cfg": CFG, "lr": LR, "runs": RUNS,
            "ids": rng.integers(0, 64, (STEPS, B, S)).astype(np.int64),
            "labels": rng.integers(0, 64, (STEPS, B, S)).astype(np.int64),
            "masks": _masks(rng), "state": _state(),
            "rope_state": _state(use_rope=True),
            "moe_state": _state(num_experts=4)}


def _jax_train(pl, degrees, **over):
    import jax
    import paddle_tpu as jp
    import paddle_tpu.jit as pjit
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.models import (GPTConfig, GPTForCausalLM,
                                   GPTPretrainingCriterion)
    n = int(np.prod(list(degrees.values())))
    mesh = jenv.build_mesh(degrees, devices=np.asarray(jax.devices()[:n]))
    try:
        m = GPTForCausalLM(GPTConfig(**{**CFG, **over}))
        state = pl["rope_state"] if over.get("use_rope") else pl["state"]
        m.set_state_dict({k: jp.to_tensor(v) for k, v in state.items()})
        crit = GPTPretrainingCriterion()
        opt = jp.optimizer.AdamW(LR, parameters=m.parameters())
        step = pjit.CompiledTrainStep(
            m, lambda m, x, y, w: crit(m(x), y, w), opt, mesh=mesh)
        losses = [float(step(*(jp.to_tensor(t[i]) for t in (
            pl["ids"], pl["labels"], pl["masks"]))).numpy())
            for i in range(STEPS)]
        step.sync()
        return losses, {k: np.asarray(v.numpy())
                        for k, v in m.state_dict().items()}
    finally:
        jenv.reset_parallel_env()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    pl = _payload()
    tmp = tmp_path_factory.mktemp("cp")
    two = W.spawn("cp_sep2", 2, tmp, pl)
    four = W.spawn("cp_dp2sep2", 4, tmp, pl)
    cp = dict(context_parallel=True, sequence_parallel=True)
    jax_out = {"sep2": _jax_train(pl, {"sep": 2}, **cp),
               "sep2_rope": _jax_train(pl, {"sep": 2}, context_parallel=True,
                                       use_rope=True),
               "dp2": _jax_train(pl, {"dp": 2}),
               "dp2sep2": _jax_train(pl, {"dp": 2, "sep": 2}, **cp)}
    return pl, jax_out, two.results(), four.results()


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=what)


def _check(run, jax_run):
    (losses, state, _), (jl, js) = run, jax_run
    _close(losses, jl, "losses")
    for k, v in js.items():
        _close(state[k], v, k, PARAM_ATOL)


@pytest.mark.parametrize("route", list(RUNS))
def test_sep2_routes_match_jax_mesh_step(trained, route):
    """3 masked AdamW steps at sep 2: losses and every gathered
    parameter against the JAX step.  The ring shifts K/V twice a layer a
    step (once forward, once back) and all-gathers nothing; the
    all-gather route shifts nothing."""
    _, j, res2, _ = trained
    want = j["sep2_rope" if route == "cp_rope" else "sep2"]
    for out in res2:
        _check(out[route], want)
        moved = out[route][2]
        assert moved.get("dist.collective_launches", 0) > 0
        ring = RUNS[route].get("context_parallel", False)
        assert moved.get("dist.ring_shifts", 0) == (
            2 * CFG["num_layers"] if ring else 0)
        assert (moved.get("dist.sep_collectives", 0) > 0) == (not ring)


def test_dp2_masked_loss_is_the_global_mean(trained):
    """dp 2 with rows whose masks count unequally: the global masked
    mean, the JAX step's (the mean of the ranks' own masked means is
    not: the fault ``ROADMAP.md`` C logs)."""
    pl, j, res2, _ = trained
    for out in res2:
        _check(out["dp2"], j["dp2"])
    m = pl["masks"][0]
    halves = [m[:2].sum(), m[2:].sum()]
    assert halves[0] != halves[1]


def test_dp2_sep2_matches_jax_mesh_step(trained):
    """dp 2 x sep 2 in one world of four: rows over dp, chunks over sep,
    masks unequal across both."""
    _, j, _, res4 = trained
    for out in res4:
        _check(out["train"], j["dp2sep2"])


def test_sep_ranks_draw_different_dropout_masks(trained):
    """Under the sep split each rank draws only its chunk's keep masks,
    from a generator of its own seeded by the chunk index: the masks are
    chunk-sized, the two ranks' seeds and masks differ, and each rank's
    masks are that generator's draws."""
    pl, _, res2, _ = trained
    m0, m1 = (r["masks"] for r in res2)
    assert len(m0) == len(m1) == 2 * CFG["num_layers"]
    assert all(m.shape == (B, S // 2, CFG["hidden_size"]) for m in m0 + m1)
    assert res2[0]["mask_seed"] != res2[1]["mask_seed"]
    assert all(not np.array_equal(a, b) for a, b in zip(m0, m1))
    for r in res2:
        for a, b in zip(r["masks"], r["masks_redrawn"]):
            np.testing.assert_array_equal(a, b)


def test_models_that_do_not_handle_the_split_refuse_a_sep_mesh(trained):
    """The mesh step on a sep mesh refuses a model that does not say it
    handles the sequence split (a BERT, a plain linear layer): it would
    attend within its chunk and restart its positions at 0.  The error
    names ``ROADMAP.md`` A7c-models."""
    _, _, res2, _ = trained
    for out in res2:
        for name, err in out["refused"].items():
            assert err is not None, name
            assert err.startswith("NotImplementedError"), err
            assert "A7c-models" in err, err


def test_moe_and_mesh_serving_under_sep_refused(trained):
    """MoE's global-batch routing over dp x sep tokens is not ported (the
    ``ROADMAP.md`` item A7c-moe) and serving over a sep mesh is not
    (the same item): each raises, naming it."""
    _, _, res2, _ = trained
    for out in res2:
        assert out["moe"].startswith("NotImplementedError")
        assert "A7c-moe" in out["moe"]
        assert out["serve_mesh"].startswith("NotImplementedError")
        assert "A7c-moe" in out["serve_mesh"]


@pytest.mark.parametrize("flag", ["context_parallel", "sequence_parallel"])
def test_flagged_model_serves_greedy_tokens_as_jax(cpu_device, flag):
    """A model built with either flag serves as the JAX model does (its
    serving entry points never read them): greedy ``generate`` tokens
    equal to JAX's on the same weights."""
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig as JConfig
    from paddle_tpu.models import GPTForCausalLM as JGPT
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    jp.seed(0)
    jm = JGPT(JConfig(**CFG, **{flag: True}))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG, **{flag: True}), device="cpu")
    tm.load_numpy_state({k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    tm.eval()
    ids = np.random.default_rng(2).integers(0, 64, (2, 6)).astype(np.int32)
    want = np.asarray(jm.generate(jp.to_tensor(ids),
                                  max_new_tokens=6).numpy())
    got = tm.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sep_specs_validate_and_the_batch_spec_names_sep(trained):
    """``P(..., "sep", ...)`` validates on a mesh with a ``sep`` axis, and
    the mesh step cuts a batch by the JAX step's batch spec ``P(dp,
    sep)``: at dp 2 x sep 2 each rank holds its dp rows of its sep chunk
    (dimensions 1 and 2 of a window's stacked batch), leaves a scalar
    argument alone, and refuses a sequence that does not divide."""
    from paddle_tpu_torch.distributed.sharding_utils import P, validate_spec
    mesh = {"pp": 1, "dp": 2, "sharding": 1, "sep": 2, "mp": 1}
    assert validate_spec(P("dp", "sep"), (4, 32), mesh) == P("dp", "sep")
    with pytest.warns(RuntimeWarning, match="not divisible"):
        assert validate_spec(P(None, "sep"), (4, 31), mesh) == P()
    _, _, _, res4 = trained
    batch = np.arange(4 * 32).reshape(4, 32)
    window = np.arange(2 * 4 * 32).reshape(2, 4, 32)
    seen = set()
    for out in res4:
        d, r = out["index"]
        seen.add((d, r))
        rows, chunk = slice(2 * d, 2 * d + 2), slice(16 * r, 16 * r + 16)
        np.testing.assert_array_equal(out["rows"], batch[rows, chunk])
        np.testing.assert_array_equal(out["window_rows"],
                                      window[:, rows, chunk])
        assert out["odd_sequence"].startswith("ValueError"), out
        assert "sep=2" in out["odd_sequence"]
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}
