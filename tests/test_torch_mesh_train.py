"""Mesh-native training of the port (``CompiledTrainStep(mesh=...,
shard_rules=..., batch_axes=...)``, the tensor-parallel GPT, the sharded
prefetchers) against the JAX package's (``tests/test_train_step_sharded.py``).

Two spawns of gloo ranks (``tests/_torch_mesh_workers.py``:
``train_2ranks``, dp2 and then mp2 over two ranks, and ``train_dp2mp2``
over four) start together; meanwhile the JAX mesh steps run here on the 8-device
virtual mesh, from the same fp32 GPT weights (2 layers, hidden 64, 4
heads, vocabulary 128, 4 AdamW steps of 4 x 16 tokens, plain
attention).  Tolerances: losses within rtol 1e-5, atol 1e-6 of the
JAX mesh step's, the JAX tests' own (``tests/test_train_step_sharded.py
:75-99``): the port sums the data shards' gradients and the
row-parallel partial products in another order.  Gathered parameters
within rtol 1e-5 and atol ``LR / 20`` (5e-6): a wider atol than the JAX
tests', because without any mesh the port's step and the JAX step
already differ by 1.09e-6 on ``qkv_b`` (zero-initialized biases whose
gradient sits near fp32 noise, where AdamW's ``m / sqrt(v)`` turns an
ulp of the gradient into up to ``lr`` of the update).  The port's mesh
of one rank runs here over a one-rank gloo group and must give the
meshless step's numbers bit for bit.
"""

import datetime

import numpy as np
import pytest
import torch

import _torch_mesh_workers as W

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=16, use_flash_attention=False)
LR = 1e-4
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = LR / 20
STEPS, B, S = 4, 4, 16



@pytest.fixture(autouse=True, scope="module")
def _clear_jax_registries():
    """The JAX engines and steps here fill the JAX package's global
    registries (histograms, flight, traces, device time): cleared after
    the module, so later tests in this process start from nothing."""
    yield
    from paddle_tpu.profiler import devicetime, flight, metrics, trace
    metrics.reset_metrics()
    flight.clear()
    trace.clear()
    devicetime.reset()

def _payload():
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    jp.seed(0)
    m = GPTForCausalLM(GPTConfig(**CFG))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, (STEPS, B, S)).astype(np.int64)
    labels = rng.integers(0, 128, (STEPS, B, S)).astype(np.int64)
    weights = np.ones((STEPS, B), np.float32)
    weights[2, 3] = np.inf            # rank 1's rows at dp2: step 2 skips
    return {"cfg": CFG, "lr": LR, "ids": ids, "labels": labels,
            "weights": weights,
            "ids5": rng.integers(0, 128, (1, 5, S)).astype(np.int64),
            "labels5": rng.integers(0, 128, (1, 5, S)).astype(np.int64),
            "x": rng.standard_normal((16, 8)).astype(np.float32),
            "y": rng.standard_normal((16, 4)).astype(np.float32),
            "state": {k: np.asarray(v.numpy())
                      for k, v in m.state_dict().items()}}


def _jax_train(pl, mesh=None):
    import paddle_tpu as jp
    import paddle_tpu.jit as pjit
    from paddle_tpu.models import (GPTConfig, GPTForCausalLM,
                                   GPTPretrainingCriterion)
    m = GPTForCausalLM(GPTConfig(**CFG))
    m.set_state_dict({k: jp.to_tensor(v) for k, v in pl["state"].items()})
    crit = GPTPretrainingCriterion()
    opt = jp.optimizer.AdamW(LR, parameters=m.parameters())

    step = pjit.CompiledTrainStep(m, lambda m, x, lab: crit(m(x), lab),
                                  opt, mesh=mesh)
    losses = [float(step(jp.to_tensor(x), jp.to_tensor(lab)).numpy())
              for x, lab in zip(pl["ids"], pl["labels"])]
    step.sync()
    return losses, {k: np.asarray(v.numpy())
                    for k, v in m.state_dict().items()}


def _jmesh(dp, mp):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp),
                ("dp", "mp"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    pl = _payload()
    tmp = tmp_path_factory.mktemp("train")
    two = W.spawn("train_2ranks", 2, tmp, pl)
    four = W.spawn("train_dp2mp2", 4, tmp, pl)
    jax_out = {"dp2": _jax_train(pl, _jmesh(2, 1)),
               "mp2": _jax_train(pl, _jmesh(1, 2)),
               "dp2mp2": _jax_train(pl, _jmesh(2, 2))}
    res2 = two.results()
    return pl, jax_out, {"dp2": [r["dp2"] for r in res2],
                         "mp2": [r["mp2"] for r in res2],
                         "dp2mp2": four.results()}


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("mesh", ["dp2", "mp2", "dp2mp2"])
def test_losses_and_params_match_jax_mesh_step(trained, mesh):
    """``test_dp2_matches_single_device`` / ``test_dp2_gradient_sync_
    parity`` / ``test_gpt_placements_auto_pickup``: 4 steps, losses and
    every gathered parameter against the JAX step on the same mesh."""
    _, j, res = trained
    jl, js = j[mesh]
    for out in res[mesh]:
        _close(out["losses"], jl, "losses")
        for k, v in js.items():
            _close(out["state"][k], v, k, PARAM_ATOL)


def test_rules_shard_params_and_optimizer_state(trained):
    """A rule splits ``wpe`` (held whole by the model) over mp: its Adam
    moment holds this rank's half; the ``sharding`` axis splits every
    such parameter's state (``ln1_w [2, 64]`` -> ``[1, 64]``) and
    reduce-scatters its gradient.  The trajectory is the JAX dp2 x mp2
    step's either way."""
    _, j, res = trained
    jl, js = j["dp2mp2"]
    for out in res["dp2mp2"]:
        assert out["rules_moment_shape"] == (16, 32)
        assert out["sharding_moment_shape"] == (1, 64)
        for pre in ("rules", "sharding"):
            _close(out[f"{pre}_losses"], jl, pre)
            for k, v in js.items():
                _close(out[f"{pre}_state"][k], v, f"{pre}:{k}", PARAM_ATOL)


def test_indivisible_batch_degrades_to_replicated(trained):
    """5 rows over dp2: the batch stays whole on both ranks and the loss
    is the meshless step's (the JAX test compares its mesh step with its
    own single-device step the same way)."""
    _, _, res = trained
    for out in res["dp2"]:
        mesh_loss, plain_loss = out["indiv_losses"]
        _close(mesh_loss, plain_loss, "5 rows over dp2")


def test_gradscaler_on_mesh_skips_same_steps(trained):
    """An inf loss weight in rank 1's rows: the overflow flag is the
    maximum over the ranks, so both skip step 2, as the meshless step
    does; the scale halves once."""
    _, _, res = trained
    for out in res["dp2"]:
        (got, s_mesh), (want, s_plain) = out["scaler"]
        assert [np.isfinite(v) for v in got] == [np.isfinite(v)
                                                 for v in want]
        assert [np.isfinite(v) for v in got] == [True, True, False, True]
        _close([v for v in got if np.isfinite(v)],
               [v for v in want if np.isfinite(v)], "finite losses")
        assert s_mesh == s_plain == 2.0 ** 9


@pytest.mark.parametrize("mesh", ["dp2", "mp2", "dp2mp2"])
def test_steady_state_counters_on_mesh(trained, mesh):
    """One host dispatch a call, no sync, and the collectives issued by
    the host (the JAX step keeps ``dist.collective_launches`` at 0: GSPMD
    compiles them in)."""
    _, _, res = trained
    for out in res[mesh]:
        d = out["steady"]
        assert d["jit.host.dispatches"] == d["jit.steps"] == 2
        assert d["jit.syncs"] == 0
        assert d["dist.collective_launches"] > 0


def _jax_loader(pl, b):
    import paddle_tpu as jp
    from paddle_tpu.io import DataLoader, TensorDataset
    ds = TensorDataset([jp.to_tensor(pl["x"]), jp.to_tensor(pl["y"])])
    return DataLoader(ds, batch_size=b, shuffle=False)


def test_device_prefetcher_sharded_values_identical(trained):
    """Each rank's staged leaves are its rows of the JAX sharded
    prefetcher's batches, bit for bit; a 3-row batch stays whole."""
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from paddle_tpu.io import DevicePrefetcher
    pl, _, res = trained
    sh = NamedSharding(_jmesh(2, 1), JP("dp"))
    want = [[np.asarray(t.numpy()) for t in b]
            for b in DevicePrefetcher(_jax_loader(pl, 4), sharding=sh)]
    whole = [[np.asarray(t.numpy()) for t in b]
             for b in DevicePrefetcher(_jax_loader(pl, 3), sharding=sh)]
    for r, out in enumerate(res["dp2"]):
        assert out["pref_local_rows"]
        assert len(out["pref"]) == len(want)
        for got_b, want_b in zip(out["pref"], want):
            for g, w in zip(got_b, want_b):
                np.testing.assert_array_equal(g, w[2 * r:2 * r + 2])
        for got_b, want_b in zip(out["pref_indiv"], whole):
            for g, w in zip(got_b, want_b):
                np.testing.assert_array_equal(g, w)


def test_stacking_prefetcher_sharded_window(trained):
    """A window holds ``[k, rows of this rank, ...]``: the JAX window's
    ``P(None, "dp")`` layout, cut; and such windows train as the step's
    own split of the whole batches does, loss for loss."""
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from paddle_tpu.io import StackingPrefetcher
    pl, _, res = trained
    want = [[np.asarray(t.numpy()) for t in w] for w in StackingPrefetcher(
        _jax_loader(pl, 4), k=2,
        sharding=NamedSharding(_jmesh(2, 1), JP("dp")))]
    for r, out in enumerate(res["dp2"]):
        assert len(out["stack"]) == len(want) == 2
        for got_w, want_w in zip(out["stack"], want):
            for g, w in zip(got_w, want_w):
                assert g.shape[:2] == (2, 2)
                np.testing.assert_array_equal(g, w[:, 2 * r:2 * r + 2])
        assert out["window_losses"] == out["losses"]


def test_distributed_batch_sampler_reads_the_group(trained):
    from paddle_tpu.io import DistributedBatchSampler
    _, _, res = trained
    for r, out in enumerate(res["dp2"]):
        want = DistributedBatchSampler(list(range(10)), 2, num_replicas=2,
                                       rank=r)
        assert out["sampler"] == (2, r, list(want))


def test_load_and_gather_numpy_state_roundtrip(trained):
    """``load_numpy_state`` keeps each rank's shard of the JAX arrays (the
    ``[q | k | v]`` columns of its heads) and ``gather_numpy_state``
    rebuilds the JAX layout bit for bit."""
    pl, _, res = trained
    st = pl["state"]
    for r, out in enumerate(res["mp2"]):
        assert out["shapes"]["qkv_w"] == (2, 64, 96)
        assert out["shapes"]["wte"] == (64, 64)
        assert out["shapes"]["proj_w"] == (2, 32, 64)
        assert out["shapes"]["ln1_w"] == (2, 64)
        q = st["qkv_w"].reshape(2, 64, 3, 64)[..., 32 * r:32 * (r + 1)]
        np.testing.assert_array_equal(out["qkv_w_local"],
                                      q.reshape(2, 64, 96))
        for k, v in st.items():
            np.testing.assert_array_equal(out["roundtrip"][k], v, err_msg=k)


@pytest.fixture
def one_rank_group():
    from paddle_tpu_torch import distributed as D
    D.init_parallel_env(backend="gloo", rank=0, world_size=1,
                        store=torch.distributed.HashStore(),
                        timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        D.reset_parallel_env()


@pytest.mark.parametrize("fused", [1, 2])
def test_mesh11_bit_identical_to_single_device(one_rank_group, fused):
    """dp1 x mp1: the tensor-parallel GPT and the mesh step (their
    collectives over groups of one) give the meshless step's losses and
    parameters bit for bit, single steps and fused windows alike."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.io import Window
    pl = _payload()
    outs = []
    for mesh in (None, {"dp": 1, "mp": 1}):
        D.set_mesh(None if mesh is None else D.build_mesh(mesh))
        _, _, step, model, _ = W._train(pl, D.get_mesh(), steps=0,
                                        fused=fused)
        ids, lab = (torch.from_numpy(pl[k]) for k in ("ids", "labels"))
        if fused == 1:
            losses = [float(step(ids[i], lab[i])) for i in range(STEPS)]
        else:
            losses = [float(x) for i in (0, 2)
                      for x in step(Window((ids[i:i + 2], lab[i:i + 2]), 2))]
        outs.append((losses, model.gather_numpy_state()))
    (l0, s0), (l1, s1) = outs
    assert l0 == l1
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
