"""The port's auto-parallel API (``paddle_tpu_torch.distributed.
auto_parallel``) and the collectives of ``compat`` against the JAX
package's.

The placement-to-spec rules and ``ProcessMesh`` run here in both
packages.  One spawn of two gloo ranks (``tests/_torch_mesh_workers.py``
``auto_parallel_2ranks``) runs ``shard_tensor``/``reshard`` over the four
moves (Shard -> Replicate, Replicate -> Shard, Shard(0) -> Shard(1),
Partial -> Replicate), ``unshard_dtensor``, ``dtensor_to_local``, the
object and tensor collectives, and ``to_static`` training the 2-layer
GPT placed by a tensor-parallel ``shard_fn`` over mp2; meanwhile the
JAX package does the same on two devices of its 8-device virtual mesh.

Tolerances: the moves are copies and sums of two fp32 values, held
exactly.  Training: losses within rtol 1e-5, atol 1e-6 of the JAX
step's, gathered parameters within rtol 1e-5 and atol ``LR / 20``, the
bounds of ``tests/test_torch_mesh_train.py`` (why there: its
docstring).  The port keeps a placed parameter whole and splits its
optimizer state by the placement, so the qkv moment holds half the
columns.
"""

import itertools

import numpy as np
import pytest

import _torch_mesh_workers as W

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=16, use_flash_attention=False)
LR = 1e-4
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = LR / 20
STEPS, B, S = 4, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_registries():
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
    rng = np.random.default_rng(4)
    return {"cfg": CFG, "lr": LR,
            "x": rng.standard_normal((8, 12)).astype(np.float32),
            "ids": rng.integers(0, 128, (STEPS, B, S)).astype(np.int64),
            "labels": rng.integers(0, 128, (STEPS, B, S)).astype(np.int64),
            "state": {k: np.asarray(v.numpy())
                      for k, v in m.state_dict().items()}}


def _jax_mp2():
    import jax
    from paddle_tpu.distributed import env as jenv
    return jenv.build_mesh({"mp": 2}, devices=np.asarray(jax.devices()[:2]))


def _jax_side(pl):
    """The JAX package's moves and ``to_static`` run on its mp2 mesh."""
    import paddle_tpu as jp
    from paddle_tpu.distributed import auto_parallel as jap
    from paddle_tpu.distributed import compat as jcompat
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.models import (GPTConfig, GPTForCausalLM,
                                   GPTPretrainingCriterion)
    out = {}
    try:
        _jax_mp2()
        mesh = jap.ProcessMesh([0, 1], ["mp"])
        for name, (src, dst) in {
                "s0_r": ([jap.Shard(0)], [jap.Replicate()]),
                "r_s1": ([jap.Replicate()], [jap.Shard(1)]),
                "s0_s1": ([jap.Shard(0)], [jap.Shard(1)])}.items():
            a = jap.shard_tensor(pl["x"], mesh, src)
            b = jap.reshard(a, mesh, dst)
            out[name] = {"to_local": np.asarray(
                jap.dtensor_to_local(b).numpy()),
                "unshard": np.asarray(jcompat.unshard_dtensor(b).numpy()),
                "spec": tuple(b.placements)}
        m = GPTForCausalLM(GPTConfig(**CFG))
        m.set_state_dict({k: jp.to_tensor(v)
                          for k, v in pl["state"].items()})
        jap.shard_layer(m, mesh, W.gpt_shard_fn(jap))
        opt = jap.shard_optimizer(jp.optimizer.AdamW(
            LR, parameters=m.parameters()))
        step = jap.to_static(m, loss=GPTPretrainingCriterion(),
                             optimizer=opt)
        out["losses"] = [float(step(jp.to_tensor(x),
                                    jp.to_tensor(y)).numpy())
                         for x, y in zip(pl["ids"], pl["labels"])]
        out["state"] = {k: np.asarray(v.numpy())
                        for k, v in m.state_dict().items()}
        out["step_type"] = type(step).__name__
    finally:
        jenv.reset_parallel_env()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pl = _payload()
    spawned = W.spawn("auto_parallel_2ranks", 2,
                      tmp_path_factory.mktemp("ap"), pl)
    jax_out = _jax_side(pl)
    return pl, jax_out, spawned.results()


def _placement_lists(jap_or_ap, n_axes):
    kinds = [jap_or_ap.Replicate(), jap_or_ap.Shard(0), jap_or_ap.Shard(1),
             jap_or_ap.Partial()]
    return list(itertools.product(kinds, repeat=n_axes))


@pytest.mark.parametrize("names", [["mp"], ["dp", "mp"]])
def test_placement_specs_match_jax(names):
    """``_placements_to_spec``/``_spec_with_names`` agree with JAX's for
    every placement list of Replicate, Shard(0), Shard(1) and Partial on
    a 1-D and a 2-D mesh."""
    from paddle_tpu.distributed import auto_parallel as jap
    from paddle_tpu_torch.distributed import auto_parallel as ap
    shape = [2] * len(names)
    jm = jap.ProcessMesh(np.arange(2 ** len(names)).reshape(shape), names)
    pm = ap.ProcessMesh(np.arange(2 ** len(names)).reshape(shape), names)
    for jp_list, p_list in zip(_placement_lists(jap, len(names)),
                               _placement_lists(ap, len(names))):
        assert ap._placements_to_spec(p_list, 3) == \
            jap._placements_to_spec(jp_list, 3), p_list
        assert tuple(ap._spec_with_names(p_list, pm, 3)) == \
            tuple(jap._spec_with_names(jp_list, jm, 3)), p_list


def test_process_mesh_matches_jax():
    from paddle_tpu.distributed import auto_parallel as jap
    from paddle_tpu_torch.distributed import auto_parallel as ap
    arr = np.arange(6).reshape(2, 3)
    j, p = jap.ProcessMesh(arr, ["dp", "mp"]), ap.ProcessMesh(arr,
                                                             ["dp", "mp"])
    for attr in ("shape", "process_ids", "dim_names", "ndim"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert p.get_dim_size("mp") == j.get_dim_size("mp") == 3
    assert repr(p) == repr(j)
    assert p == ap.ProcessMesh(arr, ["dp", "mp"])
    assert p != ap.ProcessMesh(arr.T, ["mp", "dp"])
    for kw in ({}, {"index": 1}):
        jm, pm = (m.get_mesh_with_dim("mp", **kw) for m in (j, p))
        assert (pm.shape, pm.process_ids, pm.dim_names) == \
            (jm.shape, jm.process_ids, jm.dim_names), kw
    # the port's mesh axes only, in the mesh's order
    with pytest.raises(ValueError, match="axes"):
        ap.ProcessMesh([0, 1], ["x"]).to_mesh()
    with pytest.raises(ValueError, match="order"):
        ap.ProcessMesh(arr, ["mp", "dp"]).to_mesh()


@pytest.mark.parametrize("move", ["s0_r", "r_s1", "s0_s1"])
def test_reshard_moves_match_jax(ranks, move):
    """Each rank holds its chunk of JAX's global value; unsharded, both
    ranks hold JAX's unsharded value; the specs agree."""
    pl, jx, res = ranks
    dst_dim = {"s0_r": None, "r_s1": 1, "s0_s1": 1}[move]
    src_dim = {"s0_r": 0, "r_s1": None, "s0_s1": 0}[move]
    for r, out in enumerate(res):
        got = out["moves"][move]
        np.testing.assert_array_equal(got["whole"], jx[move]["unshard"])
        want_src = (pl["x"] if src_dim is None
                    else np.split(pl["x"], 2, src_dim)[r])
        np.testing.assert_array_equal(got["src_local"], want_src)
        want = (jx[move]["unshard"] if dst_dim is None
                else np.split(jx[move]["unshard"], 2, dst_dim)[r])
        np.testing.assert_array_equal(got["dst_local"], want)
        assert got["spec"] == jx[move]["spec"]


@pytest.mark.parametrize("move", ["s0_r", "r_s1", "s0_s1"])
def test_dtensor_to_local_is_the_local_piece(ranks, move):
    """The port's ``dtensor_to_local`` is this rank's piece (the
    reference's); JAX's returns the global array (ROADMAP.md C): the two
    ranks' pieces, put together, are JAX's value."""
    _, jx, res = ranks
    dst_dim = {"s0_r": None, "r_s1": 1, "s0_s1": 1}[move]
    pieces = [out["moves"][move]["dst_local"] for out in res]
    whole = pieces[0] if dst_dim is None else np.concatenate(pieces,
                                                             dst_dim)
    np.testing.assert_array_equal(whole, jx[move]["to_local"])
    if dst_dim is not None:
        assert pieces[0].shape != jx[move]["to_local"].shape


def test_partial_to_replicate_all_reduces(ranks):
    """Partial -> Replicate sums the ranks' summands (numpy: x + 2x);
    a Partial made from a whole tensor keeps it on rank 0, zeros on
    rank 1, so its whole value is the tensor."""
    pl, _, res = ranks
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["moves"]["p_r"]["dst_local"],
                                      pl["x"] * 3)
        pw = out["moves"]["p_from_whole"]
        np.testing.assert_array_equal(
            pw["local"], pl["x"] if r == 0 else np.zeros_like(pl["x"]))
        np.testing.assert_array_equal(pw["whole"], pl["x"])


def test_compat_collectives(ranks):
    """``alltoall``, ``alltoall_single``, ``gather`` and the object lists
    against what their definitions give (numpy)."""
    _, _, res = ranks
    for r, out in enumerate(res):
        c = out["compat"]
        for i in range(2):
            np.testing.assert_array_equal(c["alltoall"][i],
                                          np.full(2, 10.0 * i + r))
        np.testing.assert_array_equal(
            c["alltoall_single"],
            np.concatenate([np.arange(4.0)[2 * r:2 * r + 2] + 10 * q
                            for q in range(2)]))
        if r == 1:
            assert [g.tolist() for g in c["gather"]] == [[0.0] * 3,
                                                         [1.0] * 3]
        else:
            assert c["gather"] is None
        assert c["broadcast_object_list"] == [{"rank": 1}, "from 1"]
        assert c["scatter_object_list"] == [f"to {r}"]


def test_to_static_trains_like_jax(ranks):
    """``shard_layer`` + ``to_static(loss=, optimizer=)`` over mp2:
    losses and the gathered parameters equal the JAX package's
    ``DistributedTrainStep`` within the stated bounds; the port's step
    is its ``DistributedTrainStep``, the parameters keep their
    placements, the optimizer state holds this rank's columns."""
    _, jx, res = ranks
    assert jx["step_type"] == "DistributedTrainStep"
    for out in res:
        t = out["train"]
        assert t["step_type"] == "DistributedTrainStep"
        np.testing.assert_allclose(t["losses"], jx["losses"], rtol=RTOL,
                                   atol=ATOL)
        for k, want in jx["state"].items():
            np.testing.assert_allclose(t["state"][k], want, rtol=RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
        assert t["placements"]["qkv_w"] == (None, None, "mp")
        assert t["placements"]["wpe"] == (None, None)
        H = CFG["hidden_size"]
        assert t["qkv_w_moment"] == (CFG["num_layers"], H, 3 * H // 2)
