"""The port's distributed API (``paddle_tpu_torch.distributed``) against
the JAX package's.

One spawn of four gloo ranks (``tests/_torch_mesh_workers.py``
``api_dp2mp2``: ``fleet.init`` with dp 2 x mp 2) runs the environment,
the mesh, the eager collectives, ``mp_ops``, the tensor-parallel layers,
the RNG tracker, ``DataParallel`` and the hybrid optimizer; each check
below reads its part of the ranks' results.  The JAX side runs here, in
the pytest process, on the 8-device virtual mesh: its layers give the
numbers the port's mp-split layers must reproduce (fp32, 1e-6 of the
values' scale: the same products, the vocabulary or columns summed in
another order), its ``CommunicateTopology`` the ranks, its
``infer_partition_specs``/``validate_spec`` the specs.  The collectives
are held to what their definitions give in numpy (the JAX versions act
on one process's stacked arrays, so there is no rank-by-rank JAX value
to compare).
"""

import warnings

import numpy as np
import pytest

import _torch_mesh_workers as W

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6


def _jax_layers():
    import paddle_tpu as jp
    from paddle_tpu.distributed import fleet as jfleet
    rng = np.random.default_rng(5)
    out = {}
    jp.seed(3)
    for name, layer, x in (
            ("col", jfleet.ColumnParallelLinear(8, 16, has_bias=True,
                                                gather_output=True),
             rng.standard_normal((2, 3, 8)).astype(np.float32)),
            ("row", jfleet.RowParallelLinear(16, 8, has_bias=True),
             rng.standard_normal((2, 3, 16)).astype(np.float32)),
            ("emb", jfleet.VocabParallelEmbedding(32, 8),
             rng.integers(0, 32, (2, 3)).astype(np.int64))):
        params = {n: np.asarray(p.numpy()) for n, p in
                  layer.named_parameters()}
        if name == "col":
            # a nonzero bias, so the test sees where it is added
            params["bias"] = rng.standard_normal(16).astype(np.float32)
            layer.bias.set_value(params["bias"])
        xin = jp.to_tensor(x)
        if name != "emb":
            xin.stop_gradient = False
        y = layer(xin)
        ct = rng.standard_normal(tuple(y.shape)).astype(np.float32)
        (y * jp.to_tensor(ct)).sum().backward()
        out[name] = {"params": params, "x": x, "ct": ct,
                     "y": np.asarray(y.numpy()),
                     "grads": {n: np.asarray(p.grad.numpy())
                               for n, p in layer.named_parameters()},
                     "xgrad": (None if name == "emb"
                               else np.asarray(xin.grad.numpy()))}
    logits = rng.standard_normal((2, 3, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 3)).astype(np.int64)
    lg = jp.to_tensor(logits)
    lg.stop_gradient = False
    loss = jfleet.ParallelCrossEntropy()(lg, jp.to_tensor(labels))
    loss.sum().backward()
    out["pce"] = {"logits": logits, "labels": labels,
                  "y": np.asarray(loss.numpy()),
                  "grad": np.asarray(lg.grad.numpy())}
    return out


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    rng = np.random.default_rng(0)
    pl = {"a": rng.standard_normal((3, 8)).astype(np.float32),
          "ct": rng.standard_normal((3, 16)).astype(np.float32),
          "logits": rng.standard_normal((5, 12)).astype(np.float32),
          "labels": rng.integers(0, 12, 5).astype(np.int64),
          "wte": rng.standard_normal((12, 4)).astype(np.float32),
          "ids": rng.integers(0, 12, (2, 3)).astype(np.int64)}
    # the JAX layers' inputs and weights go to the ranks; their numbers
    # are computed here
    jl = _jax_layers()
    pl["layers"] = {k: {kk: vv for kk, vv in v.items()
                        if kk in ("params", "x", "ct", "logits", "labels")}
                    for k, v in jl.items()}
    res = W.spawn("api_dp2mp2", WORLD, tmp_path_factory.mktemp("api"),
                  pl).results()
    return pl, jl, res


def _x(rank):
    return np.arange(4, dtype=np.float32) + 10 * rank


def test_env_and_mesh_degrees(api):
    from paddle_tpu.distributed import env as jenv
    import jax
    _, _, res = api
    try:
        jenv.build_mesh({"dp": 2, "mp": -1}, devices=np.asarray(
            jax.devices()[:WORLD]))
        want = jenv.hybrid_degrees()
    finally:
        jenv.reset_parallel_env()
    for r, out in enumerate(res):
        assert out["env"] == (r, WORLD, r, WORLD, True)
        assert out["degrees"] == want
        assert out["coord"] == {"pp": 0, "dp": r // 2, "sharding": 0,
                                "sep": 0, "mp": r % 2}
        assert out["data_axes"] == ("dp",)


def test_topology_and_fleet_init_match_jax(api):
    from paddle_tpu.distributed.fleet.topology import CommunicateTopology
    _, _, res = api
    topo = CommunicateTopology(["pp", "dp", "sharding", "sep", "mp"],
                               [1, 2, 1, 1, 2])
    for r, out in enumerate(res):
        assert out["comm_list"] == {a: topo.get_comm_list(a)
                                    for a in ("dp", "mp")}
        coord = topo.get_coord(r)
        dp_ranks = [g for g in topo.get_comm_list("dp") if r in g][0]
        mp_ranks = [g for g in topo.get_comm_list("mp") if r in g][0]
        assert out["hcg"]["dp"] == (2, coord[1], dp_ranks)
        assert out["hcg"]["mp"] == (2, coord[4], mp_ranks)
        assert (out["hcg"]["stage"], out["hcg"]["first"]) == (0, True)
        assert out["hcg"]["workers"] == (WORLD, r, r == 0)


def test_eager_collectives(api):
    _, _, res = api
    xs = [_x(r) for r in range(WORLD)]
    for r, out in enumerate(res):
        c = out["comm"]
        np.testing.assert_array_equal(c["all_reduce"], sum(xs))
        mp = [q for q in range(WORLD) if q // 2 == r // 2]
        np.testing.assert_array_equal(c["all_reduce_max_mp"],
                                      np.maximum(*(xs[q] for q in mp)))
        dp = [q for q in range(WORLD) if q % 2 == r % 2]
        np.testing.assert_array_equal(c["all_reduce_avg_dp"],
                                      sum(xs[q] for q in dp) / 2)
        for got, want in zip(c["all_gather"], xs):
            np.testing.assert_array_equal(got, want)
        assert c["all_gather_object"] == [{"rank": q} for q in range(WORLD)]
        np.testing.assert_array_equal(c["broadcast"], xs[3])
        # reduce: the sum at dst, the others' tensors as they were
        np.testing.assert_array_equal(c["reduce"],
                                      sum(xs) if r == 1 else xs[r])
        chunks = [np.concatenate([x[:2], x[2:], x[:2] * 2, x[2:] * 2])
                  for x in xs]
        np.testing.assert_array_equal(
            c["reduce_scatter"], sum(ch[2 * r:2 * r + 2] for ch in chunks))
        np.testing.assert_array_equal(c["scatter"], np.full(2, float(r)))
        assert [float(v[0]) for v in c["all_to_all"]] == [
            float(10 * q + r) for q in range(WORLD)]
        np.testing.assert_array_equal(c["sendrecv"], xs[r ^ 1])
        np.testing.assert_array_equal(c["batch_p2p"], xs[r ^ 1])
        # every call counted as a host-issued collective
        assert c["launches"] >= 13


def test_mp_ops_forward_and_backward(api):
    pl, _, res = api
    a, ct = pl["a"], pl["ct"]
    for r, out in enumerate(res):
        o = out["mp_ops"]
        np.testing.assert_array_equal(o["gather"],
                                      np.concatenate([a, 2 * a], -1))
        # backward of gather = this rank's slice; of copy = the mp sum
        np.testing.assert_allclose(o["grad"], ct[:, :8] + 2 * ct[:, 8:],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o["reduce"], a[:, :4] + 2 * a[:, 4:],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(
            o["grad2"], np.concatenate([ct[:, :4], 2 * ct[:, :4]], -1))


def test_vocab_parallel_embedding_and_ce_match_jax(api):
    """``vocab_parallel_ce_sum`` and ``vocab_parallel_embedding`` at mp2
    against the JAX ``mp_ops`` under ``shard_map`` over a 2-device
    ``mp`` mesh: the loss and the looked-up rows.  The gradient (each
    rank's vocabulary slice) is held to ``jax.grad`` of the unsharded
    token-sum cross entropy: ``jax.grad`` through a ``shard_map`` with a
    replicated output splits the cotangent between the devices, so the
    sharded JAX gradient is not the reference."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as JP
    from paddle_tpu.distributed import mp_ops as jmp
    pl, _, res = api
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    ce = shard_map(lambda lg, lab: jmp.vocab_parallel_ce_sum(lg, lab, "mp"),
                   mesh=mesh, in_specs=(JP(None, "mp"), JP()),
                   out_specs=JP(), check_rep=False)
    want = ce(pl["logits"], pl["labels"])

    def plain(lg):
        lse = jax.nn.logsumexp(lg, -1)
        return (lse - lg[np.arange(lg.shape[0]), pl["labels"]]).sum()
    grad = jax.grad(plain)(pl["logits"])
    emb = shard_map(lambda i, w: jmp.vocab_parallel_embedding(i, w, "mp"),
                    mesh=mesh, in_specs=(JP(), JP("mp", None)),
                    out_specs=JP(), check_rep=False)(pl["ids"], pl["wte"])
    grad = np.asarray(grad)
    for r, out in enumerate(res):
        got, g = out["ce"]
        assert abs(got - float(want)) <= RTOL * abs(float(want))
        np.testing.assert_allclose(g, grad[:, 6 * (r % 2):6 * (r % 2 + 1)],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(out["emb"], np.asarray(emb))


@pytest.mark.parametrize("name", ["col", "row", "emb", "pce"])
def test_parallel_layers_match_jax(api, name):
    """Column-, row- and vocab-parallel layers and the parallel cross
    entropy at mp2: outputs, input gradients and the gathered weight
    gradients equal the JAX layers' (fp32, 1e-5 relative)."""
    _, jl, res = api
    want = jl[name]
    for out in res:
        got = out["layers"][name]
        np.testing.assert_allclose(got["y"], want["y"], rtol=RTOL,
                                   atol=ATOL)
        if name == "pce":
            np.testing.assert_allclose(got["grad"], want["grad"], rtol=RTOL,
                                       atol=ATOL)
            continue
        for n, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][n], g, rtol=RTOL,
                                       atol=ATOL, err_msg=n)
        if want["xgrad"] is not None:
            np.testing.assert_allclose(got["xgrad"], want["xgrad"],
                                       rtol=RTOL, atol=ATOL)


def test_rng_tracker_streams(api):
    _, _, res = api
    glob = [out["rng"][0] for out in res]
    loc = [out["rng"][1] for out in res]
    for g in glob[1:]:
        np.testing.assert_array_equal(g, glob[0])
    assert not any(np.array_equal(loc[0], l) for l in loc[1:])


def test_data_parallel_and_hybrid_optimizer(api):
    pl, jl, res = api
    # DataParallel: the mean over the world of rank-dependent gradients
    want = np.full((4, 2), 2.0 * np.mean([r + 1 for r in range(WORLD)]))
    for out in res:
        np.testing.assert_allclose(out["dp_grad"], want, rtol=RTOL)
    # hybrid optimizer: the dp mean of the gradient, clipped by the
    # global norm over the mp shards, one SGD step
    col = jl["col"]
    x = col["x"]
    gw = np.mean([x.reshape(-1, 8).sum(0) * (d + 1) for d in (0, 1)], 0)
    gw = np.repeat(gw[:, None], 16, 1)
    gb = np.full(16, x.reshape(-1, 8).shape[0], np.float32)
    norm = np.sqrt((gw ** 2).sum() + (gb ** 2).sum())
    w = col["params"]["weight"] - 0.1 * gw * min(1.0, 0.01 / norm)
    for out in res:
        np.testing.assert_allclose(out["hybrid_weight"], w, rtol=RTOL,
                                   atol=ATOL)


def test_first_matching_rule_wins():
    from jax.sharding import Mesh, PartitionSpec as JP
    import jax
    from paddle_tpu.distributed.sharding_utils import (
        infer_partition_specs as jinfer)
    from paddle_tpu_torch.distributed.sharding_utils import (
        P, infer_partition_specs)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))
    tree = {"enc": {"weight": np.zeros((8, 16))},
            "dec": {"weight": np.zeros((16, 8))}}
    want = jinfer(tree, mesh, [(r"enc/weight", JP("mp", None)),
                               (r"weight", JP(None, "mp"))])
    got = infer_partition_specs(tree, {"dp": 2, "mp": 2},
                                [(r"enc/weight", P("mp", None)),
                                 (r"weight", P(None, "mp"))])
    for k in tree:
        assert tuple(got[k]["weight"]) == tuple(want[k]["weight"])


def test_unmatched_leaves_get_default():
    from jax.sharding import Mesh, PartitionSpec as JP
    import jax
    from paddle_tpu.distributed.sharding_utils import (
        infer_partition_specs as jinfer)
    from paddle_tpu_torch.distributed.sharding_utils import (
        P, infer_partition_specs)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))
    tree = {"w": np.zeros((8, 8)), "b": np.zeros((8,))}
    want = jinfer(tree, mesh, [(r"^w$", JP("dp", None))])
    got = infer_partition_specs(tree, {"dp": 2, "mp": 2},
                                [(r"^w$", P("dp", None))])
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    assert infer_partition_specs(tree, {"dp": 2, "mp": 2},
                                 [(r"^w$", P("dp", None))],
                                 default=None)["b"] is None


@pytest.mark.parametrize("spec,shape,match", [
    (("fsdp", None), (8, 8), "not in"),
    (("dp", None), (7, 8), "not divisible")])
def test_indivisible_dim_falls_back_replicated(spec, shape, match):
    """An unknown axis or an indivisible dimension degrades to
    replicated with a warning, in both packages."""
    from jax.sharding import Mesh, PartitionSpec as JP
    import jax
    from paddle_tpu.distributed.sharding_utils import (
        infer_partition_specs as jinfer)
    from paddle_tpu_torch.distributed.sharding_utils import (
        P, infer_partition_specs, validate_spec)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))
    tree = {"w": np.zeros(shape)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jinfer(tree, mesh, [(r"w", JP(*spec))])
    with pytest.warns(RuntimeWarning, match=match):
        got = infer_partition_specs(tree, {"dp": 2, "mp": 2},
                                    [(r"w", P(*spec))])
    assert tuple(got["w"]) == tuple(want["w"]) == ()
    ticks = []
    assert validate_spec(P(*spec), shape, {"dp": 2, "mp": 2}, quiet=True,
                         on_fallback=ticks.append) == P()
    assert len(ticks) == 1 and match in ticks[0]


def test_nested_paths_and_sequences():
    from jax.sharding import Mesh, PartitionSpec as JP
    import jax
    from paddle_tpu.distributed.sharding_utils import (
        infer_partition_specs as jinfer)
    from paddle_tpu_torch.distributed.sharding_utils import (
        P, infer_partition_specs)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))
    tree = {"layers": [{"weight": np.zeros((4, 8))},
                       {"weight": np.zeros((4, 8))}]}
    want = jinfer(tree, mesh, [(r"layers/1/weight", JP(None, "mp"))])
    got = infer_partition_specs(tree, {"dp": 2, "mp": 2},
                                [(r"layers/1/weight", P(None, "mp"))])
    for i in range(2):
        assert tuple(got["layers"][i]["weight"]) == tuple(
            want["layers"][i]["weight"])


def test_local_shard_and_gather_roundtrip_in_one_process():
    """``local_shard`` over every rank of a spec rebuilds the tensor
    (the fused ``[q | k | v]`` split too), checked without a group."""
    import torch
    from paddle_tpu_torch.distributed.sharding_utils import P, local_shard

    class _M:
        shape = {"dp": 2, "mp": 2}

        def __init__(self, r):
            self.r = r

        def index(self, axes):
            return self.r

    x = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    parts = [local_shard(x, P(None, "mp"), _M(r), fused=3) for r in (0, 1)]
    back = torch.cat([p.reshape(2, 3, 2) for p in parts], -1).reshape(2, 12)
    assert torch.equal(back, x)
    assert torch.equal(parts[0], x[:, [0, 1, 4, 5, 8, 9]])


# -- utils, io, sharding and fleet's parameter-server surface ----------------

def test_utils_timers_and_logger_match_jax():
    """``get_timers``/``TimerHub`` and ``get_logger`` behave as the JAX
    package's: the same timers, the same log line's shape."""
    import logging
    from paddle_tpu.distributed import utils as jutils
    from paddle_tpu_torch.distributed import utils
    for mod in (jutils, utils):
        hub = mod.TimerHub()
        hub("fwd").start()
        hub("fwd").stop()
        assert hub("fwd").elapsed(reset=False) >= 0
        assert hub("fwd").elapsed() >= 0 and hub("fwd").elapsed_ == 0
        assert isinstance(mod.get_timers(), mod.TimerHub)
        assert set(hub.timers) == {"fwd"}
    log = utils.get_logger("WARNING")
    assert log.name == "paddle_tpu_torch.distributed"
    assert log.level == logging.WARNING
    assert utils.get_logger(name="x").name == \
        jutils.get_logger(name="x").name


def test_io_raises_pointing_at_the_checkpoint():
    from paddle_tpu.distributed import io as jio
    from paddle_tpu_torch.distributed import io
    for fn in ("save_persistables", "load_persistables"):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            getattr(jio, fn)()
        with pytest.raises(NotImplementedError,
                           match="save_state_dict|load_state_dict"):
            getattr(io, fn)()

    class V:
        persistable = True
    assert io.is_persistable(V()) == jio.is_persistable(V()) is True
    assert io.is_persistable(object()) is False


def test_group_sharded_annotations_match_jax(api):
    """``sharding.group_sharded_parallel`` at each level records the
    annotations the JAX package's ``apply_fsdp_annotations`` records on
    the same model at sharding 2 x mp 2 (stage 1/2: the optimizer
    state's spec beside a replicated placement; stage 3: the
    placement); ``save_group_sharded_model`` names ROADMAP A10."""
    import jax
    import paddle_tpu as jp
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import sharding as jsharding
    from paddle_tpu_torch.distributed import sharding
    _, _, res = api
    try:
        jenv.build_mesh({"sharding": 2, "mp": 2},
                        devices=np.asarray(jax.devices()[:WORLD]))
        want = {level: W.group_sharded_annotations(
            jp, jsharding.group_sharded_parallel, level)
            for level in ("os", "os_g", "p_g_os")}
    finally:
        jenv.reset_parallel_env()
    for out in res:
        for level, specs in want.items():
            got = out["group_sharded"][level]
            assert set(got) == set(specs)
            for name, (place, opt) in specs.items():
                assert got[name][1] == opt, (level, name)
                assert (got[name][0] or ()) == (place or ()), (level, name)
    with pytest.raises(NotImplementedError, match="A10"):
        sharding.save_group_sharded_model(None, "out")


def test_fleet_util_over_the_world(api):
    """``fleet.UtilBase``: the reduction the mode names over the four
    ranks, and each rank's share of a file list."""
    _, _, res = api
    for r, out in enumerate(res):
        u = out["util"]
        assert u["sum"] == [10.0, -6.0]
        assert u["max"] == [4.0, 0.0]
        assert u["min"] == [1.0, -3.0]
        assert u["shard"] == list("abcdefg")[r::WORLD]


@pytest.mark.parametrize("backend,want", [("nccl", "cuda:1"),
                                           ("gloo", "cpu")])
def test_fleet_util_reduces_on_the_backends_device(monkeypatch, backend,
                                                    want):
    """``UtilBase.all_reduce`` hands NCCL a tensor on this rank's card
    (NCCL refuses host tensors) and gloo one on the host."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert fleet._collective_device() == torch.device(want)


def test_fleet_data_generators_match_jax():
    """The multi-slot text of ``MultiSlotDataGenerator`` equals the JAX
    package's for the same samples."""
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu_torch.distributed import fleet

    def gen(base):
        class G(base):
            def generate_sample(self, line):
                def it():
                    ids = [int(x) for x in line.split()]
                    yield [("click", [ids[0] % 2]), ("ids", ids)]
                    yield [("click", [1]), ("ids", ids[::-1][:2])]
                return it
        return G()

    lines = ["3 1 4 1 5", "9 2 6", "5"]
    for base in ("MultiSlotDataGenerator", "MultiSlotStringDataGenerator"):
        assert gen(getattr(fleet, base)).run_from_memory(lines) == \
            gen(getattr(jfleet, base)).run_from_memory(lines)
    assert fleet.Role.SERVER == jfleet.Role.SERVER == 2
    assert isinstance(fleet.Fleet().util, fleet.UtilBase)
    assert fleet.Fleet().is_first_worker is fleet.is_first_worker
