"""Checkpoints across processes and meshes: the port's
``distributed.checkpoint`` and ``resilience.CheckpointManager`` /
``FaultTolerantTrainer`` on dp, mp, sharding, expert-parallel, sep and
pp meshes, against the JAX package's sharded checkpoints
(``tests/test_checkpoint_dist.py``).

Two spawns of two gloo ranks (``tests/_torch_mesh_workers.py``
``ck_2ranks`` and ``ck_pp_moe_2ranks``) run while this process runs the
JAX side on its 8 virtual CPU devices and the port's one-process
restores.  The models: the JAX test's MLP (``Linear(8, 16)``, GELU,
``Linear(16, 4)``, AdamW at 1e-2, the weights' optimizer state split
over mp by the rule ``(r"\\.weight$", P(None, "mp"))``) and a GPT of 4
layers, hidden 64, 4 heads, vocabulary 128 in fp32 (AdamW at 1e-4; an
MoE variant of 4 experts), the weights carried over from the JAX
models, the batches from a numpy seed.  Each run trains, saves, and
goes on; a restore elsewhere continues from the save.

Tolerances, stated once: a continuation on another mesh or in the other
package holds the MLP to ``tests/test_checkpoint_dist.py``'s bound
(rtol 1e-5, atol 1e-6, losses and parameters) and the GPT to
``tests/test_torch_mesh_train.py``'s (losses rtol 1e-5, atol 1e-6;
parameters rtol 1e-5, atol ``LR / 20``): the packages and the meshes sum
the same products in other orders.  A restore onto the mesh it was saved
on continues bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_mesh_workers as W

CFG = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
           max_seq_len=16, use_flash_attention=False)
MOE = dict(num_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
LR, MLP_LR = 1e-4, 1e-2
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = LR / 20
STEPS, B, S = 4, 4, 16
MLP_STEPS = 5
PORT_MESH = {"axis_names": ["pp", "dp", "sharding", "sep", "mp"],
             "shape": [1, 1, 1, 1, 2]}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_registries():
    """The JAX steps and managers here fill the JAX package's global
    registries: cleared after the module."""
    yield
    from paddle_tpu.profiler import devicetime, flight, metrics, trace
    metrics.reset_metrics()
    flight.clear()
    trace.clear()
    devicetime.reset()


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import device as tdevice
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _jmesh(dp, mp):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp),
                ("dp", "mp"))


def _jnp(t):
    return np.asarray(t.numpy())


def _payload(root):
    import paddle_tpu as jp
    import paddle_tpu.nn as jnn
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    jp.seed(0)
    gpt = GPTForCausalLM(GPTConfig(**CFG))
    jp.seed(1)
    moe = GPTForCausalLM(GPTConfig(**CFG, **MOE))
    jp.seed(7)
    mlp = jnn.Sequential(jnn.Linear(8, 16), jnn.GELU(), jnn.Linear(16, 4))
    rng = np.random.default_rng(3)
    return {"cfg": CFG, "moe_over": MOE, "lr": LR, "mlp_lr": MLP_LR,
            "root": str(root),
            "ids": rng.integers(0, 128, (STEPS, B, S)).astype(np.int64),
            "labels": rng.integers(0, 128, (STEPS, B, S)).astype(np.int64),
            "xs": rng.standard_normal((MLP_STEPS, 8, 8)).astype(np.float32),
            "ys": rng.standard_normal((MLP_STEPS, 8, 4)).astype(np.float32),
            "state": {k: _jnp(v) for k, v in gpt.state_dict().items()},
            "moe_state": {k: _jnp(v) for k, v in moe.state_dict().items()},
            "mlp_state": {k: np.array(_jnp(v), copy=True)
                          for k, v in mlp.state_dict().items()},
            "jax_mlp_dir": str(root / "jax_mlp"),
            "jax_gpt_dir": str(root / "jax_gpt")}


def _jax_mlp(pl, mesh):
    import paddle_tpu as jp
    import paddle_tpu.jit as pjit
    import paddle_tpu.nn as jnn
    from jax.sharding import PartitionSpec as JP
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.GELU(), jnn.Linear(16, 4))
    net.set_state_dict({k: jp.to_tensor(v)
                        for k, v in pl["mlp_state"].items()})
    opt = jp.optimizer.AdamW(learning_rate=MLP_LR,
                             parameters=net.parameters())
    step = pjit.CompiledTrainStep(
        net, lambda m, x, y: ((m(x) - y) ** 2).mean(), opt, mesh=mesh,
        shard_rules=[(r"\.weight$", JP(None, "mp"))])
    return net, step


def _jax_mlp_run(step, pl, lo, hi):
    import paddle_tpu as jp
    return [float(_jnp(step(jp.to_tensor(pl["xs"][i]),
                            jp.to_tensor(pl["ys"][i]))))
            for i in range(lo, hi)]


def _jax_gpt(pl, mesh):
    import paddle_tpu as jp
    import paddle_tpu.jit as pjit
    from paddle_tpu.models import (GPTConfig, GPTForCausalLM,
                                   GPTPretrainingCriterion)
    m = GPTForCausalLM(GPTConfig(**CFG))
    m.set_state_dict({k: jp.to_tensor(v) for k, v in pl["state"].items()})
    crit = GPTPretrainingCriterion()
    opt = jp.optimizer.AdamW(LR, parameters=m.parameters())
    return m, opt, pjit.CompiledTrainStep(
        m, lambda m, x, lab: crit(m(x), lab), opt, mesh=mesh)


def _jax_gpt_run(step, pl, lo, hi):
    import paddle_tpu as jp
    return [float(_jnp(step(jp.to_tensor(pl["ids"][i]),
                            jp.to_tensor(pl["labels"][i]))))
            for i in range(lo, hi)]


def _jax_state(m, step):
    step.sync()
    return {k: _jnp(v) for k, v in m.state_dict().items()}


def _jax_side(pl):
    """The JAX dp2 x mp2 runs: the MLP saved at step 3 and the GPT at
    step 2, each with its continuation; the GPT's optimizer state_dict
    at step 2, by parameter name."""
    from paddle_tpu.resilience import CheckpointManager as JManager
    mesh = _jmesh(2, 2)
    out = {}
    net, step = _jax_mlp(pl, mesh)
    _jax_mlp_run(step, pl, 0, 3)
    JManager(pl["jax_mlp_dir"]).save(step, 3)
    out["mlp_cont"] = _jax_mlp_run(step, pl, 3, MLP_STEPS)
    out["mlp_params"] = _jax_state(net, step)
    m, opt, step = _jax_gpt(pl, mesh)
    _jax_gpt_run(step, pl, 0, 2)
    names = {p.name: n for n, p in m.named_parameters()}
    sd = opt.state_dict()
    out["gpt_state_dict"] = {
        acc: {names[k]: np.asarray(v) for k, v in store.items()}
        for acc, store in sd["accumulators"].items()}
    JManager(pl["jax_gpt_dir"]).save(step, 2)
    out["gpt_cont"] = _jax_gpt_run(step, pl, 2, STEPS)
    out["gpt_state"] = _jax_state(m, step)
    return out


def _port_one_process(pl, kind, root, over=None, state="state"):
    """The port in this process, without a mesh: restore ``root`` into a
    fresh model and continue (the MLP from step 3, a GPT from step 2)."""
    if kind == "mlp":
        net, step = W.ck_mlp(pl)
        info, counts = W._ck_restore(step, root)
        return {"info": info, "counts": counts,
                "cont": W.ck_mlp_run(step, pl, 3, MLP_STEPS),
                "params": W.ck_mlp_params(net)}
    model, step = W.ck_gpt(pl, None, over, state)
    info, counts = W._ck_restore(step, root)
    return {"info": info, "counts": counts,
            "cont": W.ck_gpt_run(step, pl, 2, STEPS),
            "state": model.gather_numpy_state()}


def _jax_restores_port(pl, kind, root):
    """The JAX package on its dp2 x mp2 mesh restores the port's save
    under ``root`` and continues."""
    from paddle_tpu.profiler import counters as jcounters
    from paddle_tpu.resilience import CheckpointManager as JManager
    mesh = _jmesh(2, 2)
    before = jcounters.snapshot()
    if kind == "mlp":
        net, step = _jax_mlp(pl, mesh)
        info = JManager(root).restore(step)
        cont = _jax_mlp_run(step, pl, 3, MLP_STEPS)
        params = _jax_state(net, step)
    else:
        m, _, step = _jax_gpt(pl, mesh)
        info = JManager(root).restore(step)
        cont = _jax_gpt_run(step, pl, 2, STEPS)
        params = _jax_state(m, step)
    d = jcounters.delta(before)
    return {"info": info, "cont": cont, "params": params,
            "resharded_restores": d.get("resilience.resharded_restores", 0)}


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    pl = _payload(root)
    jax_out = _jax_side(pl)          # the ranks restore these saves
    two = W.spawn("ck_2ranks", 2, root, pl)
    pm = W.spawn("ck_pp_moe_2ranks", 2, root, pl)
    one = {"mlp": _port_one_process(pl, "mlp", pl["jax_mlp_dir"]),
           "gpt": _port_one_process(pl, "gpt", pl["jax_gpt_dir"])}
    res = two.results()
    res_pm = pm.results()
    into_jax = {"mlp": _jax_restores_port(
        pl, "mlp", os.path.join(pl["root"], "mlp_mp2")),
        "gpt": _jax_restores_port(pl, "gpt",
                                  os.path.join(pl["root"], "gpt_mp2"))}
    one_pm = {name: _port_one_process(
        pl, "gpt", os.path.join(pl["root"], name), over, state)
        for name, over, state in (
            ("pp_gpipe", None, "state"), ("pp_interleaved", None, "state"),
            ("moe_dp2", MOE, "moe_state"))}
    return {"pl": pl, "jax": jax_out, "res": res, "res_pm": res_pm,
            "one": one, "into_jax": into_jax, "one_pm": one_pm}


def _close_mlp(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _close_gpt(cont, state, want_cont, want_state, what):
    np.testing.assert_allclose(cont, want_cont, rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: losses")
    for k, v in want_state.items():
        np.testing.assert_allclose(state[k], v, rtol=RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{what}: {k}")


def _check(kind, out, jax_out, what):
    if kind == "mlp":
        _close_mlp(out["cont"], jax_out["mlp_cont"], f"{what}: losses")
        for k, v in jax_out["mlp_params"].items():
            _close_mlp(out["params"][k], v, f"{what}: {k}")
    else:
        _close_gpt(out["cont"], out["state"], jax_out["gpt_cont"],
                   jax_out["gpt_state"], what)


# -- JAX -> port ---------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlp", "gpt"])
def test_jax_mesh_save_restores_at_mp2(ran, kind):
    """A JAX dp2 x mp2 save restored by the port at mp2 (two gloo ranks):
    a resharding, counted; the next steps' losses and parameters are the
    JAX continuation's."""
    for r in ran["res"]:
        out = r[f"jax_{kind}"]
        assert out["info"]["resharded"] and out["info"]["saved_mesh"] == {
            "axis_names": ["dp", "mp"], "shape": [2, 2]}
        assert not out["info"]["streams_restored"]
        assert out["counts"]["resilience.resharded_restores"] == 1
        _check(kind, out, ran["jax"], f"jax {kind} -> port mp2")


@pytest.mark.parametrize("kind", ["mlp", "gpt"])
def test_jax_mesh_save_restores_in_one_process(ran, kind):
    out = ran["one"][kind]
    assert out["info"]["resharded"]
    assert out["counts"]["resilience.restores"] == 1
    _check(kind, out, ran["jax"], f"jax {kind} -> port, one process")


# -- port -> JAX ---------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlp", "gpt"])
def test_port_mp2_save_restores_into_jax(ran, kind):
    """The port's mp2 save restored by the JAX ``CheckpointManager`` on
    its dp2 x mp2 mesh: a resharding for it too, and its continuation is
    the port's."""
    out = ran["into_jax"][kind]
    assert out["info"]["resharded"] and out["resharded_restores"] == 1
    assert out["info"]["saved_mesh"] == PORT_MESH
    port = ran["res"][0][f"port_{kind}"]
    if kind == "mlp":
        _close_mlp(out["cont"], port["cont"], "port mlp -> jax: losses")
        for k, v in port["params"].items():
            _close_mlp(out["params"][k], v, f"port mlp -> jax: {k}")
    else:
        _close_gpt(out["cont"], out["params"], port["cont"], port["state"],
                   "port gpt -> jax")


def test_port_save_files_are_the_jax_layout(ran):
    """Each rank writes ``{rank}_0.{sid}.distcp.npz`` and ``{rank}.{sid}.
    metadata.json`` recording ``world_size`` 2; the manifest records the
    mesh and each array's spec; the mp-split weight is two chunks, one a
    rank; the save cost one counted sync on each rank."""
    step_dir = os.path.join(ran["pl"]["root"], "mlp_mp2", "step-00000003")
    files = sorted(os.listdir(step_dir))
    assert files == ["0.0.metadata.json", "0_0.0.distcp.npz",
                     "1.0.metadata.json", "1_0.0.distcp.npz",
                     "MANIFEST.json"]
    metas = [json.load(open(os.path.join(step_dir, f"{r}.0.metadata.json")))
             for r in range(2)]
    assert [m["world_size"] for m in metas] == [2, 2]
    w = [m["tensors"]["model/0.weight"]["chunks"] for m in metas]
    assert [[(c["offset"], c["shape"]) for c in cs] for cs in w] == [
        [([0, 0], [8, 8])], [([0, 8], [8, 8])]]
    man = json.load(open(os.path.join(step_dir, "MANIFEST.json")))
    assert man["mesh"] == PORT_MESH
    assert man["arrays"]["model/0.weight"]["spec"] == [None, "mp"]
    assert man["arrays"]["opt/acc/moment1/p0"]["spec"] == [None, "mp"]
    assert man["arrays"]["model/0.weight"]["shape"] == [8, 16]
    for r in ran["res"]:
        assert r["port_mlp"]["save"]["syncs"] == 1
        assert r["port_mlp"]["save"]["saves"] == 1


def test_fused_qkv_is_three_boxes_a_rank(ran):
    """The mp2 GPT's ``qkv_w`` (each rank: its heads of q, of k and of v)
    is six boxes on disk, three a rank, which assemble to the unsharded
    tensor bit for bit."""
    from paddle_tpu_torch.distributed import checkpoint as tck
    step_dir = os.path.join(ran["pl"]["root"], "gpt_mp2", "step-00000002")
    H = CFG["hidden_size"]
    for r in range(2):
        meta = json.load(open(os.path.join(step_dir, f"{r}.0.metadata.json")))
        chunks = meta["tensors"]["model/qkv_w"]["chunks"]
        assert [c["offset"][2] for c in chunks] == [
            j * H + r * H // 2 for j in range(3)]
        assert all(c["shape"] == [CFG["num_layers"], H, H // 2]
                   for c in chunks)
    whole = torch.empty(CFG["num_layers"], H, 3 * H)
    tck.load_state_dict({"model/qkv_w": whole}, step_dir)
    np.testing.assert_array_equal(
        whole.numpy(), ran["res"][0]["port_gpt"]["saved_state"]["qkv_w"])
    assert ran["res"][0]["port_gpt"]["qkv_w_shard"] == (
        CFG["num_layers"], H, 3 * H // 2)


# -- resharding and same-mesh restores in the port ------------------------------
@pytest.mark.parametrize("name", ["sharding2", "sep2", "pp_gpipe",
                                  "pp_interleaved", "moe_dp2"])
def test_same_mesh_restore_is_bit_for_bit(ran, name):
    """A fresh model on the mesh a save was made on restores it and
    repeats the next two steps bit for bit: losses and every parameter,
    the ranks' own random streams included."""
    res = ran["res"] if name in ("sharding2", "sep2") else ran["res_pm"]
    for r in res:
        out = r[name]
        assert not out["same_info"]["resharded"]
        assert out["same_info"]["streams_restored"]
        assert out["same_counts"]["resilience.resharded_restores"] == 0
        assert out["same_cont"] == out["cont"]
        for k, v in out["final"].items():
            np.testing.assert_array_equal(out["same_final"][k], v, err_msg=k)


def test_sep2_dropout_streams_are_the_ranks_own(ran):
    """Under the sequence split each rank draws its dropout masks from
    its chunk's generator: the two ranks' continuations are equal (the
    mean loss), the streams that repeat them are each rank's."""
    a, b = (r["sep2"] for r in ran["res"])
    assert a["cont"] == b["cont"] and a["same_cont"] == a["cont"]
    # dropout moved the losses off the dropout-free sharding2 run's
    assert a["first"] != ran["res"][0]["sharding2"]["first"]


def test_storage_sharded_save_reshards_onto_mp2(ran):
    """The GPT saved at sharding 2 (its replicated parameters' optimizer
    state split over the ranks) restores at mp2: counted as a resharding
    on each rank, the streams left as they are, the continuation within
    the bound of the uninterrupted sharding-2 run's."""
    for r in ran["res"]:
        out = r["sharding2_to_mp2"]
        assert out["info"]["resharded"]
        assert not out["info"]["streams_restored"]
        assert out["counts"]["resilience.resharded_restores"] == 1
        assert out["counts"]["resilience.restores"] == 1
        _close_gpt(out["cont"], out["state"], r["sharding2"]["cont"],
                   r["sharding2"]["final"], "sharding2 -> mp2")


@pytest.mark.parametrize("name", ["pp_gpipe", "pp_interleaved", "moe_dp2"])
def test_pp_and_ep_saves_restore_in_one_process(ran, name):
    """The pp2 saves (each rank writes its stages' rows; the interleaved
    schedule's two chunks a rank are two boxes each) and the dp2
    expert-parallel save (each rank its experts) restore into one
    process without a mesh and continue within the bound."""
    mesh_run = ran["res_pm"][0][name]
    out = ran["one_pm"][name]
    assert out["info"]["resharded"]
    _close_gpt(out["cont"], out["state"], mesh_run["cont"],
               mesh_run["final"], f"{name} -> one process")


def test_interleaved_rows_are_boxes_per_chunk(ran):
    step_dir = os.path.join(ran["pl"]["root"], "pp_interleaved",
                            "step-00000002")
    meta = json.load(open(os.path.join(step_dir, "1.0.metadata.json")))
    rows = [(c["offset"][0], c["shape"][0])
            for c in meta["tensors"]["model/ln1_w"]["chunks"]]
    assert rows == [(1, 1), (3, 1)]   # rank 1: layer 1 and layer 3


# -- the trainer, the counters, the optimizer ----------------------------------
def test_trainer_dp2_preempt_is_bit_identical(ran):
    """``FaultTolerantTrainer`` on both ranks of a dp2 mesh, preempted
    after step 3: every rank restores rank 0's step and ends on the
    uninterrupted run's losses and parameters bit for bit."""
    for r in ran["res"]:
        base, pre = r["trainer"], r["trainer_preempt"]
        assert pre["recoveries"] == 1 and base["recoveries"] == 0
        assert sorted(pre["losses"]) == list(range(1, 7))
        assert pre["losses"] == base["losses"]
        for k, v in base["params"].items():
            np.testing.assert_array_equal(pre["params"][k], v, err_msg=k)
    assert ran["res"][0]["trainer"]["losses"] == \
        ran["res"][1]["trainer"]["losses"]


def test_counters_allreduce(ran):
    """At two ranks the element-wise sum of every rank's counters; at one
    process a snapshot."""
    from paddle_tpu_torch.profiler import counters
    assert [r["allreduce"] for r in ran["res"]] == [3, 3]
    counters.inc("test.mesh_checkpoint.one_process", 2)
    assert counters.allreduce() == counters.snapshot()


def test_optimizer_state_dict_is_whole_on_a_storage_sharded_step(ran):
    """``Optimizer.state_dict()`` on the sharding-2 step returns whole
    tensors (gathered from the ranks' slices), equal to the JAX
    ``state_dict()`` after the same two steps within the trajectory
    bound."""
    want = ran["jax"]["gpt_state_dict"]
    for r in ran["res"]:
        got = r["sharding2"]["state_dict"]
        assert sorted(got) == sorted(want)
        for acc, store in want.items():
            for name, v in store.items():
                assert got[acc][name].shape == v.shape, (acc, name)
                np.testing.assert_allclose(got[acc][name], v, rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"{acc} {name}")


# -- the box arithmetic ----------------------------------------------------------
class _Mesh:
    """A stand-in mesh of the given degrees at the given coordinates."""

    def __init__(self, degrees, coord):
        from paddle_tpu_torch.distributed.env import AXIS_ORDER
        self.shape = {a: degrees.get(a, 1) for a in AXIS_ORDER}
        self.coord = {a: coord.get(a, 0) for a in AXIS_ORDER}
        self._order = AXIS_ORDER

    def degree(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        i = 0
        for a in self._order:
            if a in axes:
                i = i * self.shape[a] + self.coord[a]
        return i


@pytest.mark.parametrize("spec,fused,shape,degrees", [
    ((None, None, "mp"), 3, (2, 4, 12), {"mp": 2}),
    ((None, "mp"), 1, (6, 8), {"mp": 2}),
    (("mp", None), 1, (8, 3), {"mp": 4}),
    ((None, "dp", None, "mp"), 1, (2, 4, 3, 8), {"dp": 2, "mp": 2}),
    ((("dp", "mp"),), 1, (8,), {"dp": 2, "mp": 2}),
])
def test_shard_boxes_invert_local_shard(spec, fused, shape, degrees):
    """Every rank's boxes, filled from its ``local_shard``, tile the whole
    tensor exactly once."""
    from paddle_tpu_torch.distributed import sharding_utils as su
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    seen = torch.zeros(shape, dtype=torch.int32)
    axes = list(degrees)
    coords = np.stack(np.meshgrid(*[range(degrees[a]) for a in axes],
                                  indexing="ij"), -1).reshape(-1, len(axes))
    for c in coords:
        mesh = _Mesh(degrees, dict(zip(axes, map(int, c))))
        local = su.local_shard(full, su.P(*spec), mesh, fused)
        for off, shp, loc in su.shard_boxes(shape, su.P(*spec), mesh, fused):
            g = tuple(slice(o, o + n) for o, n in zip(off, shp))
            lo = tuple(slice(o, o + n) for o, n in zip(loc, shp))
            assert torch.equal(local[lo], full[g])
            seen[g] += 1
        assert su.global_shape(local.shape, su.P(*spec), mesh) == shape
    assert bool((seen == 1).all())


def test_shard_boxes_rows_and_writer():
    """A pipeline stage's rows (interleaved: two runs) are one box a run;
    of the ranks holding the same boxes, the one at index 0 on every axis
    the spec does not split writes."""
    from paddle_tpu_torch.distributed import sharding_utils as su
    mesh = _Mesh({"pp": 2, "dp": 2}, {"pp": 1, "dp": 1})
    boxes = su.shard_boxes((8, 4), su.P("pp", None), mesh, rows=[2, 3, 6, 7])
    assert boxes == [((2, 0), (2, 4), (0, 0)), ((6, 0), (2, 4), (2, 0))]
    assert not su.writes_shard(su.P("pp", None), mesh)
    assert su.writes_shard(su.P("pp", "dp"), mesh)
    assert su.writes_shard(su.P(), _Mesh({"dp": 2}, {}))
    assert su.writes_shard(su.P(), None)
