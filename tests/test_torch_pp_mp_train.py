"""Pipeline-parallel GPT training in the port against the JAX package's
compiled schedules, the runs ``tests/test_torch_pp_train.py`` leaves
out: an MoE GPT under GPipe at pp 2, 1F1B over pp 2 x mp 2 (the manual
tensor-parallel stage bodies, ``tests/test_pipeline_tp.py``) and
zero-bubble over pp 4 (``tests/test_pipeline_zb.py``), then pp 2 x sep
2 and pp 2 x sharding 2 meshes, which the port refuses, and the ZeRO
annotations as the mesh step's storage sharding at a sharding degree
of 4.

Two gloo ranks (``tests/_torch_mesh_workers.py``: ``pp_moe_2ranks``)
and four (``pp_4ranks``) run while the JAX steps run here under
``fleet.init``/``fleet._reset()`` (pp 2 x dp 4, pp 2 x mp 2 x dp 2, pp 4
x dp 2), each once (one module fixture).
The model, the batches, the steps and the tolerances are
``tests/test_torch_pp_train.py``'s (the pp 2 runs, whose JAX steps
would take this file past its time).
"""

import pytest

import _torch_mesh_workers as W
from test_torch_pp_train import (M, STEPS, _clear_jax_registries,  # noqa: F401
                                 _jax_fleet, _jax_train, _misses, _payload)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    pl = _payload()
    tmp = tmp_path_factory.mktemp("pp4")
    two = W.spawn("pp_moe_2ranks", 2, tmp, pl)
    four = W.spawn("pp_4ranks", 4, tmp, pl)
    jax_out = {}
    with _jax_fleet(dp=4, pp=2):
        jax_out["moe"] = _jax_train(pl, {"num_experts": 2}, "state_moe")
    with _jax_fleet(dp=2, pp=2, mp=2):
        jax_out["1f1b_mp2"] = _jax_train(pl, kind="1f1b")
    with _jax_fleet(dp=2, pp=4):
        jax_out["zb_pp4"] = _jax_train(pl, kind="zero_bubble")
    return pl, jax_out, four.results(), two.results()


def test_moe_gpipe_aux_rides_the_pipeline(trained):
    """An MoE GPT (2 experts) under GPipe at pp 2 through
    ``DistributedTrainStep``, the aux carried through the pipeline into
    the objective (``loss + 0.01 * moe_aux_loss()``,
    ``tests/test_distributed.py:277``): losses and every gathered
    parameter against the JAX step; two shifts a tick."""
    _, j, _, res2 = trained
    for out in res2:
        assert _misses(out, j["moe"]) == []
        assert out[2] == [2 * (M + 1)] * STEPS


def test_1f1b_tensor_parallel_matches_jax_step(trained):
    """1F1B over pp 2 x mp 2 (``tests/test_pipeline_tp.py:92``): the
    manual tensor-parallel stage bodies, the vocabulary-parallel
    embedding and cross entropy; losses and every gathered parameter
    against the JAX step; stage s of either mp rank holds P - s
    microbatches at most, and every rank shifts twice a tick."""
    _, j, res4, _ = trained
    for out in res4:
        assert _misses(out["1f1b_mp2"], j["1f1b_mp2"]) == []
        assert out["1f1b_mp2"][2] == [4 * (M + 1)] * STEPS
    assert [out["1f1b_mp2"][3] for out in res4] == [2, 2, 1, 1]


def test_zero_bubble_pp4_matches_jax_step(trained):
    """Zero-bubble over pp 4 (``tests/test_pipeline_zb.py:145``): dX and
    W split, the W steps on the idle ticks of ``zero_bubble_tables``;
    no stage ever holds more microbatches than the ring depth ``Q``, and
    every rank shifts twice on each of its ``T`` ticks."""
    from paddle_tpu_torch.distributed.pipeline import zero_bubble_tables
    _, j, res4, _ = trained
    tables = zero_bubble_tables(4, M)
    for out in res4:
        assert _misses(out["zb_pp4"], j["zb_pp4"]) == []
        assert 1 <= out["zb_pp4"][3] <= tables["Q"]
        assert out["zb_pp4"][2] == [2 * tables["T"]] * STEPS


def test_sep_with_pp_refused(trained):
    """A pp 2 x sep 2 mesh: the mesh step and the 1F1B step raise,
    naming ROADMAP.md A7e-sep (JAX's 1F1B refuses sep too,
    ``engine.py:214-218``)."""
    _, _, res4, _ = trained
    for out in res4:
        for err in out["sep_refused"]:
            assert err.startswith("NotImplementedError"), err
            assert "A7e-sep" in err, err
            # the advice names no route the mesh step refuses
            assert "gpipe" not in err, err
        assert "train long sequences over sep without pp" in \
            out["sep_refused"][1], out["sep_refused"][1]


def test_storage_sharding_with_pp_refused(trained):
    """A pp 2 x sharding 2 mesh: the GPT built under it would take the
    mesh step's storage sharding, which does not compose with the
    stages' rows yet; the step raises, naming ROADMAP.md A7e-sep."""
    _, _, res4, _ = trained
    for out in res4:
        err = out["sharding_refused"]
        assert err.startswith("NotImplementedError"), err
        assert "A7e-sep" in err and "storage sharding" in err, err


def test_zero_annotations_become_the_mesh_steps_storage_sharding(trained):
    """At a sharding degree of 4, ``fleet.apply_fsdp_annotations``'s
    specs are what ``MeshPlan`` shards a parameter's optimizer state by:
    ZeRO 1's ``_opt_state_spec`` beside a replicated placement, ZeRO 3's
    placement (a parameter they leave whole, under 1024 elements, takes
    the mesh step's default, its first axis over ``sharding``)."""
    _, _, res4, _ = trained
    for out in res4:
        for stage, specs in out["zero_storage"].items():
            annotated = {n: s[1] if stage == 1 else s[0]
                         for n, s in specs.items()}
            assert sum(bool(v) for v in annotated.values()) == 2, stage
            for name, want in annotated.items():
                if want:
                    assert specs[name][2] == want, (stage, name)
