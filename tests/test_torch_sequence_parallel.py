"""Megatron sequence-parallel linears of the port (``fleet``'s
``ColumnSequenceParallelLinear``, ``RowSequenceParallelLinear``,
``ScatterOp``, ``GatherOp``, ``mark_as_sequence_parallel_parameter``)
against the JAX package's (``tests/test_distributed.py:226-257``).

One spawn of two gloo ranks (``tests/_torch_mesh_workers.py``
``sp_linears_mp2``) runs ``ScatterOp -> ColumnSequenceParallelLinear(8,
16) -> gelu -> RowSequenceParallelLinear(16, 8) -> GatherOp`` at mp 2 on
the JAX layers' fp32 weights, carried across as numpy, with each rank
holding its shards and its half of the sequence between the ops; the
JAX chain runs here on an mp 2 mesh of the virtual CPU devices.  Loss
``sum(y**2)``.  Tolerances: the output within 1e-4 (the JAX test's own
bound against its dense numpy chain) and every gradient within 1e-4 of
its scale (fp32 sums in another order).
"""

import numpy as np
import pytest

import _torch_mesh_workers as W

ATOL = 1e-4


@pytest.fixture(scope="module")
def sp_pair(tmp_path_factory):
    import jax
    import paddle_tpu as jp
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed.fleet import (ColumnSequenceParallelLinear,
                                              GatherOp,
                                              RowSequenceParallelLinear,
                                              ScatterOp)
    jenv.build_mesh({"mp": 2}, devices=np.asarray(jax.devices()[:2]))
    try:
        jp.seed(3)
        col = ColumnSequenceParallelLinear(8, 16, has_bias=True)
        row = RowSequenceParallelLinear(16, 8, has_bias=True)
        xn = np.asarray(jp.randn([4, 8, 8]).numpy())
        pl = {"x": xn, "w1": np.asarray(col.weight.numpy()),
              "b1": np.asarray(col.bias.numpy()),
              "w2": np.asarray(row.weight.numpy()),
              "b2": np.asarray(row.bias.numpy())}
        ranks = W.spawn("sp_linears_mp2", 2, tmp_path_factory.mktemp("sp"),
                        pl)
        x = jp.to_tensor(xn, stop_gradient=False)
        y = GatherOp.apply(row(jp.nn.functional.gelu(col(ScatterOp.apply(
            x)))))
        (y * y).sum().backward()
        want = {"y": np.asarray(y.numpy()), "dx": np.asarray(x.grad.numpy()),
                "grads": {n: np.asarray(p.grad.numpy()) for n, p in (
                    ("w1", col.weight), ("b1", col.bias),
                    ("w2", row.weight), ("b2", row.bias))},
                "marked": bool(getattr(row.bias, "sequence_parallel",
                                       False))}
    finally:
        jenv.reset_parallel_env()
    return want, ranks.results()


def test_sp_pair_forward_matches_jax(sp_pair):
    """The gathered output on each rank is the JAX chain's; between the
    ops each rank holds half of the sequence (``[4, 4, 8]``) or the
    whole sequence with half the columns (``[4, 8, 8]`` of 16)."""
    want, ranks = sp_pair
    for r in ranks:
        np.testing.assert_allclose(r["y"], want["y"], rtol=0, atol=ATOL)
        assert r["mid_shape"] == (4, 8, 8)
        assert r["part_shape"] == (4, 4, 8)
        assert r["mp_collectives"] > 0


@pytest.mark.parametrize("name", ["dx", "w1", "b1", "w2", "b2"])
def test_sp_pair_gradients_match_jax(sp_pair, name):
    """The input's gradient (all-gathered by ScatterOp's backward) and
    each parameter's, the sharded ones gathered whole, against JAX's."""
    want, ranks = sp_pair
    w = want["dx"] if name == "dx" else want["grads"][name]
    for r in ranks:
        got = r["dx"] if name == "dx" else r["grads"][name]
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(w).max()))


def test_marked_bias_gradient_summed_over_mp(sp_pair):
    """The row linear's bias is marked sequence-parallel in both
    packages; each rank adds it to its own half of the tokens, and its
    gradient is the sum over both halves on every rank (the JAX value),
    which neither rank's own half gives."""
    want, ranks = sp_pair
    assert want["marked"] and all(r["marked"] for r in ranks)
    g = want["grads"]["b2"]
    for r in ranks:
        np.testing.assert_allclose(r["grads"]["b2"], g, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(g).max()))
    # a half of the tokens alone: the gradient of sum(y**2) over them
    y = want["y"]
    halves = [2 * y[:, :4].sum((0, 1)), 2 * y[:, 4:].sum((0, 1))]
    np.testing.assert_allclose(halves[0] + halves[1], g, rtol=1e-5,
                               atol=1e-5)
    assert all(np.abs(h - g).max() > 10 * ATOL for h in halves)
