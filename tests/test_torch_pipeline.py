"""The pipeline's schedule arithmetic and the one-process pieces of the
port's pipeline parallelism (``paddle_tpu_torch/distributed/pipeline.py``,
``fleet/pp_layers.py``, ``fleet/parallel_apply.py``) against the JAX
package's, in one process with no spawned ranks.

The tick tables (``_f_sched``/``_b_sched`` at every tick of P 2-4, M
1-8; ``zero_bubble_tables`` with its ``T`` and ring depth ``Q`` at the
P/M of ``tests/test_pipeline_zb.py:28``) and ``SegmentLayers``' bounds
must be equal; ``PipelineLayer`` (a tied embedding through
``SharedLayerDesc``, recompute on) and the one-stage paths of
``pipeline_apply``/``pipeline_value_and_grad`` must give the JAX
values in fp32 within rtol 1e-5, atol 1e-6 (the same math, summed in
another order); ``apply_fsdp_annotations`` the same specs per
parameter and ZeRO stage.  The multi-rank schedules are
``tests/test_torch_pp_train.py``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed.fleet import parallel_apply as jfsdp
from paddle_tpu.distributed.fleet import pp_layers as jpp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.distributed.fleet import parallel_apply as tfsdp
from paddle_tpu_torch.distributed.fleet import pp_layers as tpp

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


@pytest.mark.parametrize("P", [2, 3, 4])
def test_1f1b_tick_arithmetic_equals_jax(P):
    """Every tick of every stage, for M 1-8 (and ticks past the end):
    the same (microbatch, active) pairs, inactive ticks included."""
    for M in range(1, 9):
        for s in range(P):
            for t in range(2 * (M + P - 1) + 2):
                for name in ("_f_sched", "_b_sched"):
                    jm, ja = getattr(jpipe, name)(P, M, s, jnp.asarray(t))
                    assert getattr(tpipe, name)(P, M, s, t) == (
                        int(jm), bool(ja)), (name, P, M, s, t)


@pytest.mark.parametrize("P,M", [(2, 4), (4, 8), (4, 4), (3, 5), (8, 16)])
def test_zero_bubble_tables_equal_jax(P, M):
    want, got = jpipe.zero_bubble_tables(P, M), tpipe.zero_bubble_tables(P, M)
    assert (got["T"], got["Q"]) == (want["T"], want["Q"])
    for k in ("f", "b", "w"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _descs(pkg):
    nn = pkg.nn
    return [nn.Embedding(4, 4), nn.Linear(4, 4), nn.Tanh(), nn.Linear(4, 4),
            nn.Linear(4, 4), nn.Tanh(), nn.Linear(4, 4), nn.Linear(4, 4)]


@pytest.mark.parametrize("parts,method", [
    (3, "uniform"), (4, "uniform"), (2, "layer:Linear"), (5, "layer:Linear"),
    (1, "layer:Tanh"), (2, "layer:Tanh")])
def test_segment_layers_bounds_equal_jax(parts, method):
    """Uniform bounds over 8 items and ``layer:<Name>`` bounds (each stage
    starting at an equal share of that class's layers), or the same
    error when they do not divide."""
    def bounds(pkg, mod):
        try:
            return mod.SegmentLayers(_descs(pkg), parts, method).do_segment()
        except ValueError as e:
            return f"ValueError: {e}"
    assert bounds(tp, tpp) == bounds(jp, jpp)


def _pipeline_layer(pkg, mod):
    """A tied-embedding LM in stages: the embedding (shared key
    ``emb``), two Linear + Tanh layers, and the head reusing the
    embedding's table through ``forward_func``."""
    nn = pkg.nn

    def head(layer, x):
        return pkg.matmul(x, layer.weight, transpose_y=True)

    return mod.PipelineLayer(
        [mod.SharedLayerDesc("emb", nn.Embedding, None, "weight", 32, 16),
         mod.LayerDesc(nn.Linear, 16, 16), nn.Tanh(),
         mod.LayerDesc(nn.Linear, 16, 16), nn.Tanh(),
         mod.SharedLayerDesc("emb", nn.Embedding, head, "weight", 32, 16)],
        num_stages=2, loss_fn=lambda out, lab: pkg.nn.functional.cross_entropy(
            pkg.reshape(out, [-1, 32]), pkg.reshape(lab, [-1])),
        recompute_interval=2)


def test_pipeline_layer_forward_and_loss_match_jax():
    """The same weights (the JAX layer's ``state_dict``): the forward's
    logits and the loss within rtol 1e-5, atol 1e-6, the loss's
    gradients too (the tied table takes the embedding's and the head's);
    the stage split and the stage layers as JAX's."""
    jp.seed(3)
    jl = _pipeline_layer(jp, jpp)
    tl = _pipeline_layer(tp, tpp)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(state) == sorted(tl.state_dict())
    tl.load_numpy_state(state)
    assert tl.segment_bounds == jl.segment_bounds == [0, 3, 6]
    assert [len(tl.get_stage_layers(s)) for s in (0, 1)] == [3, 3]
    assert tl.get_stage_layers(1)[2] is not tl.run_functions[0]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32, (3, 5))
    lab = rng.integers(0, 32, (3, 5))
    out = {}
    for name, pkg, layer in (("jax", jp, jl), ("torch", tp, tl)):
        layer.train()
        y = layer(pkg.to_tensor(ids))
        loss = layer.loss(y, pkg.to_tensor(lab))
        loss.backward()
        out[name] = (np.asarray(y.numpy()), float(loss.numpy()),
                     {n: np.asarray(p.grad.numpy())
                      for n, p in layer.named_parameters()})
    (jy, jloss, jg), (ty, tloss, tg) = out["jax"], out["torch"]
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL, atol=ATOL)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def _chain(rng, P_, Lpp=2, H=8):
    return {"w": (rng.standard_normal((P_, Lpp, H, H)) * 0.3
                  ).astype(np.float32)}, {
        "emb": rng.standard_normal((16, H)).astype(np.float32),
        "head": rng.standard_normal((H, 16)).astype(np.float32)}


def _chain_fns(take, scan_layers, log_softmax, pick):
    def first_fn(e, x):
        return take(e["emb"], x)

    def mid_fn(s, h):
        h2 = scan_layers(s["w"], h)
        return h2, (h2 ** 2).sum()

    mid_fn.aux_aware = True

    def last_fn(e, h, lb):
        return -pick(log_softmax(h @ e["head"]), lb).sum()
    return first_fn, mid_fn, last_fn


def _jax_fns():
    def scan(ws, h):
        for i in range(ws.shape[0]):
            h = jnp.tanh(h @ ws[i])
        return h
    return _chain_fns(lambda t, i: jnp.take(t, i, axis=0), scan,
                      lambda z: jax.nn.log_softmax(z, -1),
                      lambda lp, lb: jnp.take_along_axis(
                          lp, lb[..., None], -1)[..., 0])


def _torch_fns():
    def scan(ws, h):
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i])
        return h
    return _chain_fns(lambda t, i: t[i], scan,
                      lambda z: torch.log_softmax(z, -1),
                      lambda lp, lb: lp.gather(-1, lb[..., None])[..., 0])


@pytest.mark.parametrize("mb_aware", [False, True])
def test_one_stage_value_and_grad_matches_jax(mb_aware):
    """``pipeline_value_and_grad`` at pp 1 (no mesh; JAX on a one-device
    ``pp`` mesh): the aux-aware chain over 4 microbatches, and the whole
    batch at once for a body without aux: loss, stage and extras
    gradients."""
    rng = np.random.default_rng(1)
    sp, ex = _chain(rng, 1)
    ids = rng.integers(0, 16, (8, 4))
    labels = rng.integers(0, 16, (8, 4))
    jf, jm, jl = _jax_fns()
    tf, tm, tl = _torch_fns()
    if not mb_aware:      # a body with no aux: the batch runs whole
        jm = (lambda f: lambda s, h: f(s, h)[0])(jm)
        tm = (lambda f: lambda s, h: f(s, h)[0])(tm)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("pp",))
    jloss, jdsp, jdex = jpipe.pipeline_value_and_grad(
        jf, jm, jl, {k: jnp.asarray(v) for k, v in sp.items()},
        {k: jnp.asarray(v) for k, v in ex.items()}, jnp.asarray(ids),
        jnp.asarray(labels), 4, mesh=mesh, aux_scale=0.5)
    tloss, tdsp, tdex = tpipe.pipeline_value_and_grad(
        tf, tm, tl, {k: torch.from_numpy(v[0]) for k, v in sp.items()},
        {k: torch.from_numpy(v) for k, v in ex.items()},
        torch.from_numpy(ids), torch.from_numpy(labels), 4, aux_scale=0.5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tdsp["w"].numpy(), np.asarray(jdsp["w"])[0],
                               rtol=RTOL, atol=ATOL)
    for k in ex:
        np.testing.assert_allclose(tdex[k].numpy(), np.asarray(jdex[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("with_aux", [False, True])
def test_one_stage_pipeline_apply_runs_the_stages_in_order(with_aux):
    """``pipeline_apply`` at pp 1 runs the stacked stages in sequence
    (the JAX ``_sequential``), the aux summed over them."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((3, 8, 8)) * 0.3).astype(np.float32)
    x = rng.standard_normal((4, 8)).astype(np.float32)

    def stage(tanh):
        def fn(sp, h):
            y = tanh(h @ sp["w"])
            return (y, (y ** 2).sum()) if with_aux else y
        return fn

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("pp",))
    want = jpipe.pipeline_apply(stage(jnp.tanh), {"w": jnp.asarray(w)},
                                jnp.asarray(x), 2, mesh=mesh,
                                with_aux=with_aux)
    got = tpipe.pipeline_apply(stage(torch.tanh), {"w": torch.from_numpy(w)},
                               torch.from_numpy(x), 2, with_aux=with_aux)
    for g, j in zip(got if with_aux else (got,), want if with_aux
                    else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_fsdp_annotations_equal_jax(monkeypatch, stage):
    """At a sharding degree of 2, each parameter's placement and ZeRO
    1/2 optimizer-state spec as the JAX package records them (the
    largest dimension that divides, nothing under 1024 elements); the
    mesh step reads them as its storage sharding.  ``distributed_model``
    applies the default strategy's stage (1), as JAX's."""
    for mod in (jenv, tenv):
        monkeypatch.setattr(mod, "_HYBRID_DEGREES",
                            {**mod.hybrid_degrees(), "sharding": 2})

    def model(pkg):
        nn = pkg.nn
        return nn.LayerList([nn.Embedding(64, 32), nn.Linear(32, 48),
                             nn.Linear(48, 8)])

    def specs(m):
        out = {}
        for n, p in m.named_parameters():
            # the JAX package records the specs on its Parameter, the port
            # on the torch parameter
            t = p if isinstance(m, jp.nn.Layer) else p._data
            out[n] = tuple(None if s is None else tuple(s) for s in (
                getattr(t, "placements", None),
                getattr(t, "_opt_state_spec", None)))
        return out

    want = specs(jfsdp.apply_fsdp_annotations(model(jp), stage=stage))
    assert specs(tfsdp.apply_fsdp_annotations(model(tp), stage=stage)) == want
    assert any(a or b for a, b in want.values())
    if stage == 1:      # the default strategy's sharding stage
        from paddle_tpu.distributed import fleet as jfleet
        from paddle_tpu_torch.distributed import fleet as tfleet
        assert (specs(tfleet.distributed_model(model(tp)))
                == specs(jfleet.distributed_model(model(jp))) == want)
