"""The port's GShard MoE FFN (``paddle_tpu_torch.incubate.moe``) against
the JAX package's (``paddle_tpu.incubate.moe``).

Both get the same numpy inputs and weights, drawn from a seed.

* ``moe_capacity`` is the same integer formula.
* ``topk_gating`` gives the JAX dispatch, combine, aux and mask1 bit for
  bit in fp32 (T 24, E 4, k 1 and 2, capacity factors 0.5, 1.25 and
  2.0), on router probabilities full of exact ties (softmax of integer
  logits): both take the first maximum.
* ``moe_ffn`` gives JAX's ``y`` and ``aux`` and, through a loss ``sum(y
  * ct) + 0.01 * aux``, the gradients of ``x``, ``gate_w``, ``fc1_w/b``
  and ``fc2_w/b`` that ``jax.grad`` gives, within 1e-5 of each tensor's
  scale (fp32: the two packages sum in different orders).
* The indexed route equals the dense ``[T, E, C]`` route: the dispatch
  bit for bit (a gather moves values exactly), the output within 1e-6
  of its scale (the combine's k-term sum runs in another order).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate import moe as jmoe
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.incubate import moe as tmoe

T, H, F, E = 24, 8, 16, 4
REL = 1e-5


@pytest.fixture(autouse=True)
def cpu_device():
    """New layers land on the CPU; the default device is restored after
    each test, so later tests in the process see it unset."""
    prev = tdevice._CURRENT[0]
    tdevice.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _weights(seed, T=T, H=H, F=F, E=E):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, H)).astype(np.float32),
            rng.normal(size=(H, E)).astype(np.float32),
            (rng.normal(size=(E, H, F)) * 0.2).astype(np.float32),
            (rng.normal(size=(E, F)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, F, H)) * 0.2).astype(np.float32),
            (rng.normal(size=(E, H)) * 0.1).astype(np.float32))


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.mark.parametrize("n", [1, 7, 24, 1000])
@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.25), (2, 0.5), (2, 2.0),
                                  (4, 1.0)])
def test_moe_capacity(n, k, cf):
    for e in (1, 3, 4, 8, 64):
        assert tmoe.moe_capacity(n, e, k, cf) == jmoe.moe_capacity(n, e, k,
                                                                    cf)


def _tied_gates(seed):
    """Softmax of small integer logits: most rows hold exact ties."""
    rng = np.random.default_rng(seed)
    lg = rng.integers(-1, 2, (T, E)).astype(np.float32)
    g = np.exp(lg - lg.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
@pytest.mark.parametrize("k", [1, 2])
def test_topk_gating_bit_equal_with_ties(k, cf):
    gates = _tied_gates(10 * k + int(4 * cf))
    rows_with_ties = sum(len(set(r)) < E for r in gates.tolist())
    assert rows_with_ties > T // 2
    C = tmoe.moe_capacity(T, E, k, cf)
    want = jmoe.topk_gating(jnp.asarray(gates), k, C)
    got = tmoe.topk_gating(torch.from_numpy(gates), k, C)
    for name, g, w in zip(("dispatch", "combine", "aux", "mask1"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    # and tokens were dropped wherever capacity is below demand
    if k * T > E * C:
        assert float(got[0].sum()) < k * T


def _jax_ffn(args, k, cf, ct, activation=None):
    kw = {} if activation is None else {"activation": activation}

    def loss(x, gw, w1, b1, w2, b2):
        y, aux = jmoe.moe_ffn(x, gw, w1, b1, w2, b2, top_k=k,
                              capacity_factor=cf, **kw)
        return jnp.sum(y * ct) + 0.01 * aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True)(
            *map(jnp.asarray, args))
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


def _port_ffn(args, k, cf, ct, fn=tmoe.moe_ffn, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, aux = fn(*ts, top_k=k, capacity_factor=cf, **kw)
    ((y * torch.from_numpy(ct)).sum() + 0.01 * aux).backward()
    return (y.detach().numpy(), float(aux.detach()),
            [t.grad.numpy() for t in ts])


NAMES = ("x", "gate_w", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.25), (2, 0.5), (2, 2.0)])
def test_moe_ffn_and_grads_match_jax(k, cf):
    args = _weights(3 + k)
    ct = np.random.default_rng(9).normal(size=(T, H)).astype(np.float32)
    jy, jaux, jg = _jax_ffn(args, k, cf, ct)
    ty, taux, tg = _port_ffn(args, k, cf, ct)
    _close(ty, jy, "y")
    assert abs(taux - jaux) <= REL * abs(jaux)
    for n, g, w in zip(NAMES, tg, jg):
        _close(g, w, f"d{n}")
    # routing really dropped tokens at cf 0.5
    C = tmoe.moe_capacity(T, E, k, cf)
    gates = torch.softmax(torch.from_numpy(args[0] @ args[1]), -1)
    r = tmoe.route(gates, k, C)
    if cf == 0.5:
        assert int((r.slots == E * C).sum()) > 0


def test_top1_router_gets_task_gradient():
    """Top-1 scales by the raw probability, so the task loss reaches the
    router (the JAX test's regression), with JAX's gradient."""
    args = _weights(3)
    ct = np.ones((T, H), np.float32)
    relu = dict(activation=jax.nn.relu)
    jy, _, jg = _jax_ffn(args, 1, 4.0, ct, **relu)
    ty, _, tg = _port_ffn(args, 1, 4.0, ct, activation=torch.relu)
    assert float(np.abs(tg[1]).max()) > 1e-6
    _close(ty, jy, "y")
    _close(tg[1], jg[1], "dgate_w")


def test_tokens_over_capacity_give_zero():
    """Every token routes to expert 0; capacity ceil(32 * 0.5 / 4) = 4
    serves the first four and the rest come out as exact zeros."""
    rng = np.random.default_rng(1)
    x = (np.abs(rng.normal(size=(32, H))) + 0.1).astype(np.float32)
    gw = np.zeros((H, E), np.float32)
    gw[:, 0] = 1.0
    _, _, w1, b1, w2, b2 = _weights(1, T=32)
    args = (x, gw, w1, b1, w2, b2)
    y, _ = tmoe.moe_ffn(*map(torch.from_numpy, args), top_k=1,
                        capacity_factor=0.5)
    jy, _ = jmoe.moe_ffn(*map(jnp.asarray, args), top_k=1,
                         capacity_factor=0.5)
    y = y.numpy()
    assert np.isfinite(y).all()
    served = np.abs(y).sum(-1) > 0
    assert served.tolist() == [True] * 4 + [False] * 28
    _close(y, np.asarray(jy), "y")


@pytest.mark.parametrize("k,cf", [(1, 0.5), (2, 0.5), (2, 1.25), (3, 2.0)])
def test_indexed_route_equals_dense_route(k, cf):
    args = _weights(20 + k)
    ts = [torch.from_numpy(a) for a in args]
    C = tmoe.moe_capacity(T, E, k, cf)
    gates = torch.softmax(ts[0] @ ts[1], -1)
    dense_dispatch, dense_combine, dense_aux, _ = tmoe.topk_gating(
        gates, k, C)
    r = tmoe.route(gates, k, C)
    ex = tmoe.dispatch(ts[0], r)
    assert torch.equal(ex, torch.einsum("tec,th->ech", dense_dispatch,
                                        ts[0]))
    assert torch.equal(r.aux, dense_aux.float())
    y, aux = tmoe.moe_ffn(*ts, top_k=k, capacity_factor=cf)
    yd, auxd = tmoe.moe_ffn_dense(*ts, top_k=k, capacity_factor=cf)
    _close(y.numpy(), yd.numpy(), "y", 1e-6)
    assert torch.equal(aux, auxd)
    # the combine weights of the dense route, read at the indexed slots
    flat = dense_combine.reshape(T, E * C)
    for s, w in zip(r.slots, r.weights):
        kept = s < E * C
        got = torch.where(kept, w, 0.0)
        want = flat.gather(1, s.clamp(max=E * C - 1)[:, None])[:, 0]
        assert torch.equal(got, torch.where(kept, want, 0.0))


def test_drop_stats_count_on_the_device():
    args = [torch.from_numpy(a) for a in _weights(5)]
    stats = {}
    tmoe.moe_ffn(*args, top_k=2, capacity_factor=0.5, stats=stats)
    tmoe.moe_ffn(*args, top_k=2, capacity_factor=0.5, stats=stats)
    dropped, routed = stats[T]
    assert routed == 2 * 2 * T
    assert 0 < int(dropped) <= routed // 2


def test_moe_layer_api():
    """``MoELayer``'s forward and ``aux_loss`` surface (the JAX test's),
    top-1 through ``gate="switch"``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import MoELayer
    for gate, k in (("gshard", 2), ("switch", 1)):
        layer = MoELayer(d_model=8, d_hidden=16, num_experts=4, gate=gate)
        assert layer.top_k == k and tuple(layer.fc1_w.shape) == (4, 8, 16)
        x = paddle.to_tensor(np.random.default_rng(0).normal(
            size=(2, 6, 8)).astype(np.float32))
        y = layer(x)
        assert tuple(y.shape) == (2, 6, 8)
        assert isinstance(layer.aux_loss, paddle.Tensor)
        assert float(layer.aux_loss.numpy()) > 0
        want, _ = tmoe.moe_ffn(x._data, *(p._data for p in (
            layer.gate.weight, layer.fc1_w, layer.fc1_b, layer.fc2_w,
            layer.fc2_b)), top_k=k, capacity_factor=layer.capacity_factor)
        assert torch.equal(y._data, want)


@pytest.mark.parametrize("E_,deg,warns", [(4, 2, 0), (6, 4, 1), (64, 1, 1),
                                          (66, 4, 2)])
def test_moe_layer_warnings_as_jax(monkeypatch, E_, deg, warns):
    """Both ``RuntimeWarning``s fire under JAX's conditions: experts that
    do not divide the ``ep_axis`` degree (replicated) and E >= 64."""
    import paddle_tpu.distributed.env as jenv
    from paddle_tpu.incubate import MoELayer as JLayer
    from paddle_tpu_torch.incubate import MoELayer
    degrees = {"dp": deg}
    monkeypatch.setattr(jenv, "hybrid_degrees", lambda: dict(degrees))
    monkeypatch.setattr(tmoe, "hybrid_degrees", lambda: dict(degrees))
    got = []
    for cls in (MoELayer, JLayer):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            layer = cls(4, 8, E_)
        got.append(([str(x.message).split(":")[0] for x in w
                     if x.category is RuntimeWarning], layer.ep_axis))
    assert got[0] == got[1]
    assert len(got[0][0]) == warns
