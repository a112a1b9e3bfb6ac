"""``MultiHeadAttention`` and ``TransformerEncoder`` in the port against
the JAX package, and the attention route.

Weights are carried from the JAX layers; inputs, masks and the output
cotangent are the same numpy arrays.  Cases: no mask, a bool mask
(False drops a key) and an additive one, at S 8 and S 128 (the length
at which, on a CUDA tensor, the port's route takes the flash kernels
K1–K3; on the CPU both packages take their plain attention), post- and
pre-norm.  Tolerance: 1e-5 of each compared tensor's scale (fp32, the
same math in another order).
"""

import importlib
import types

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice

tfa_route = importlib.import_module(
    "paddle_tpu_torch.nn.functional.flash_attention")
TOL = 1e-5
E, H = 32, 4


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=TOL * scale, rtol=0, err_msg=what)


def _mask(kind, S, rng):
    if kind is None:
        return None
    if kind == "bool":
        m = rng.random((2, 1, S, S)) < 0.7
        m[..., 0] = True                     # every query keeps a key
        return m
    return (rng.standard_normal((2, 1, S, S)) * 2.0).astype(np.float32)


def _compare(make, S, mask_kind, call):
    rng = np.random.default_rng(S)
    jp.seed(2)
    jl, tl = make(jp), make(tp)
    tl.load_numpy_state({n: np.asarray(p._data)
                         for n, p in jl.state_dict().items()})
    x = rng.standard_normal((2, S, E)).astype(np.float32)
    m = _mask(mask_kind, S, rng)
    res = {}
    for key, pkg, layer in (("jax", jp, jl), ("torch", tp, tl)):
        xt = pkg.to_tensor(x, stop_gradient=False)
        out = call(layer, xt, None if m is None else pkg.to_tensor(m))
        cot = np.random.default_rng(9).standard_normal(
            out.shape).astype(np.float32)
        out.backward(pkg.to_tensor(cot))
        res[key] = (out.numpy(), xt.grad.numpy(),
                    {n: p.grad.numpy() for n, p in layer.named_parameters()})
    (jo, jgx, jg), (to, tgx, tg) = res["jax"], res["torch"]
    _close(to, jo, "forward")
    _close(tgx, jgx, "input grad")
    assert list(tg) == list(jg)
    for n in jg:
        if n.endswith("k_proj.bias"):
            # its true gradient is 0 (it shifts a whole row of logits):
            # both sides give rounding noise; held to the fp32 tolerance
            # of the query bias' gradient scale
            ref = np.abs(jg[n.replace("k_proj", "q_proj")]).max()
            assert np.abs(tg[n] - jg[n]).max() <= TOL * ref, n
            continue
        _close(tg[n], jg[n], n)


@pytest.mark.parametrize("S", [8, 128])
@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
def test_multi_head_attention_matches_jax(S, mask_kind):
    _compare(lambda pkg: pkg.nn.MultiHeadAttention(E, H), S, mask_kind,
             lambda layer, x, m: layer(x, attn_mask=m))


@pytest.mark.parametrize("S", [8, 128])
@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_encoder_matches_jax(S, mask_kind, normalize_before):
    def make(pkg):
        layer = pkg.nn.TransformerEncoderLayer(
            E, H, 2 * E, dropout=0.0, activation="gelu",
            normalize_before=normalize_before)
        norm = pkg.nn.LayerNorm(E) if normalize_before else None
        return pkg.nn.TransformerEncoder(layer, 2, norm=norm)
    _compare(make, S, mask_kind, lambda layer, x, m: layer(x, m))


def _fake(shape, cuda=True):
    return types.SimpleNamespace(dim=lambda: len(shape), is_cuda=cuda,
                                 shape=shape)


def test_route_takes_the_kernel_where_jax_takes_pallas():
    use = tfa_route._use_kernel
    assert use(_fake((16, 512, 16, 64)))            # BERT-large
    assert use(_fake((2, 128, 4, 128))) and use(_fake((1, 256, 2, 256)))
    assert not use(_fake((16, 512, 16, 64), cuda=False))   # the CPU
    assert not use(_fake((2, 96, 4, 64)))           # S % 128
    assert not use(_fake((2, 128, 4, 96)))          # D not 64/128/256
    assert not use(_fake((2, 128, 64)))             # not 4-d


def test_head_dim_256_on_the_kernel_route_raises(monkeypatch):
    """D 256 on the kernel route once raised naming ROADMAP.md A4; now it
    takes the flash kernels (K1–K3, their plain versions on a CPU
    tensor), as JAX's route takes Pallas (interpret mode here): output
    and the q/k/v gradients within ``TOL`` of JAX's."""
    from paddle_tpu.kernels import flash_attention as jfa
    jroute = importlib.import_module(
        "paddle_tpu.nn.functional.flash_attention")
    monkeypatch.setattr(tfa_route, "_use_kernel", lambda q: True)
    monkeypatch.setattr(jroute, "_use_pallas", lambda q: True)
    interpret = jfa._INTERPRET[0]
    jfa._INTERPRET[0] = True
    rng = np.random.default_rng(4)
    x = [rng.standard_normal((1, 128, 1, 256)).astype(np.float32)
         for _ in range(3)]
    g = rng.standard_normal((1, 128, 1, 256)).astype(np.float32)
    outs = []
    for pkg in (jp, tp):
        q, k, v = (pkg.to_tensor(a, stop_gradient=False) for a in x)
        out = pkg.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
        out.backward(pkg.to_tensor(g))
        outs.append([out.numpy()] + [t.grad.numpy() for t in (q, k, v)])
    jfa._INTERPRET[0] = interpret
    for name, want, got in zip(("out", "dq", "dk", "dv"), *outs):
        _close(got, want, name)


def test_attention_dropout_and_masks_take_the_plain_route(monkeypatch):
    """With a mask or attention dropout the route never takes the kernel
    (on the CPU neither does it without them); like JAX's, the plain path
    applies no attention dropout."""
    calls = []
    monkeypatch.setattr(tfa_route, "_use_kernel",
                        lambda q: calls.append(1) or True)
    monkeypatch.setattr(tfa_route, "flash_attention_fwd",
                        lambda *a, **k: pytest.fail("kernel route taken"))
    x = np.random.default_rng(0).standard_normal((1, 128, 2, 64)).astype(
        np.float32)
    q = tp.to_tensor(x)
    a = tp.nn.functional.scaled_dot_product_attention(q, q, q,
                                                      dropout_p=0.5)
    b = tp.nn.functional.scaled_dot_product_attention(
        q, q, q, attn_mask=tp.to_tensor(np.ones((128, 128), bool)))
    jq = jp.to_tensor(x)
    ref = jp.nn.functional.scaled_dot_product_attention(jq, jq, jq,
                                                        dropout_p=0.5)
    _close(a.numpy(), ref.numpy(), "dropout_p ignored")
    _close(b.numpy(), ref.numpy(), "all-true mask")
