"""The port's paddle-style ``nn.Layer`` and layers against the JAX
package's.

Each layer is built in both packages, the JAX weights are carried into
the port by ``set_state_dict`` (numpy arrays under Paddle's names), and
both get the same numpy input and output cotangent.  Checked: forward,
the input's and every parameter's gradient (fp32), ``state_dict`` names
and order, the ``Layer`` API (parameters, sublayers, hooks, modes,
``to``, ``ParameterList``/``LayerList``), the torch parameters a
``Layer`` registers, initializers by their distribution and dropout by
its rate and scale (the RNG streams differ).

Tolerances: forward and gradients agree to 1e-5 relative to each
tensor's scale (the same fp32 ops in another order; GELU's erf and
LayerNorm's rsqrt are each a few fp32 ulps apart between XLA and
torch).  Sample statistics are held to 5 standard errors of the
distribution (n stated per test).
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice

TOL = 1e-5


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


def _carry(jlayer, tlayer):
    """The JAX layer's weights into the port's, by name."""
    state = {n: np.asarray(p._data) for n, p in jlayer.state_dict().items()}
    tlayer.load_numpy_state(state)


def _run(pkg, layer, x, cot, grad_x=True):
    xt = pkg.to_tensor(x, stop_gradient=not grad_x)
    out = layer(xt)
    out.backward(pkg.to_tensor(cot))
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    return out.numpy(), (xt.grad.numpy() if grad_x else None), grads


@pytest.mark.parametrize("make,shape,grad_x", [
    (lambda nn: nn.Linear(8, 6), (3, 5, 8), True),
    (lambda nn: nn.Linear(8, 6, bias_attr=False), (4, 8), True),
    (lambda nn: nn.LayerNorm(8), (3, 5, 8), True),
    (lambda nn: nn.LayerNorm([4, 8], epsilon=1e-12), (3, 4, 8), True),
    (lambda nn: nn.GELU(), (3, 8), True),
    (lambda nn: nn.GELU(approximate=True), (3, 8), True),
    (lambda nn: nn.Tanh(), (3, 8), True),
    (lambda nn: nn.ReLU(), (3, 8), True),
    (lambda nn: nn.Embedding(11, 6), (3, 5), False),
    (lambda nn: nn.Embedding(11, 6, padding_idx=2), (3, 5), False),
])
def test_layer_forward_and_grads_match_jax(make, shape, grad_x):
    rng = np.random.default_rng(0)
    jp.seed(1)
    jl, tl = make(jp.nn), make(tp.nn)
    _carry(jl, tl)
    if grad_x:
        x = rng.standard_normal(shape).astype(np.float32)
    else:
        x = rng.integers(0, 11, shape).astype(np.int64)
        x[0, 0] = 2          # the padding row, where there is one
    jout = jl(jp.to_tensor(x))
    cot = rng.standard_normal(jout.shape).astype(np.float32)
    (jo, jgx, jg), (to, tgx, tg) = (_run(jp, jl, x, cot, grad_x),
                                    _run(tp, tl, x, cot, grad_x))
    _close(to, jo, "forward")
    if grad_x:
        _close(tgx, jgx, "input grad")
    assert list(tg) == list(jg)
    for n in jg:
        _close(tg[n], jg[n], n)


def _encoder(nn):
    layer = nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                       activation="gelu")
    return nn.TransformerEncoder(layer, 2, norm=nn.LayerNorm(16))


def test_state_dict_names_order_and_torch_registration_match_jax():
    jp.seed(0)
    jm, tm = _encoder(jp.nn), _encoder(tp.nn)
    names = list(jm.state_dict())
    assert list(tm.state_dict()) == names
    assert [n for n, _ in tm.named_parameters()] == names
    # the torch parameters sit under the same names, in the same order,
    # and are the wrappers' own tensors
    tnamed = list(torch.nn.Module.named_parameters(tm))
    assert [n for n, _ in tnamed] == names
    assert all(t is w._data for (_, t), w in zip(tnamed, tm.parameters()))
    assert [type(l).__name__ for l in tm.sublayers()] == \
        [type(l).__name__ for l in jm.sublayers()]
    _carry(jm, tm)
    for n, p in tm.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), np.asarray(
            jm.state_dict()[n]._data), err_msg=n)


def test_encoder_layers_start_equal_as_in_jax():
    """The JAX ``TransformerEncoder`` deep-copies its first layer, so all
    layers start from the same weights; the port copies that."""
    tp.seed(0)
    jp.seed(0)
    for m in (_encoder(tp.nn), _encoder(jp.nn)):
        sd = {n: np.asarray(p.numpy() if hasattr(p, "numpy") else p)
              for n, p in m.state_dict().items()}
        for n in sd:
            if n.startswith("layers.0."):
                np.testing.assert_array_equal(
                    sd[n], sd[n.replace("layers.0.", "layers.1.")])


def test_layer_api():
    net = tp.nn.LayerList([tp.nn.Linear(4, 4), tp.nn.Dropout(0.5)])
    assert len(net) == 2 and isinstance(net[0], tp.nn.Linear)
    assert net.training and net[1].training
    net.eval()
    assert not net[1].training
    net.train()
    assert net[1].training
    seen = []
    h1 = net[0].register_forward_pre_hook(
        lambda layer, inputs: (inputs[0] * 2.0,))
    h2 = net[0].register_forward_post_hook(
        lambda layer, inputs, out: seen.append(out.shape) or out * 0.0)
    x = tp.to_tensor(np.ones((2, 4), np.float32))
    out = net[0](x)
    assert seen == [[2, 4]] and float(np.abs(out.numpy()).max()) == 0.0
    h1.remove()
    h2.remove()
    ref = x.numpy() @ net[0].weight.numpy() + net[0].bias.numpy()
    np.testing.assert_allclose(net[0](x).numpy(), ref, rtol=1e-6)
    # to(dtype) casts in place: each parameter stays the same object
    w = net[0].weight._data
    net.to(dtype="bfloat16")
    assert net[0].weight._data is w and w.dtype == torch.bfloat16
    # create_parameter with a ParamAttr; a Parameter assigned registers
    layer = tp.nn.Layer()
    attr = tp.ParamAttr(initializer=tp.nn.initializer.Constant(0.5),
                        learning_rate=0.1, need_clip=False)
    layer.p = layer.create_parameter([3], attr=attr)
    assert [n for n, _ in torch.nn.Module.named_parameters(layer)] == ["p"]
    assert layer.p._data.optimize_attr == {"learning_rate": 0.1}
    assert layer.p._data.need_clip is False
    np.testing.assert_array_equal(layer.p.numpy(), [0.5] * 3)
    plist = tp.nn.ParameterList([layer.p])
    assert len(plist) == 1 and plist[0] is layer.p
    missing, unexpected = layer.set_state_dict({"q": np.zeros(3)})
    assert missing == ["p"] and unexpected == ["q"]
    with pytest.raises(ValueError, match="shape"):
        layer.set_state_dict({"p": np.zeros(4)})
    with pytest.raises(KeyError):
        layer.load_numpy_state({})


def _sample(pkg, init, shape=(256, 256)):
    return np.asarray(init(shape, pkg.float32 if pkg is tp else "float32")
                      if pkg is tp else init(shape, np.float32), np.float64)


@pytest.mark.parametrize("name,args,mean,std,bounds", [
    ("Normal", (0.5, 2.0), 0.5, 2.0, None),
    ("Uniform", (-3.0, 1.0), -1.0, 4 / math.sqrt(12), (-3.0, 1.0)),
    ("XavierUniform", (), 0.0, math.sqrt(6 / 512) / math.sqrt(3),
     (-math.sqrt(6 / 512), math.sqrt(6 / 512))),
    ("XavierNormal", (), 0.0, math.sqrt(2 / 512), None),
    ("KaimingNormal", (), 0.0, math.sqrt(2 / 256), None),
    ("KaimingUniform", (), 0.0, math.sqrt(6 / 256) / math.sqrt(3),
     (-math.sqrt(6 / 256), math.sqrt(6 / 256))),
    ("TruncatedNormal", (0.0, 1.0, -2.0, 2.0), 0.0, 0.8796, (-2.0, 2.0)),
])
def test_initializers_have_the_jax_distribution(name, args, mean, std,
                                                bounds):
    """65,536 samples each: the mean within 5 standard errors
    (5 · std / 256) and the std within 2 % of the distribution's (JAX's
    samples are held to the same), all inside the bounds."""
    tp.seed(0)
    jp.seed(0)
    for pkg in (jp, tp):
        init = getattr(pkg.nn.initializer, name)(*args)
        data = init((256, 256), np.float32 if pkg is jp else torch.float32)
        x = np.asarray(data.numpy() if hasattr(data, "numpy") and pkg is tp
                       else data, np.float64)
        assert abs(x.mean() - mean) < 5 * std / 256, (pkg.__name__, name)
        assert abs(x.std() - std) < 0.02 * std, (pkg.__name__, name)
        if bounds is not None:
            assert bounds[0] <= x.min() and x.max() <= bounds[1]


def test_constant_and_assign_initializers_match_jax():
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    for init in ("Constant", "Assign"):
        arg = 0.25 if init == "Constant" else v
        j = np.asarray(getattr(jp.nn.initializer, init)(arg)((2, 3),
                                                             np.float32))
        t = getattr(tp.nn.initializer, init)(arg)((2, 3), torch.bfloat16)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), j)


@pytest.mark.parametrize("p,axis,mode", [(0.1, None, "upscale_in_train"),
                                         (0.5, None, "upscale_in_train"),
                                         (0.3, 1, "upscale_in_train"),
                                         (0.25, None, "downscale_in_infer")])
def test_dropout_rate_and_scale_as_in_jax(p, axis, mode):
    """Rate: the share of zeros over 65,536 draws (rows for ``axis``)
    within 5 standard errors of ``p``, in both packages; scale: every
    kept element is ``x / (1 - p)`` (``x`` in downscale_in_infer) in the
    input's dtype, equal to JAX's: in bf16 both divide by 1 - p rounded
    to bf16 (jnp's weak float), which is 2^-9 off for p = 0.1, then
    round once; eval is the identity."""
    x = np.random.default_rng(0).uniform(1, 2, (256, 256)).astype(np.float32)
    scale = 1.0 / (1 - p) if mode == "upscale_in_train" else 1.0
    kept_values = {}
    for pkg in (jp, tp):
        layer = pkg.nn.Dropout(p, axis=axis, mode=mode)
        for dtype in ("float32", "bfloat16"):
            xt = pkg.to_tensor(x).astype(dtype)
            out = np.asarray(layer(xt).numpy(), np.float64)
            assert layer(xt).dtype == xt.dtype
            zeros = out == 0
            if axis is not None:      # whole columns dropped together
                assert (zeros == zeros[:1]).all()
                zeros = zeros[0]
            n = zeros.size
            assert abs(zeros.mean() - p) < 5 * math.sqrt(p * (1 - p) / n)
            ref = np.asarray(xt.numpy(), np.float64) * scale
            kept = out != 0
            # fp32: 1e-6; bf16: the rounded divisor (2^-9) and one bf16 ulp
            np.testing.assert_allclose(out[kept], ref[kept], rtol=1e-6
                                       if dtype == "float32" else 2 ** -7)
            kept_values.setdefault(dtype, []).append(
                np.where(kept, out, np.nan))
        layer.eval()
        np.testing.assert_array_equal(layer(pkg.to_tensor(x)).numpy(), x)
    # where both packages kept an element, they scaled it to the same bits
    for dtype, (j, t) in kept_values.items():
        both = ~np.isnan(j) & ~np.isnan(t)
        np.testing.assert_array_equal(t[both], j[both], err_msg=dtype)
