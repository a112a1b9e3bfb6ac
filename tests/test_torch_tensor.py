"""The port's paddle-style ``Tensor`` against the JAX package's.

Both packages get the same numpy data.  Checked: ``to_tensor``'s
default dtypes, binary-op dtype promotion (jnp's weak Python scalars and
rank-blind tensor promotion, where plain torch differs), values,
``stop_gradient``, ``.grad`` accumulation over backward calls and
``clear_grad``, ``paddle.grad``, hooks, indexing and ``set_value``, and
the seeded samplers (by their distribution: the RNG streams differ).

Tolerances: fp32 values agree to 1e-6 relative (one or two fp32 ops
on the same inputs); bf16/fp16 values to one ulp of their dtype (both
compute the op in fp32 and round once, but XLA and torch may round an
intermediate at another place).  With x64 off, JAX stores int64 data as
int32: integer dtypes are compared by kind, the port keeps Paddle's
int64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True)
def cpu_device():
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _kind(dtype):
    name = str(dtype).replace("torch.", "")
    return "int" if name.startswith(("int", "uint")) else name


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t, np.float64)


def test_to_tensor_defaults_match_jax():
    cases = [1.5, [1.0, 2.0], np.arange(3, dtype=np.float64),
             np.ones(2, np.float32), [1, 2], True, [True, False]]
    for data in cases:
        assert _kind(tp.to_tensor(data).dtype) == _kind(
            jp.to_tensor(data).dtype), data
    assert tp.to_tensor([1, 2]).dtype == torch.int64      # Paddle's int64
    assert tp.to_tensor([1.0]).dtype == torch.float32     # not float64
    t = tp.to_tensor(np.ones(2, np.float64), dtype="bfloat16")
    assert t.dtype == torch.bfloat16 and t.shape == [2]
    assert tp.to_tensor([1.0]).stop_gradient
    assert not tp.to_tensor([1.0], stop_gradient=False).stop_gradient
    # JAX's bf16 numpy arrays (ml_dtypes) come across as bf16
    src = np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))
    assert tp.to_tensor(src).dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.to_tensor(src).numpy(), [1.5, -2.25])


_A = np.array([[0.5, -1.25, 3.0], [2.0, 0.75, -0.5]], np.float32)
_B = np.array([[1.5, 2.0, -0.25], [0.5, -3.0, 1.0]], np.float32)


def _pair(pkg, a_dtype, b):
    a = pkg.to_tensor(_A, dtype=a_dtype)
    if isinstance(b, tuple):                       # (array, dtype)
        b = pkg.to_tensor(b[0], dtype=b[1])
    return a, b


@pytest.mark.parametrize("a_dtype,b,op", [
    ("bfloat16", 2.0, "mul"),                 # weak float scalar: bf16
    ("bfloat16", 3, "add"),                   # weak int scalar: bf16
    ("float16", 0.5, "sub"),
    ("bfloat16", 2.0, "rsub"),
    ("bfloat16", (np.float32(2.0), "float32"), "mul"),   # 0-d fp32: fp32
    ("bfloat16", (_B, "float16"), "add"),     # bf16 + fp16: fp32
    ("int64", 2.5, "mul"),                    # int x weak float: fp32
    ("int64", (_B, "bfloat16"), "add"),       # int + bf16: bf16
    ("int64", (np.array([2, 3, 4]), "int64"), "truediv"),  # int / int: fp32
    ("float32", (_B, "bfloat16"), "matmul_t"),
    ("bfloat16", (_B, "float32"), "truediv"),
    ("float32", 2, "pow"),
])
def test_binary_promotion_and_values_match_jax(a_dtype, b, op):
    fns = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y, "rsub": lambda x, y: y - x,
           "truediv": lambda x, y: x / y, "pow": lambda x, y: x ** y,
           "matmul_t": lambda x, y: x @ y.T}
    ja, jb = _pair(jp, a_dtype, b)
    ta, tb = _pair(tp, a_dtype, b)
    jout, tout = fns[op](ja, jb), fns[op](ta, tb)
    assert _kind(tout.dtype) == _kind(jout.dtype), (tout.dtype, jout.dtype)
    ref = _np(jout)
    ulp = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}.get(
        _kind(tout.dtype), 1e-6)
    np.testing.assert_allclose(_np(tout), ref, rtol=ulp,
                               atol=ulp * np.abs(ref).max())


def test_plain_torch_would_differ_where_the_port_follows_jnp():
    # the case the port fixes: a 0-d fp32 tensor times a bf16 tensor
    a = torch.ones(3, dtype=torch.bfloat16)
    assert (a * torch.tensor(2.0)).dtype == torch.bfloat16
    assert (tp.to_tensor(a) * tp.to_tensor(2.0)).dtype == torch.float32


def test_stop_gradient_matches_jax():
    for pkg in (jp, tp):
        x = pkg.to_tensor(_A, stop_gradient=False)
        c = pkg.to_tensor(_B)
        assert not x.stop_gradient and c.stop_gradient
        assert not (x * c).stop_gradient
        assert (c * 2.0).stop_gradient
        assert x.detach().stop_gradient
        with pkg.no_grad():
            assert (x * c).stop_gradient
        c.stop_gradient = False
        assert not (c + 1.0).stop_gradient
        assert x.astype("int32").stop_gradient     # no grad through ints


def _grads(pkg):
    x = pkg.to_tensor(_A, stop_gradient=False)
    w = pkg.to_tensor(_B)
    g = pkg.to_tensor(np.full_like(_A, 0.5))
    (x * x * w).backward(g)
    first = x.grad.numpy().copy()
    (x * w).backward(g)                       # accumulates into .grad
    second = x.grad.numpy().copy()
    x.clear_grad()
    cleared = x.grad
    (x * 3.0).backward(g)
    return first, second, cleared, x.grad.numpy()


def test_grad_accumulates_until_clear_grad_as_in_jax():
    for j, t in zip(_grads(jp), _grads(tp)):
        if j is None:
            assert t is None
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6)


def test_paddle_grad_and_hooks_match_jax():
    out = {}
    for name, pkg, grad in (("jax", jp, jp.grad), ("torch", tp, tp.grad)):
        x = pkg.to_tensor(_A, stop_gradient=False)
        y = pkg.to_tensor(_B, stop_gradient=False)
        h = x * y
        h.register_hook(lambda g: g * 2.0)
        z = h * h
        gx, gy = grad([z], [x, y], grad_outputs=[pkg.to_tensor(
            np.ones_like(_A))])
        assert x.grad is None and y.grad is None   # grad() leaves .grad
        out[name] = (gx.numpy(), gy.numpy())
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_indexing_set_value_and_conversions_match_jax():
    res = {}
    for name, pkg in (("jax", jp), ("torch", tp)):
        x = pkg.to_tensor(_A, stop_gradient=False)
        y = x[:, 1:] * 2.0
        y[0, 0] = 7.0
        res[name] = (y.numpy(), x.shape, y.item(1, 1),
                     x.astype("bfloat16").numpy(), x.clone().numpy())
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-6)
    p = tp.Parameter(torch.zeros(2, 3))
    data = p._data
    p.set_value(_A)
    assert p._data is data and isinstance(data, torch.nn.Parameter)
    np.testing.assert_array_equal(p.numpy(), _A)
    with pytest.raises(ValueError, match="shape"):
        p.set_value(np.zeros(3))
    assert isinstance(p.shape, list) and p.trainable and not p.stop_gradient


def test_setitem_on_a_graph_tensor_keeps_the_graph_unlike_jax():
    """Reference fault (ROADMAP.md C): the JAX ``__setitem__`` rebinds the
    tensor to a node whose parent is the tensor itself, so the backward
    never reaches what came before it and ``x.grad`` stays None.  Paddle
    (and the port) keep the graph: the set element gets no gradient, the
    others 2 (from ``* 2.0``)."""
    grads = {}
    for name, pkg in (("jax", jp), ("torch", tp)):
        x = pkg.to_tensor(_A, stop_gradient=False)
        y = x[:, 1:] * 2.0
        y[0, 0] = 7.0
        y.backward(pkg.to_tensor(np.ones((2, 2), np.float32)))
        grads[name] = x.grad
    assert grads["jax"] is None
    np.testing.assert_array_equal(grads["torch"].numpy(),
                                  [[0, 0, 2], [0, 2, 2]])


def test_seeded_samplers_repeat_and_have_their_distribution():
    tp.seed(3)
    a = tp.randn([4096])
    u = tp.rand([4096])
    tp.seed(3)
    np.testing.assert_array_equal(tp.randn([4096]).numpy(), a.numpy())
    np.testing.assert_array_equal(tp.rand([4096]).numpy(), u.numpy())
    # N(0, 1) and U[0, 1): 4096 samples, means within 5 standard errors
    assert abs(a.numpy().mean()) < 5 / 64 and abs(a.numpy().std() - 1) < 0.05
    assert 0 <= u.numpy().min() and u.numpy().max() < 1
    assert abs(u.numpy().mean() - 0.5) < 5 * 0.289 / 64
    r = tp.randint(2, 9, [4096])
    assert r.dtype == torch.int64 and set(np.unique(r.numpy())) == set(
        range(2, 9))
    b = tp.bernoulli(tp.to_tensor(np.full(4096, 0.25, np.float32)))
    assert b.dtype == torch.float32 and abs(b.numpy().mean() - 0.25) < 0.035
    n = tp.normal(1.0, 2.0, [4096]).numpy()
    assert abs(n.mean() - 1) < 5 * 2 / 64 and abs(n.std() - 2) < 0.1
    state = tp.get_rng_state()
    x = tp.uniform([8], min=-2.0, max=2.0).numpy()
    tp.set_rng_state(state)
    np.testing.assert_array_equal(tp.uniform([8], min=-2.0, max=2.0)
                                  .numpy(), x)
    assert -2 <= x.min() and x.max() < 2
