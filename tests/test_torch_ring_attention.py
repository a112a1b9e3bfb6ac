"""Ring attention of the port (``paddle_tpu_torch/kernels/ring_attention.py``)
against the JAX package's (``paddle_tpu/kernels/ring_attention.py``).

Two spawns of gloo ranks (``tests/_torch_mesh_workers.py`` ``ring_sep``,
sep 2 and sep 4) start together; meanwhile the JAX ring runs here on a
``sep`` mesh of the 8 virtual CPU devices, on the same fp32 q/k/v.  Each
rank holds its chunk of the sequence; the loss is ``sum(o**2)`` over the
whole sequence.  Tolerances are the JAX ring test's
(``tests/test_ring_attention.py:61-67``): the output within atol 2e-5,
the q/k/v gradients within atol 2e-4.

* B 2, S 32, 2 heads of 8, causal and not, at sep 2 and sep 4: chunks
  of 16 and 8 tokens take the plain chunk math in both packages;
* S 256 over sep 2 (128-token chunks): the port's chunk route is
  ``flash_attention_with_lse`` with its LSE-cotangent backward (the
  plain versions of K1–K3 on the CPU), the JAX ring's is its Pallas
  kernel in interpret mode;
* the control, each rank attending within its own chunk (a ring that
  does not rotate), must miss the output bound;
* at sep 1 the ring is ``flash_attention_fwd``, bit for bit.
"""

import datetime

import numpy as np
import pytest
import torch

import _torch_mesh_workers as W

OUT_ATOL, GRAD_ATOL = 2e-5, 2e-4


def _cases(S, D, seed, causals=(True, False)):
    rng = np.random.default_rng(seed)
    shape = (2 if S < 128 else 1, S, 2, D)
    qkv = {n: rng.normal(size=shape).astype(np.float32) for n in "qkv"}
    return {f"S{S}_{'causal' if c else 'full'}": {**qkv, "causal": c}
            for c in causals}


def _jax_ring(case, sep, interpret=False):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from paddle_tpu.kernels import flash_attention as fa
    from paddle_tpu.kernels.ring_attention import ring_attention
    mesh = Mesh(np.array(jax.devices()[:sep]), ("sep",))

    def loss(q, k, v):
        o = ring_attention(q, k, v, causal=case["causal"], mesh=mesh)
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    args = [jnp.asarray(case[n]) for n in "qkv"]
    fa._INTERPRET[0] = interpret
    try:
        with mesh:
            (_, o), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(*args)
    finally:
        fa._INTERPRET[0] = False
    return {"o": np.asarray(o), **{f"d{n}": np.asarray(t)
                                   for n, t in zip("qkv", g)}}


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    sep2 = {**_cases(32, 8, 0), **_cases(256, 64, 3, (True,))}
    sep4 = _cases(32, 8, 1)
    spawned = {2: W.spawn("ring_sep", 2, tmp, {"cases": sep2}),
               4: W.spawn("ring_sep", 4, tmp, {"cases": sep4})}
    want = {(2, n): _jax_ring(c, 2, interpret=c["q"].shape[1] == 256)
            for n, c in sep2.items()}
    want.update({(4, n): _jax_ring(c, 4) for n, c in sep4.items()})
    got = {sep: s.results() for sep, s in spawned.items()}
    return want, got


def _gathered(ranks, name, key):
    return np.concatenate([r[name][key] for r in ranks], axis=1)


@pytest.mark.parametrize("sep,name", [
    (2, "S32_causal"), (2, "S32_full"), (4, "S32_causal"), (4, "S32_full"),
    (2, "S256_causal")])
def test_ring_matches_jax_ring(rings, sep, name):
    """Output and q/k/v gradients, gathered over the ranks, against the
    JAX ring on the same sep mesh; the ring shifted K/V n - 1 times a
    call forward and as many backward."""
    want, got = rings
    ranks = got[sep]
    j = want[(sep, name)]
    ring = [{k: v for k, v in r[name]["ring"].items()} for r in ranks]
    o = np.concatenate([r["o"] for r in ring], axis=1)
    np.testing.assert_allclose(o, j["o"], rtol=0, atol=OUT_ATOL)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(
            np.concatenate([r[g] for r in ring], axis=1), j[g], rtol=0,
            atol=GRAD_ATOL, err_msg=g)
    assert all(r["shifts"] == 2 * (sep - 1) for r in ring)
    # 128-token chunks take the flash route, shorter ones the plain math
    chunk = j["o"].shape[1] // sep
    calls = {True: [r + 1 for r in range(sep)], False: [sep] * sep}[
        name.endswith("causal")]
    assert [r["fallbacks"] for r in ring] == (
        [0] * sep if chunk % 128 == 0 else calls)


@pytest.mark.parametrize("sep,name", [(2, "S32_causal"), (4, "S32_full")])
def test_control_without_rotation_misses(rings, sep, name):
    """Each rank attending within its own chunk only: the output misses
    the bound the ring holds (rank 0 of a causal ring sees only its own
    chunk either way, so the miss shows on the later ranks)."""
    want, got = rings
    o = np.concatenate([r[name]["control"]["o"] for r in got[sep]], axis=1)
    assert np.abs(o - want[(sep, name)]["o"]).max() > 10 * OUT_ATOL
    assert all(r[name]["control"]["shifts"] == 0 for r in got[sep])


@pytest.fixture
def one_rank_sep():
    from paddle_tpu_torch import distributed as D
    D.init_parallel_env(backend="gloo", rank=0, world_size=1,
                        store=torch.distributed.HashStore(),
                        timeout=datetime.timedelta(seconds=60))
    try:
        yield D.build_mesh({"sep": 1})
    finally:
        D.reset_parallel_env()


@pytest.mark.parametrize("S", [32, 256])
def test_sep1_is_flash_attention_fwd(one_rank_sep, S):
    """At sep 1 (and without a mesh) the ring is ``flash_attention_fwd``:
    the same output and gradients, bit for bit."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.kernels.ring_attention import ring_attention
    case = _cases(S, 16, 5, (True,))[f"S{S}_causal"]

    def run(fn):
        q, k, v = (torch.from_numpy(case[n]).requires_grad_() for n in "qkv")
        o = fn(q, k, v)
        (o ** 2).sum().backward()
        return [o.detach(), q.grad, k.grad, v.grad]

    want = run(lambda q, k, v: flash_attention_fwd(q, k, v, causal=True))
    for mesh in (one_rank_sep, None):
        got = run(lambda q, k, v: ring_attention(q, k, v, causal=True,
                                                 mesh=mesh))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
