"""Tensor-parallel serving of the port (``LLMEngine(mesh=...)`` over the
``StateArena``) against the JAX package's (``tests/test_serving_mesh.py``).

The JAX engines run here on the 8-device virtual mesh (unsharded and
over an ``mp`` mesh of two devices).  The port's mp2 engines run in two
spawned gloo ranks (``tests/_torch_mesh_workers.py`` ``serving_mp2``),
on the same fp32 weights (``load_numpy_state`` of the JAX model's);
each check reads its part of the ranks' results.  The port's mesh of
one rank runs here, in the pytest process, over a one-rank gloo group
that the fixture destroys after.

What is held, with its JAX counterpart:

* mp2 greedy tokens equal the unsharded JAX engine's and the JAX mp2
  mesh engine's, request for request (fp32: the row-parallel partial
  sums add in another order, which moves no argmax of this model), for
  the paged layout, int8 KV with int8 weights, and the slot layout
  (``test_mp2_token_identity_greedy_and_seeded``,
  ``test_mp2_int8_engine_token_identity``).  Seeded sampling is held
  to the port's own unsharded engine: the port draws from
  ``torch.Generator`` streams, not JAX keys, so sampled tokens are not
  comparable across the packages (``serving/sampling.py``);
* the KV pool's head axis splits: shard shape, per-rank KV bytes half
  the unsharded figure, weight bytes below it
  (``test_mp2_per_chip_bytes_halve_kv_pool``);
* indivisible heads (3 over mp 2) degrade to replicated, count
  ``serving.mesh.spec_degraded`` and keep the tokens
  (``test_indivisible_heads_degrade_to_replicated_and_stay_identical``);
* ``sharded_paged_decode_attention`` on two ranks equals
  ``paged_decode_attention`` on the whole pool, bf16 and int8, and the
  JAX kernel's plain version;
* a mesh of one rank is bit-identical to no mesh, with the same
  counters (``test_mesh1_int8_engine_bit_identical_with_counter_parity``).

``deadline_s`` at mp2 (rank 0's clock decides) is held in
``tests/test_torch_mesh_fleet_control.py``.

The paged engine's extras on a mesh (speculative decoding, LoRA, the
host-RAM tier, KV migration, the fleet) are held in
``tests/test_torch_mesh_serving_extras.py``.
"""

import datetime

import numpy as np
import pytest
import torch

import _torch_mesh_workers as W

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3, use_flash_attention=False)
CFG3 = dict(CFG, num_heads=3, hidden_size=24)
PROMPTS = [[5, 9, 11], [7, 3], [5, 9, 2, 4]]
SAMPLE = dict(do_sample=True, temperature=0.9, top_k=8)
ENGINE = dict(max_slots=3, max_seq_len=32, min_bucket=4, block_size=4,
              prefill_chunk=8)
PARITY = ("serving.requests", "serving.prefill_batches",
          "serving.decode_steps", "serving.decode_tokens",
          "serving.kv.prefill_chunks", "serving.kv.quant.prefill_tokens",
          "serving.kv.quant.decode_tokens")



@pytest.fixture(autouse=True, scope="module")
def _clear_jax_registries():
    """The JAX engines and steps here fill the JAX package's global
    registries (histograms, flight, traces, device time): cleared after
    the module, so later tests in this process start from nothing."""
    yield
    from paddle_tpu.profiler import devicetime, flight, metrics, trace
    metrics.reset_metrics()
    flight.clear()
    trace.clear()
    devicetime.reset()

def _jax_model(cfg, seed):
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    jp.seed(seed)
    m = GPTForCausalLM(GPTConfig(**cfg))
    m.eval()
    return m, {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _jax_run(m, mesh=None, **kw):
    from paddle_tpu.serving import LLMEngine
    kw.setdefault("kv_layout", "paged")
    eng = LLMEngine(m, mesh=mesh, **ENGINE, **kw)
    hs = [eng.add_request(p, max_new_tokens=5, seed=21 + i)
          for i, p in enumerate(PROMPTS)]
    while not all(h.is_finished for h in hs):
        eng.step()
    return [list(map(int, h.tokens)) for h in hs]


def _pa_case():
    rng = np.random.default_rng(4)
    B, nh, hd, nb, bs = 3, 4, 16, 9, 4
    return {"q": rng.standard_normal((B, nh, hd)).astype(np.float32),
            "k": rng.standard_normal((nb, bs, nh, hd)).astype(np.float32),
            "v": rng.standard_normal((nb, bs, nh, hd)).astype(np.float32),
            "bt": np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32),
            "pos": np.array([9, 5, 11], np.int32), "scale": 0.25}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import jax
    from jax.sharding import Mesh
    jm, state = _jax_model(CFG, 0)
    jm3, state3 = _jax_model(CFG3, 3)
    pl = {"cfg": CFG, "state": state, "cfg3": CFG3, "state3": state3,
          "prompts": PROMPTS, "sample": SAMPLE, "pa": _pa_case()}
    ranks = W.spawn("serving_mp2", 2, tmp_path_factory.mktemp("serve"), pl)
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("mp",))
    jax_out = {
        "greedy": _jax_run(jm),
        "greedy_mp2": _jax_run(jm, mesh=mesh2),
        "int8_greedy": _jax_run(jm, kv_dtype="int8", weight_dtype="int8"),
        "indiv_greedy": _jax_run(jm3),
    }
    return pl, jax_out, ranks.results()


def test_mp2_token_identity_greedy_and_seeded(served):
    _, j, res = served
    assert j["greedy"] == j["greedy_mp2"]
    for out in res:
        assert out["greedy"] == j["greedy"]
        assert out["sampled"] == out["sampled_single"]
        assert out["shard_shape"] == (2, out["shard_shape"][1], 4, 2, 8)
        assert out["kv_head_axis"] and out["mesh_tag"] == "[mp2]"
        # the collectives are the host's own, and they ran
        assert out["collectives"] > 0
    assert res[0]["sampled"] == res[1]["sampled"]


def test_mp2_ranks_choose_the_same_tokens_before_the_broadcast(served):
    """Every rank's own greedy pick equals rank 0's (the gathered logits
    agree), so the broadcast replaced nothing; a token only rank 1 would
    choose is counted on rank 1 alone."""
    _, _, res = served
    assert [out["disagreements"] for out in res] == [[0, 0], [0, 1]]


def test_mp2_int8_engine_token_identity(served):
    _, j, res = served
    for out in res:
        assert out["int8_greedy"] == j["int8_greedy"]
        assert out["int8_sampled"] == out["int8_sampled_single"]


def test_mp2_slot_layout_token_identity(served):
    """The slot layout at mp2 gives the unsharded JAX engine's greedy
    tokens (the layouts agree on this model: the JAX slot engine gives
    them too, in ``tests/test_torch_slots.py``'s terms)."""
    _, j, res = served
    for out in res:
        assert out["slots_greedy"] == j["greedy"]


def test_mp2_model_built_under_the_mesh_serves_its_shards(served):
    """``GPTForCausalLM`` built under the mesh holds its shards (the
    vocabulary-split embedding of training); the engine serves them as
    they are, with the same tokens."""
    _, j, res = served
    for out in res:
        assert out["split_model_greedy"] == j["greedy"]
        wte, pool = out["split_model_shapes"]
        assert wte == (32, 32) and pool[3] == 2


def test_mp2_model_built_under_the_mesh_serves_int8(served):
    """The int8 engine over a model built under the mesh: the
    row-parallel weights' per-output-channel scales come from the whole
    input dimension, as the unsharded quantization's do, so the tokens
    are the unsharded JAX int8 engine's."""
    _, j, res = served
    for out in res:
        assert out["split_model_int8_leaves_differ"] == []
        assert out["split_model_int8_greedy"] == j["int8_greedy"]


def test_mp2_per_chip_bytes_halve_kv_pool(served):
    _, _, res = served
    for out in res:
        (kv2, w2), (kv1, w1) = out["bytes"], out["bytes_single"]
        assert kv2 * 2 == kv1
        assert w2 < w1      # matrices split; norms and biases replicate


def test_indivisible_heads_degrade_to_replicated_and_stay_identical(served):
    _, j, res = served
    for out in res:
        assert out["indiv_degraded"] >= 2
        assert not out["indiv_head_axis"]
        assert out["indiv_shape"][3] == 3
        assert out["indiv_greedy"] == j["indiv_greedy"]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_sharded_paged_decode_attention_equals_whole_pool(served, kind):
    """Each rank's K4 (K4q) call on its two heads, gathered, equals the
    call over all four heads bit for bit (the heads are independent),
    and the JAX ``sharded_paged_decode_attention`` over a 2-device
    ``mp`` mesh (its Pallas kernel in interpret mode) within the
    dtype's rounding (bf16: 2^-7 of the values' scale; int8: 1e-5)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from paddle_tpu.kernels import paged_attention as jpa
    pl, _, res = served
    a = pl["pa"]
    cast = (lambda x: jnp.asarray(x, jnp.bfloat16)) if kind == "bf16" \
        else jnp.asarray
    q, k, v = (cast(a[n]) for n in ("q", "k", "v"))
    extra = ()
    if kind == "int8":
        (k, ks), (v, vs) = (jpa.quantize_kv(t, "int8") for t in (k, v))
        extra = (ks, vs)
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    jpa._INTERPRET[0] = True
    try:
        want = np.asarray(jpa.sharded_paged_decode_attention(
            mesh, "mp", q, k, v, jnp.asarray(a["bt"]), jnp.asarray(a["pos"]),
            *extra, scale=a["scale"]).astype(jnp.float32))
    finally:
        jpa._INTERPRET[0] = False
    tol = 2 ** -7 if kind == "bf16" else 1e-5
    for out in res:
        got, whole = out[f"pa_{kind}"]
        np.testing.assert_array_equal(got, whole)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of one rank in this process, destroyed after."""
    from paddle_tpu_torch import distributed as D
    D.init_parallel_env(backend="gloo", rank=0, world_size=1,
                        store=torch.distributed.HashStore(),
                        timeout=datetime.timedelta(seconds=60))
    try:
        yield D.build_mesh({"mp": 1})
    finally:
        D.reset_parallel_env()


@pytest.mark.parametrize("kw", [dict(), dict(kv_dtype="int8",
                                             weight_dtype="int8"),
                                dict(kv_layout="slots")])
def test_mesh1_bit_identical_with_counter_parity(one_rank_group, kw):
    """A mesh of one rank runs the mesh code (its collectives over a
    group of one) and gives what no mesh gives: the same tokens, sampled
    ones included, and the same serving counters; its tag is empty."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.profiler import counters
    _, state = _jax_model(CFG, 0)
    D.set_mesh(None)        # a model built under a mesh holds its shards
    m = W._gpt(CFG, state)
    D.set_mesh(one_rank_group)
    m.eval()
    outs = []
    for mesh in (None, one_rank_group):
        before = counters.snapshot()
        toks = W._serve(m, PROMPTS, mesh, SAMPLE, **kw)[0]
        d = counters.delta(before)
        outs.append((toks, {k: d.get(k, 0) for k in PARITY},
                     d.get("dist.collective_launches", 0)))
    (t0, c0, n0), (t1, c1, n1) = outs
    assert t0 == t1 and c0 == c1
    assert n0 == 0 and n1 > 0


@pytest.mark.parametrize("kw", [dict(kv_layout="paged", kv_dtype="int8"),
                                dict(kv_layout="slots")])
def test_release_kv_frees_the_arenas_pools(kw):
    """A dead replica's ``release_kv`` frees its KV storage: the arena
    keeps no reference to it (the fleet's chaos gate on the card counts
    the memory a faulted fleet keeps)."""
    import gc
    import weakref
    from paddle_tpu_torch.serving import LLMEngine
    _, state = _jax_model(CFG, 0)
    eng = LLMEngine(W._gpt(CFG, state), **ENGINE, **kw)
    pools = ([eng.pool_k, eng.pool_v, *eng.scales]
             if kw["kv_layout"] == "paged" else [eng._ck, eng._cv])
    refs = [weakref.ref(t) for t in pools]
    del pools
    eng.release_kv()
    gc.collect()
    assert all(r() is None for r in refs)
