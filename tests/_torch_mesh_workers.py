"""Rank functions for the port's multi-process tests (not collected).

``tests/test_torch_distributed_api.py``, ``test_torch_mesh_serving.py``,
``test_torch_mesh_serving_extras.py``, ``test_torch_mesh_train.py``, ``test_torch_moe_mesh.py``,
``test_torch_ring_attention.py``, ``test_torch_sequence_parallel.py``,
``test_torch_cp_train.py``, ``test_torch_pp_train.py``,
``test_torch_gpt_train.py``, ``test_torch_mesh_checkpoint.py``,
``test_torch_mesh_fleet_control.py``, ``test_torch_auto_parallel.py`` and
``test_torch_launch_elastic.py`` (its ``spawn`` children) run the JAX
package in the pytest
process and the port's ranks in processes spawned here: each child
imports ``torch`` and ``paddle_tpu_torch`` only (the test files import
JAX, so the ranks' code lives in this module), joins a gloo group
through a ``FileStore`` under the test's temporary directory, runs one
function of this module and sends its result back as numpy arrays and
plain Python values.  Every child resets the port's global mesh and
destroys its process group when its function returns.

:func:`spawn` starts the ranks and returns at once, so the pytest
process computes the JAX side while they run; ``.results()`` joins
them (a rank that fails makes every result raise, with its traceback).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue as _queue
import time
import traceback

import numpy as np
import torch

TIMEOUT_S = 240


class Spawned:
    def __init__(self, target, world, tmpdir, payload):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        self.world = world
        base = os.path.join(str(tmpdir), f"{target}_{world}")
        store = base + ".store"
        # the payload goes through a file: a large argument would block
        # each start() until its child has imported torch
        with open(base + ".payload", "wb") as f:
            pickle.dump(payload, f)
        self.procs = [ctx.Process(target=_child, args=(
            target, r, world, store, base + ".payload", self.q), daemon=True)
            for r in range(world)]
        for p in self.procs:
            p.start()
        self._out = None

    def results(self):
        """Per-rank results, rank order."""
        if self._out is None:
            got, errors = {}, []
            deadline = time.monotonic() + TIMEOUT_S
            while len(got) < self.world and not errors:
                try:
                    rank, status, value = self.q.get(timeout=2)
                except _queue.Empty:
                    dead = [p.exitcode for p in self.procs
                            if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        errors.append(f"ranks exited {dead} or timed out "
                                      f"after {TIMEOUT_S} s (results from "
                                      f"{sorted(got)})")
                    continue
                if status == "ok":
                    got[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
            for p in self.procs:
                p.join(timeout=30 if not errors else 1)
                if p.is_alive():
                    p.terminate()
                    p.join()
            self._out = (got, errors)
        got, errors = self._out
        if errors:
            raise RuntimeError("\n".join(errors))
        return [got[r] for r in range(self.world)]


def spawn(target, world, tmpdir, payload):
    return Spawned(target, world, tmpdir, payload)


def _child(target, rank, world, store, payload_path, q):
    torch.set_num_threads(1)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    paddle.set_device("cpu")
    try:
        D.init_parallel_env(backend="gloo", rank=rank, world_size=world,
                            init_method="file://" + store,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out = globals()[target](rank, world, payload)
        q.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 — reported to the pytest process
        q.put((rank, "error", traceback.format_exc()))
    finally:
        from paddle_tpu_torch.distributed import fleet
        fleet._reset()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _np(t):
    t = t._data if hasattr(t, "_data") else t
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _gpt(cfg, state, device="cpu"):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    m = GPTForCausalLM(GPTConfig(**cfg), device=device)
    m.load_numpy_state(state)
    return m


def _serve(model, prompts, mesh=None, sampled=None, **kw):
    from paddle_tpu_torch.serving import LLMEngine
    kw.setdefault("kv_layout", "paged")
    eng = LLMEngine(model, mesh=mesh, **{
        "max_slots": 3, "max_seq_len": 32, "min_bucket": 4,
        "block_size": 4, "prefill_chunk": 8, **kw})
    hs = [eng.add_request(p, max_new_tokens=5, seed=21 + i,
                          **(sampled or {}))
          for i, p in enumerate(prompts)]
    n = 0
    while not all(h.is_finished for h in hs):
        eng.step()
        n += 1
        assert n < 300, "engine did not converge"
    return [list(map(int, h.tokens)) for h in hs], eng


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is the result
        return f"{type(e).__name__}: {e}"
    return None


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_serving.py
# ---------------------------------------------------------------------------

def serving_mp2(rank, world, pl):
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.profiler import counters
    from paddle_tpu_torch.serving import LLMEngine
    prompts, sample = pl["prompts"], pl["sample"]
    model = _gpt(pl["cfg"], pl["state"])
    model.eval()
    mesh = D.build_mesh({"mp": world})
    out = {}
    c0 = counters.snapshot()
    out["greedy"], eng = _serve(model, prompts, mesh)
    out["collectives"] = counters.delta(c0).get("dist.collective_launches", 0)
    st = eng.stats()
    out["shard_shape"] = eng.arena.shard_shape("pool_k")
    out["kv_head_axis"] = eng.arena.kv_head_axis
    out["mesh_tag"] = st["mesh_tag"]
    out["disagreements"] = [st["rank_disagreements"]]
    # a token only this rank would choose: rank 0's broadcast replaces it
    # and the engine counts it
    eng._agree(torch.tensor([7, 100 + rank]))
    out["disagreements"].append(eng.stats()["rank_disagreements"])
    out["bytes"] = (st["kv_pool_bytes_per_chip"],
                    st["weight_bytes_per_chip"])
    single = _serve(model, prompts[:1])[1].stats()
    out["bytes_single"] = (single["kv_pool_bytes_per_chip"],
                           single["weight_bytes_per_chip"])
    out["sampled"] = _serve(model, prompts, mesh, sample)[0]
    out["sampled_single"] = _serve(model, prompts, None, sample)[0]
    q8 = dict(kv_dtype="int8", weight_dtype="int8")
    out["int8_greedy"], e8 = _serve(model, prompts, mesh, **q8)
    out["int8_sampled"] = _serve(model, prompts, mesh, sample, **q8)[0]
    out["int8_sampled_single"] = _serve(model, prompts, None, sample,
                                        **q8)[0]
    out["slots_greedy"] = _serve(model, prompts, mesh,
                                 kv_layout="slots")[0]
    # a model built under the mesh holds its shards already (the
    # training placements: vocabulary-split embedding); the arena keeps
    # them
    split = _gpt(pl["cfg"], pl["state"])
    split.eval()
    out["split_model_greedy"], e = _serve(split, prompts, mesh)
    out["split_model_shapes"] = (tuple(split.wte.shape),
                                 e.arena.shard_shape("pool_k"))
    out["split_model_int8_greedy"], s8 = _serve(split, prompts, mesh, **q8)
    # the int8 leaves the split model's engine holds, against the shards
    # the arena cut from the whole model's int8 tree
    out["split_model_int8_leaves_differ"] = sorted(
        k for k, v in s8._w["lws"].items()
        if v is not None and not torch.equal(v, e8._w["lws"][k]))
    # indivisible heads: nh=3 over mp=2
    m3 = _gpt(pl["cfg3"], pl["state3"])
    m3.eval()
    before = counters.get("serving.mesh.spec_degraded")
    out["indiv_greedy"], e3 = _serve(m3, prompts, mesh)
    out["indiv_degraded"] = counters.get("serving.mesh.spec_degraded") \
        - before
    out["indiv_head_axis"] = e3.arena.kv_head_axis
    out["indiv_shape"] = e3.arena.shard_shape("pool_k")
    # the kernel wrapper on each rank's head slice
    a = pl["pa"]
    hs = a["q"].shape[1] // world
    sl = slice(rank * hs, (rank + 1) * hs)
    for kind in ("bf16", "int8"):
        q = torch.from_numpy(a["q"])
        k = torch.from_numpy(a["k"])
        v = torch.from_numpy(a["v"])
        bt, pos = torch.from_numpy(a["bt"]), torch.from_numpy(a["pos"])
        if kind == "bf16":
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            args = (k, v)
        else:
            (kq, ks), (vq, vs) = (pa.quantize_kv(t, "int8") for t in (k, v))
            args = (kq, vq, bt, pos, ks, vs)
        full_args = (q,) + (args if kind == "int8" else (k, v, bt, pos))
        want = pa.paged_decode_attention(*full_args, scale=a["scale"])
        mine = pa.sharded_paged_decode_attention(
            mesh, "mp", q[:, sl].contiguous(),
            *(t[:, :, sl].contiguous() for t in full_args[1:3]),
            *full_args[3:], scale=a["scale"])
        parts = [torch.empty_like(mine) for _ in range(world)]
        torch.distributed.all_gather(parts, mine)
        out[f"pa_{kind}"] = (_np(torch.cat(parts, 1)), _np(want))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_serving_extras.py: scenarios that take the engine
# and fleet classes, so the test process runs the same ones on the JAX
# package's
# ---------------------------------------------------------------------------

EXTRAS_ENGINE = dict(kv_layout="paged", max_slots=3, max_seq_len=32,
                     min_bucket=4, block_size=4, prefill_chunk=8)
EXTRAS_TENANTS = [None, "t1", "t2", "t1"]
#: a pool of 10 blocks over two slots spills a stream of nine-token
#: prompts served twice
EXTRAS_TIER = dict(EXTRAS_ENGINE, max_slots=2, n_blocks=10,
                   host_kv_blocks=32)


def _tokens(hs):
    return [list(map(int, h.tokens)) for h in hs]


def _drive(eng, hs, limit=400):
    n = 0
    while not all(h.is_finished for h in hs):
        eng.step()
        n += 1
        assert n < limit, "engine did not converge"
    return _tokens(hs)


def extras_spec(Engine, model, draft, mesh, prompts, sampled=None, k=2):
    """Speculative greedy (or sampled) tokens and the engine."""
    eng = Engine(model, mesh=mesh, draft_model=draft, spec_k=k,
                 **EXTRAS_ENGINE)
    hs = [eng.add_request(p, max_new_tokens=5, seed=21 + i,
                          **(sampled or {}))
          for i, p in enumerate(prompts)]
    return _drive(eng, hs), eng


def extras_lora(Engine, model, mesh, prompts, factors, sampled=None):
    """Tenants t1 and t2 (two slots of rank 4) beside base rows, in one
    batch."""
    eng = Engine(model, mesh=mesh, adapter_slots=2, adapter_rank=4,
                 **EXTRAS_ENGINE)
    for t in sorted(factors):
        eng.register_adapter(t, factors[t])
    hs = [eng.add_request(p, max_new_tokens=5, seed=21 + i, adapter=t,
                          **(sampled or {}))
          for i, (p, t) in enumerate(zip(prompts, EXTRAS_TENANTS))]
    return _drive(eng, hs), eng


def extras_tier(Engine, model, mesh, stream, kv_dtype=None):
    """A stream served twice, one request at a time, through a pool that
    spills (pass 2 restores what pass 1 spilled); tokens, ``(spilled,
    restored)`` and the engine."""
    eng = Engine(model, mesh=mesh, kv_dtype=kv_dtype, **EXTRAS_TIER)
    toks = []
    for _ in range(2):
        for i, p in enumerate(stream):
            toks += _drive(eng, [eng.add_request(p, max_new_tokens=4,
                                                 seed=i)])
    st = eng.stats()
    return toks, (st["tier_spilled"], st["tier_restored"]), eng


def extras_migration(Engine, model, mesh, prompts, kv_dtype=None):
    """Every request prefilled and held on one engine, exported, adopted
    by a second engine over the same mesh and decoded there."""
    src = Engine(model, mesh=mesh, kv_dtype=kv_dtype, **EXTRAS_ENGINE)
    dst = Engine(model, mesh=mesh, kv_dtype=kv_dtype, **EXTRAS_ENGINE)
    out, copied = [], 0
    for i, p in enumerate(prompts):
        req = src.add_request(p, max_new_tokens=5, seed=21 + i,
                              hold_after_prefill=True)
        while req.state != "held":
            src.step()
        new, info = dst.adopt_migration(src.export_request(req), src)
        src.finish_migrated(req)
        copied += info["blocks_copied"]
        out += _drive(dst, [new])
    return out, copied, (src, dst)


EXTRAS_FLEET = dict(max_slots=3, max_seq_len=32, min_bucket=4,
                    kv_layout="paged", block_size=4, prefill_chunk=8)


def extras_fleet(Fleet, model, mesh, prompts, prefill_replicas=0,
                 threaded=False, new=5):
    """A fleet of one replica, or of one prefill and one decode replica
    (the KV migrated between them); tokens and the fleet's migrations."""
    fleet = Fleet(model, replicas=1 + prefill_replicas,
                  prefill_replicas=prefill_replicas, mesh=mesh,
                  threaded=threaded, **EXTRAS_FLEET)
    try:
        before = fleet.stats()["migrated"]
        hs = [fleet.submit(p, max_new_tokens=new, seed=21 + i)
              for i, p in enumerate(prompts)]
        fleet.join(hs)
        toks = _tokens(hs)
        migrated = fleet.stats()["migrated"] - before
    finally:
        fleet.drain()
    return toks, migrated


def extras_fleet_stall(Fleet, model, mesh, prompts, rank, new=20):
    """A threaded two-replica fleet whose replica 0 stalls while the
    caller goes on submitting: once replica 0 has work, mesh rank 0
    alone sets its heartbeat back until its stall detector fires; the
    verdict drains and respawns the replica on every rank, its requests
    replay, and a second round of submits lands on the new replica list.
    Tokens of both rounds, and the heartbeat misses and respawns."""
    from paddle_tpu_torch.profiler import counters
    fleet = Fleet(model, replicas=2, mesh=mesh, threaded=True,
                  max_retries=2, **EXTRAS_FLEET)
    before = counters.snapshot()
    try:
        hs = [fleet.submit(p, max_new_tokens=new, seed=21 + i)
              for i, p in enumerate(prompts)]
        if rank == 0:
            rep, t0 = fleet._alive()[0], time.monotonic()
            while not counters.delta(before).get(
                    "serving.fleet.heartbeat_misses"):
                rep.last_beat = time.monotonic() - 1e6
                time.sleep(0.001)
                assert time.monotonic() - t0 < 120, "no stall verdict"
        hs += [fleet.submit(p, max_new_tokens=new, seed=21 + i)
               for i, p in enumerate(prompts)]
        fleet.join(hs)
        toks = _tokens(hs)
    finally:
        fleet.drain()
    d = counters.delta(before)
    return toks, (d.get("serving.fleet.heartbeat_misses", 0),
                  d.get("serving.fleet.respawns", 0))


def _lora_tp_check(eng, single, model, rank, world):
    """The LoRA update under ``TensorParallel``: a column-parallel (qkv)
    and a row-parallel (proj) product on this rank's shards and this
    rank's arena's cut of the slabs, gathered or all-reduced, against
    the unsharded ``_mm_lora`` on the whole weights and the slabs of the
    same tenants' unsharded arena (``single``); base rows (slot 0)
    bitwise those of the adapter-free product."""
    from paddle_tpu_torch.models.gpt import _mm, _mm_lora
    tp = eng._w["tp"]
    full = model.decode_state()["lws"]
    al_full = {n: t[0] for n, t in single.adapters.slabs().items()}
    al_mine = {n: t[0] for n, t in eng.adapters.slabs().items()}
    gen = torch.Generator().manual_seed(3)
    H = model.config.hidden_size
    x = torch.randn(3, 2, H, generator=gen)
    aids = torch.tensor([0, 1, 2])
    out = {}
    mine = {"qkv_w": eng._w["lws"]["qkv_w"][0],
            "proj_w": eng._w["lws"]["proj_w"][0]}
    y = _mm_lora(x, mine, "qkv_w", al_mine, aids)
    base = _mm(x, mine, "qkv_w")
    got = tp.full("qkv_w", y.contiguous())
    want = _mm_lora(x, {"qkv_w": full["qkv_w"][0]}, "qkv_w", al_full, aids)
    out["qkv"] = (_np(got), _np(want), bool(torch.equal(y[0], base[0])))
    cols = H // world
    xr = x[..., rank * cols:(rank + 1) * cols].contiguous()
    y = _mm_lora(xr, mine, "proj_w", al_mine, aids)
    base = _mm(xr, mine, "proj_w")
    part0 = bool(torch.equal(y[0], base[0]))
    torch.distributed.all_reduce(y)
    want = _mm_lora(x, {"proj_w": full["proj_w"][0]}, "proj_w", al_full,
                    aids)
    out["proj"] = (_np(y), _np(want), part0)
    return out


def serving_extras_mp2(rank, world, pl):
    """The serving extras on an mp2 mesh (``tests/
    test_torch_mesh_serving_extras.py``): each scenario at mp2 beside the
    same scenario without a mesh where the test holds the port to
    itself."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.profiler import counters
    from paddle_tpu_torch.serving import LLMEngine, ServingFleet
    prompts, sample = pl["prompts"], pl["sample"]
    model = _gpt(pl["cfg"], pl["state"])
    draft = _gpt(pl["draft_cfg"], pl["draft_state"])
    draft3 = _gpt(pl["draft3_cfg"], pl["draft3_state"])
    for m in (model, draft, draft3):
        m.eval()
    mesh = D.build_mesh({"mp": world})
    out = {}
    c0 = counters.snapshot()
    out["spec"], eng = extras_spec(LLMEngine, model, draft, mesh, prompts)
    st = eng.stats()
    d = counters.delta(c0)
    out["spec_stats"] = {
        "draft_shard": eng.arena.shard_shape("draft_pool_k"),
        "draft_qkv": tuple(eng._dw["lws"]["qkv_w"].shape),
        "drafted": d.get("serving.spec.drafted", 0),
        "accepted": d.get("serving.spec.accepted", 0),
        "disagreements": st["rank_disagreements"],
        "draft_bytes": st["draft_kv_pool_bytes_per_chip"],
        "draft_bytes_single": None}
    out["spec_stats"]["draft_bytes_single"] = extras_spec(
        LLMEngine, model, draft, None, prompts[:1])[1].stats()[
            "draft_kv_pool_bytes_per_chip"]
    # self-drafted: the draft proposes what the target picks, so rounds
    # accept blocks and rank 0's broadcast carries their lengths
    c0 = counters.snapshot()
    out["spec_self"], se = extras_spec(LLMEngine, model, model, mesh,
                                       prompts)
    d = counters.delta(c0)
    out["spec_self_stats"] = {
        "drafted": d.get("serving.spec.drafted", 0),
        "accepted": d.get("serving.spec.accepted", 0),
        "draft_heads": se.arena.shard_shape("draft_pool_k")[3],
        "disagreements": se.stats()["rank_disagreements"]}
    out["spec_sampled"] = extras_spec(LLMEngine, model, draft, mesh,
                                      prompts, sample)[0]
    out["spec_sampled_single"] = extras_spec(LLMEngine, model, draft, None,
                                             prompts, sample)[0]
    before = counters.get("serving.mesh.spec_degraded")
    out["spec3"], e3 = extras_spec(LLMEngine, model, draft3, mesh, prompts)
    out["spec3_stats"] = {
        "degraded": counters.get("serving.mesh.spec_degraded") - before,
        "draft_shard": e3.arena.shard_shape("draft_pool_k"),
        "target_shard": e3.arena.shard_shape("pool_k")}
    out["lora"], le = extras_lora(LLMEngine, model, mesh, prompts,
                                  pl["factors"])
    out["lora_sampled"] = extras_lora(LLMEngine, model, mesh, prompts,
                                      pl["factors"], sample)[0]
    out["lora_sampled_single"], single = extras_lora(
        LLMEngine, model, None, prompts, pl["factors"], sample)
    out["lora_stats"] = {
        "disagreements": le.stats()["rank_disagreements"],
        "slabs": {n: tuple(t.shape) for n, t in le.adapters.slabs().items()},
        "slabs_single": {n: tuple(t.shape)
                         for n, t in single.adapters.slabs().items()}}
    out["lora_tp"] = _lora_tp_check(le, single, model, rank, world)
    for kv in ("f32", "int8"):
        kvd = None if kv == "f32" else kv
        toks, moved, te = extras_tier(LLMEngine, model, mesh, pl["stream"],
                                      kvd)
        single = extras_tier(LLMEngine, model, None, pl["stream"][:1],
                             kvd)[2]
        out[f"tier_{kv}"] = toks
        out[f"tier_{kv}_stats"] = {
            "moved": moved,
            "host_bytes": te.stats()["host_arena_bytes"],
            "host_spec": [tuple(sh) for sh, _ in te._host_spec],
            "host_spec_single": [tuple(sh) for sh, _ in single._host_spec],
            "disagreements": te.stats()["rank_disagreements"]}
        toks, copied, _ = extras_migration(LLMEngine, model, mesh, prompts,
                                           kvd)
        out[f"migration_{kv}"] = toks
        out[f"migration_{kv}_copied"] = copied
    # a migration into an engine of another head split is refused
    src = LLMEngine(model, mesh=mesh, **EXTRAS_ENGINE)
    dst = LLMEngine(model, **EXTRAS_ENGINE)
    req = src.add_request(prompts[0], max_new_tokens=3,
                          hold_after_prefill=True)
    while req.state != "held":
        src.step()
    out["migration_refused"] = _raises(
        lambda: dst.adopt_migration(src.export_request(req), src))
    for tag, pre, thr in (("fleet", 0, False), ("fleet_disagg", 1, False),
                          ("fleet_threaded", 0, True),
                          ("fleet_disagg_threaded", 1, True)):
        out[tag] = extras_fleet(ServingFleet, model, mesh, prompts, pre,
                                thr)
    out["fleet_stall"] = extras_fleet_stall(ServingFleet, model, mesh,
                                            prompts, rank)
    out["fleet_stall_ref"] = extras_fleet(ServingFleet, model, None,
                                          prompts, new=20)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_fleet_control.py: the fleet's control plane at
# mp2.  Scenarios take the fleet (or engine) class, so the test process
# runs the same ones on the JAX package's over its two-device mesh;
# ``rank`` is the mesh rank (0 for the JAX run): what only rank 0 does
# (install a fault schedule, set a heartbeat back, record a burn) models
# what a rank sees alone
# ---------------------------------------------------------------------------

def _pkg(cls):
    """The fault injection, counters, flags, health, metrics and flight
    modules of the package ``cls`` comes from."""
    import importlib
    import types
    root = cls.__module__.split(".")[0]

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        fi=mod("resilience.faultinject"), counters=mod("profiler.counters"),
        flags=mod("core.flags" if root == "paddle_tpu" else "flags"),
        health=mod("profiler.health"), metrics=mod("profiler.metrics"),
        flight=mod("profiler.flight"), RetryAfter=mod("serving").RetryAfter)


def _moved(P, before, prefixes=("serving.fleet.",
                                "resilience.faults_injected")):
    """Counter (not gauge) movement under ``prefixes`` since ``before``."""
    return {k: v for k, v in P.counters.delta(before).items()
            if k.startswith(prefixes) and k not in P.counters._GAUGES}


def control_chaos(Fleet, model, mesh, rank, prompts, schedule, kw=None,
                  stall=False, new=6):
    """A pumped fleet under ``schedule``, installed by rank 0 alone;
    ``stall``: after the second pump rank 0 alone sets the hung replica's
    heartbeat back past the timeout (``tests/test_torch_fleet.py``'s
    chaos tests).  Tokens, finish reasons, retries, the faults fired,
    the counters moved and the hung replicas each rank saw."""
    P = _pkg(Fleet)
    fleet = Fleet(model, mesh=mesh, threaded=False, heartbeat_timeout_s=30.0,
                  **dict(dict(replicas=2), **(kw or {})), **EXTRAS_FLEET)
    before = P.counters.snapshot()
    if rank == 0:
        P.fi.set_schedule(schedule)
    hung = []
    try:
        hs = [fleet.submit(p, max_new_tokens=new, seed=i)
              for i, p in enumerate(prompts)]
        fleet.pump()
        if stall:
            fleet.pump()
            hung = [r.idx for r in fleet._alive() if r.hung]
            for r in fleet._alive():
                if r.hung and rank == 0:
                    r.last_beat -= fleet.heartbeat_timeout_s + 1.0
        fleet.join(hs, timeout_s=120)
        fired = sorted(P.fi.fired)
    finally:
        if rank == 0:
            P.fi.clear()
        fleet.drain()
    return {"tokens": _tokens(hs), "reasons": [h.finish_reason for h in hs],
            "retries": [h.retries for h in hs], "fired": fired,
            "moved": _moved(P, before), "hung": hung}


def control_router_queue(Fleet, model, mesh, rank):
    """``router_queue@1`` installed by rank 0 alone: the second submit
    sheds.  The ``RetryAfter``'s reason and hint, the first request's
    tokens, the faults fired and the counters moved."""
    P = _pkg(Fleet)
    fleet = Fleet(model, replicas=2, mesh=mesh, threaded=False,
                  **EXTRAS_FLEET)
    before = P.counters.snapshot()
    if rank == 0:
        P.fi.set_schedule("router_queue@1")
    try:
        h0 = fleet.submit([1, 2, 3], max_new_tokens=2, seed=0)
        try:
            fleet.submit([4, 5, 6], max_new_tokens=2, seed=1)
            shed = None
        except P.RetryAfter as e:
            shed = (e.reason, e.retry_after_hint)
        fleet.join([h0])
        fired = sorted(P.fi.fired)
    finally:
        if rank == 0:
            P.fi.clear()
        fleet.drain()
    return {"shed": shed, "tokens": _tokens([h0]), "fired": fired,
            "moved": _moved(P, before)}


def control_autoscale(Fleet, model, mesh, rank, prompts, hist, pattern,
                      kw, submit_at=(0,), threaded=False):
    """``tests/test_torch_fleet.py``'s ``_drive_autoscale``: the health
    plane ticked only here, at t = 0, 1, ... (each rank its own), and
    ``pattern[t]`` burns fed into ``hist`` before tick t on rank 0 alone;
    requests submitted before the ticks in ``submit_at`` and served to
    the end between ticks.  A threaded fleet is read once its autoscaler
    evaluated each tick.  Each tick's firing alerts, roles and alive
    count, the autoscaler's history, the counters moved and the finish
    reasons."""
    P = _pkg(Fleet)
    slo = P.health.SLO(hist.split(".")[1].replace("_ns", "") + "_burn",
                       ("hist_p95", hist), 1e10, windows=((1.0, 1.0),),
                       min_count=4)
    fleet = Fleet(model, mesh=mesh, threaded=threaded, autoscale=True,
                  health_kw=dict(rules=[slo]), **kw, **EXTRAS_FLEET)
    try:
        # ticked below only (the plane turned on after, so a threaded
        # fleet's scheduler cannot tick it first)
        fleet.health.maybe_tick = lambda now=None: None
        P.flags.set_flags({"FLAGS_health": True,
                           "FLAGS_health_interval_s": 0.0})
        before = P.counters.snapshot()
        trail, hs = [], []
        for t, burn in enumerate(pattern):
            if t in submit_at:
                hs += [fleet.submit(p, max_new_tokens=6, seed=i)
                       for i, p in enumerate(prompts)]
                fleet.join(hs)
            if burn and rank == 0:
                h = P.metrics.get_histogram(hist, "ns")
                for _ in range(40):
                    h.record(1e11)
            fleet.health.tick(now=float(t))
            if threaded:
                t0 = time.monotonic()
                while fleet.autoscaler._last_ticks < t + 1:
                    time.sleep(0.002)
                    assert time.monotonic() - t0 < 60, "no evaluation"
            else:
                fleet.pump()
            st = fleet.stats()
            trail.append((sorted(fleet.health.firing_names()),
                          (st["roles"], st["alive"])))
        fleet.join(hs)
        history = fleet.autoscaler.summary()["history"]
    finally:
        fleet.drain()
        P.flags.set_flags({"FLAGS_health": False,
                           "FLAGS_health_interval_s": 1.0})
    moved = _moved(P, before, ("serving.autoscale.", "serving.fleet.lost"))
    return {"trail": trail, "history": history, "moved": moved,
            "reasons": [h.finish_reason for h in hs]}


def control_user_calls(Fleet, model, mesh, prompts):
    """``spawn_replica``, ``set_role`` and ``retire_replica`` called on
    every rank between pumps of a disaggregated fleet, then the prompts
    served: the replicas (index, role) after each call's pump, and the
    tokens."""
    P = _pkg(Fleet)
    fleet = Fleet(model, replicas=2, prefill_replicas=1, mesh=mesh,
                  threaded=False, **EXTRAS_FLEET)
    before = P.counters.snapshot()

    def view():
        fleet.pump()
        return [(r.idx, r.role) for r in fleet._alive()]
    try:
        views = []
        fleet.spawn_replica(role="decode")
        views.append(view())
        fleet.set_role(fleet._alive()[2], "prefill")
        views.append(view())
        fleet.retire_replica(fleet._alive()[0])
        views.append(view())
        hs = [fleet.submit(p, max_new_tokens=6, seed=i)
              for i, p in enumerate(prompts)]
        fleet.join(hs)
    finally:
        fleet.drain()
    return {"views": views, "tokens": _tokens(hs), "moved": _moved(P, before)}


class FakeClock:
    """A stand-in for the ``time`` module of the serving modules:
    ``monotonic()`` reads ``t`` (moved by the test) plus ``skew`` and a
    microsecond more at every read; every other name is the real
    module's."""

    def __init__(self):
        self.t, self.skew, self._reads = 1000.0, 0.0, 0

    def monotonic(self):
        self._reads += 1
        return self.t + self.skew + 1e-6 * self._reads

    def __getattr__(self, name):
        return getattr(time, name)


@contextlib.contextmanager
def fake_clock(cls):
    """Stub the module-level ``time`` of the serving modules of the
    package ``cls`` comes from (the ``time`` module itself untouched)."""
    import importlib
    root = cls.__module__.split(".")[0]
    mods = [importlib.import_module(f"{root}.serving.{m}")
            for m in ("engine", "paged", "fleet", "speculative")]
    saved = [m.time for m in mods]
    clock = FakeClock()
    for m in mods:
        m.time = clock
    try:
        yield clock
    finally:
        for m, t in zip(mods, saved):
            m.time = t


def _deadline_stream(submit, step, rank, clock, prompts):
    """Three requests: one whose deadline passed before its prefill (0
    s), one without a deadline, one with 60 s that runs; once it has a
    token the clock moves 61 s.  On rank 1 the clock runs an hour ahead
    once they are submitted, so a rank that read its own clock would
    expire every deadline at once."""
    hs = [submit(prompts[0], 8, 0, 0.0), submit(prompts[1], 4, 1, None),
          submit(prompts[2], 20, 2, 60.0)]
    if rank:
        clock.skew = 3600.0
    while not hs[2].tokens:
        step()
    first = len(hs[2].tokens)
    clock.t += 61.0
    return hs, first


def control_engine_deadlines(Engine, model, mesh, rank, prompts, kv_layout):
    """``tests/test_serving.py``'s deadline tests on one engine (``"spec"``:
    the paged engine drafting with the model itself): tokens, finish
    reasons, the running request's tokens at its eviction and the serving
    counters moved."""
    P = _pkg(Engine)
    kw = (dict(EXTRAS_ENGINE, draft_model=model, spec_k=2)
          if kv_layout == "spec" else dict(EXTRAS_ENGINE, kv_layout=kv_layout))
    eng = Engine(model, mesh=mesh, **kw)
    with fake_clock(Engine) as clock:
        before = P.counters.snapshot()
        hs, first = _deadline_stream(
            lambda p, n, s, d: eng.add_request(p, max_new_tokens=n, seed=s,
                                               deadline_s=d),
            eng.step, rank, clock, prompts)
        _drive(eng, hs)
    d = P.counters.delta(before)
    return {"tokens": _tokens(hs), "reasons": [h.finish_reason for h in hs],
            "first": first, "counters": {k: d.get(k, 0) for k in (
                "serving.deadline_expired", "serving.evictions.deadline",
                "serving.prefill_batches")}}


def control_fleet_deadlines(Fleet, model, mesh, rank, prompts):
    """The deadline stream through a pumped two-replica fleet's
    ``submit(deadline_s=)``."""
    P = _pkg(Fleet)
    fleet = Fleet(model, replicas=2, mesh=mesh, threaded=False,
                  **EXTRAS_FLEET)
    with fake_clock(Fleet) as clock:
        before = P.counters.snapshot()
        try:
            hs, first = _deadline_stream(
                lambda p, n, s, d: fleet.submit(p, max_new_tokens=n, seed=s,
                                                deadline_s=d),
                fleet.pump, rank, clock, prompts)
            fleet.join(hs)
        finally:
            fleet.drain()
    d = P.counters.delta(before)
    return {"tokens": _tokens(hs), "reasons": [h.finish_reason for h in hs],
            "first": first, "counters": {k: d.get(k, 0) for k in (
                "serving.deadline_expired", "serving.evictions.deadline",
                "serving.fleet.completed.deadline")}}


def control_cancel_race(Fleet, model, mesh, rank, prompts, new=8):
    """Request 0 of a pumped one-replica fleet is cancelled while it
    runs, by rank 1's caller one pump before rank 0's (the race of two
    threads, made deterministic).  Tokens and finish reasons."""
    fleet = Fleet(model, replicas=1, mesh=mesh, threaded=False,
                  **EXTRAS_FLEET)
    try:
        hs = [fleet.submit(p, max_new_tokens=new, seed=i)
              for i, p in enumerate(prompts[:2])]
        fleet.pump()
        fleet.pump()
        if rank == 1:
            hs[0].cancel()
        fleet.pump()
        if rank == 0:
            hs[0].cancel()
        fleet.join(hs, timeout_s=120)
    finally:
        fleet.drain()
    return {"tokens": _tokens(hs), "reasons": [h.finish_reason for h in hs]}


def control_cancel_churn(Fleet, model, mesh, prompt):
    """``tests/test_fleet.py``'s cancel during churn on a threaded fleet:
    the replica crashes on the request (rank 0's schedule), and the
    caller cancels it while it replays.  Its finish reason and the
    requests the drain found lost."""
    from paddle_tpu_torch.profiler import counters
    from paddle_tpu_torch.resilience import faultinject
    fleet = Fleet(model, replicas=2, mesh=mesh, threaded=True,
                  **EXTRAS_FLEET)
    before = counters.snapshot()
    try:
        if mesh.rank == 0:
            faultinject.set_schedule("replica_crash@0")
        h = fleet.submit(prompt, max_new_tokens=8, seed=0)
        t0 = time.monotonic()
        while not counters.delta(before).get("serving.fleet.respawns"):
            time.sleep(0.001)
            assert time.monotonic() - t0 < 60, "no respawn"
        h.cancel()
        assert h.wait(60)
    finally:
        faultinject.clear()
        fleet.drain()
    return {"reason": h.finish_reason,
            "lost": counters.delta(before).get("serving.fleet.lost", 0)}


def _fleet_crash_respawns(Fleet, model, mesh, prompts):
    """A replica whose engine step raises on every rank: reported at the
    next tick, drained and respawned once on every rank; its request
    replays.  Tokens, and the deaths and respawns."""
    from paddle_tpu_torch.profiler import counters
    fleet = Fleet(model, replicas=1, mesh=mesh, threaded=False,
                  **EXTRAS_FLEET)
    before = counters.snapshot()
    try:
        h = fleet.submit(prompts[0], max_new_tokens=5, seed=1)
        fleet.pump()

        def boom():
            raise RuntimeError("replica step failed")
        fleet._alive()[0].engine.step = boom
        fleet.join([h], timeout_s=120)
    finally:
        fleet.drain()
    d = counters.delta(before)
    return {"tokens": _tokens([h]), "reason": h.finish_reason,
            "deaths": d.get("serving.fleet.replica_deaths.crash", 0),
            "respawns": d.get("serving.fleet.respawns", 0)}


def _decode_collectives(model, mesh, prompts, kv_layout):
    """Collectives (``dist.collective_launches``) of one mesh engine's
    decode step, without a deadline and with one."""
    from paddle_tpu_torch.profiler import counters
    from paddle_tpu_torch.serving import LLMEngine
    out = []
    for deadline in (None, 600.0):
        eng = LLMEngine(model, mesh=mesh,
                        **dict(EXTRAS_ENGINE, kv_layout=kv_layout))
        eng.add_request(prompts[0], max_new_tokens=8, seed=1,
                        deadline_s=deadline)
        eng.step()
        eng.step()
        c0 = counters.snapshot()
        eng.step()
        d = counters.delta(c0)
        out.append((d.get("dist.collective_launches", 0),
                    d.get("serving.decode_steps", 0)))
    return out


def _flight_bundles(Fleet, model, mesh, root, prompts):
    """One replica death on a fleet whose ranks share ``FLAGS_flight_dir``:
    the ``replica_died`` bundles the directory then holds."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.resilience import faultinject
    flags.set_flags({"FLAGS_flight_dir": root})
    fleet = Fleet(model, replicas=1, mesh=mesh, threaded=False,
                  **EXTRAS_FLEET)
    try:
        if mesh.rank == 0:
            faultinject.set_schedule("replica_crash@0")
        h = fleet.submit(prompts[0], max_new_tokens=4, seed=0)
        fleet.join([h], timeout_s=120)
    finally:
        faultinject.clear()
        fleet.drain()
        flags.set_flags({"FLAGS_flight_dir": ""})
    torch.distributed.barrier()
    return sorted(f for f in os.listdir(root)
                  if f.startswith("flight-replica_died"))


def fleet_control_mp2(rank, world, pl):
    """The fleet's control plane on an mp2 mesh
    (``tests/test_torch_mesh_fleet_control.py``): every scenario above
    at mp2, and the port-only checks beside them."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.serving import LLMEngine, ServingFleet
    prompts = pl["prompts"]
    model = _gpt(pl["cfg"], pl["state"])
    model.eval()
    mesh = D.build_mesh({"mp": world})
    out = {}
    for name, args in pl["chaos"].items():
        out[name] = control_chaos(ServingFleet, model, mesh, rank, **args)
    out["router_queue"] = control_router_queue(ServingFleet, model, mesh,
                                               rank)
    for name, args in pl["autoscale"].items():
        out[name] = control_autoscale(ServingFleet, model, mesh, rank,
                                      **args)
    out["user_calls"] = control_user_calls(ServingFleet, model, mesh,
                                           prompts)
    for layout in ("paged", "slots", "spec"):
        out[f"deadline_{layout}"] = control_engine_deadlines(
            LLMEngine, model, mesh, rank, prompts, layout)
    for layout in ("paged", "slots"):
        out[f"collectives_{layout}"] = _decode_collectives(
            model, mesh, prompts, layout)
    out["deadline_fleet"] = control_fleet_deadlines(ServingFleet, model,
                                                    mesh, rank, prompts)
    out["cancel_race"] = control_cancel_race(ServingFleet, model, mesh,
                                             rank, prompts)
    out["cancel_churn"] = control_cancel_churn(ServingFleet, model, mesh,
                                               prompts[0])
    out["crash"] = _fleet_crash_respawns(ServingFleet, model, mesh, prompts)
    out["crash_ref"] = extras_fleet(ServingFleet, model, mesh, prompts[:1],
                                    new=5)[0]
    out["flight"] = _flight_bundles(ServingFleet, model, mesh,
                                    pl["flight_dir"], prompts)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_train.py
# ---------------------------------------------------------------------------

def _train(pl, mesh, steps=None, fused=1, scaler=None, rules=None,
           weighted=False, batch=None):
    """The GPT of ``pl`` trained ``steps`` AdamW steps on ``pl``'s
    batches through the mesh step; returns (losses, gathered state,
    step, model, optimizer)."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    model = _gpt(pl["cfg"], pl["state"])
    crit = GPTPretrainingCriterion()
    opt = AdamW(pl["lr"], parameters=model.parameters())

    def loss_fn(m, ids, labels, *w):
        loss = crit(m(ids), labels)
        return loss * w[0].mean() if w else loss
    step = CompiledTrainStep(model, loss_fn, opt, mesh=mesh,
                             shard_rules=rules, fused_steps=fused,
                             scaler=scaler)
    ids, labels = batch or (pl["ids"], pl["labels"])
    n = len(ids) if steps is None else steps
    losses = []
    for i in range(n):
        args = [torch.from_numpy(ids[i]), torch.from_numpy(labels[i])]
        if weighted:
            args.append(torch.from_numpy(pl["weights"][i]))
        losses.append(float(step(*args)))
    return losses, model.gather_numpy_state(), step, model, opt


def _train_checks(pl, mesh):
    from paddle_tpu_torch.profiler import counters
    out = {}
    losses, state, step, model, _ = _train(pl, mesh)
    out["losses"], out["state"] = losses, state
    # the steady counter contract: one dispatch a call, no sync, and
    # host-issued collectives
    before = counters.snapshot()
    for i in range(2):
        step(torch.from_numpy(pl["ids"][i]),
             torch.from_numpy(pl["labels"][i]))
    d = counters.delta(before)
    out["steady"] = {k: d.get(k, 0) for k in (
        "jit.host.dispatches", "jit.steps", "jit.syncs",
        "dist.collective_launches")}
    return out


def _train_dp2(pl):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.distributed.sharding_utils import P
    mesh = D.build_mesh({"dp": 2})
    out = _train_checks(pl, mesh)
    # an indivisible batch (5 rows over dp=2) stays whole: the meshless
    # step's loss
    five = (pl["ids5"], pl["labels5"])
    out["indiv_losses"] = [_train(pl, m, steps=1, batch=five)[0]
                           for m in (mesh, None)]
    # GradScaler: an inf loss weight in one rank's rows skips the step on
    # every rank, as the meshless step skips it
    out["scaler"] = []
    for m in (mesh, None):
        sc = amp.GradScaler(init_loss_scaling=2.0 ** 10)
        losses = _train(pl, m, scaler=sc, weighted=True)[0]
        out["scaler"].append((losses, float(sc._state["scale"])))
    # the sharded prefetchers: this rank's rows, bit for bit
    ds = tio.TensorDataset([torch.from_numpy(pl["x"]),
                            torch.from_numpy(pl["y"])])
    loader = tio.DataLoader(ds, batch_size=4, shuffle=False)
    out["pref"] = [[_np(t) for t in b]
                   for b in tio.DevicePrefetcher(loader, sharding=P("dp"))]
    out["pref_local_rows"] = all(
        getattr(getattr(t, "_data", t), "_local_rows", False)
        for b in tio.DevicePrefetcher(loader, sharding=P("dp")) for t in b)
    loader3 = tio.DataLoader(ds, batch_size=3, shuffle=False)
    out["pref_indiv"] = [[_np(t) for t in b] for b in tio.DevicePrefetcher(
        loader3, sharding=P("dp"))]
    out["stack"] = [[_np(t) for t in w] for w in tio.StackingPrefetcher(
        loader, k=2, sharding=P("dp"))]
    # the sampler reads its rank and replicas from the process group
    s = tio.DistributedBatchSampler(list(range(10)), 2)
    out["sampler"] = (s.nranks, s.local_rank, list(s))
    # a window from the sharded stacking prefetcher trains as the step's
    # own row split of the whole batch does
    lo_ds = tio.TensorDataset([torch.from_numpy(np.concatenate(
        pl["ids"][:4])), torch.from_numpy(np.concatenate(
            pl["labels"][:4]))])
    lo = tio.DataLoader(lo_ds, batch_size=pl["ids"].shape[1],
                        shuffle=False)
    _, _, wstep, _, _ = _train(pl, mesh, steps=0, fused=2)
    out["window_losses"] = [float(x) for w in tio.StackingPrefetcher(
        lo, k=2, sharding=P("dp")) for x in wstep(w)]
    return out


def _train_mp2(pl):
    from paddle_tpu_torch import distributed as D
    mesh = D.build_mesh({"mp": 2})
    out = _train_checks(pl, mesh)
    model = _gpt(pl["cfg"], pl["state"])
    out["roundtrip"] = model.gather_numpy_state()
    out["qkv_w_local"] = _np(model.qkv_w)
    out["shapes"] = {n: tuple(t.shape) for n, t in model._weights().items()}
    return out


def train_2ranks(rank, world, pl):
    """dp2, then mp2, over one group of two ranks."""
    from paddle_tpu_torch import distributed as D
    out = {"dp2": _train_dp2(pl)}
    D.set_mesh(None)   # the mp2 models are built under their own mesh
    out["mp2"] = _train_mp2(pl)
    return out


def train_dp2mp2(rank, world, pl):
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.sharding_utils import P
    mesh = D.build_mesh({"dp": 2, "mp": 2})
    out = _train_checks(pl, mesh)
    # storage sharding from rules: wpe (held whole by the model) split
    # over mp; its Adam moments hold this rank's slice
    losses, state, _, model, opt = _train(pl, mesh, rules=[
        (r"wpe$", P(None, "mp"))])
    out["rules_losses"], out["rules_state"] = losses, state
    out["rules_moment_shape"] = tuple(
        opt._accumulators["moment1"][id(model._parameters["wpe"])].shape)
    # the sharding axis: every parameter the model holds whole keeps its
    # optimizer state split over `sharding`, its gradient reduce-scattered
    mesh = D.build_mesh({"sharding": 2, "mp": 2})
    losses, state, _, model, opt = _train(pl, mesh)
    out["sharding_losses"], out["sharding_state"] = losses, state
    out["sharding_moment_shape"] = tuple(
        opt._accumulators["moment1"][id(model._parameters["ln1_w"])].shape)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_distributed_api.py
# ---------------------------------------------------------------------------

def _load_layer(layer, full, mesh):
    from paddle_tpu_torch.distributed.sharding_utils import local_shard
    for name, p in torch.nn.Module.named_parameters(layer):
        spec = getattr(p, "placements", ())
        with torch.no_grad():
            p.copy_(local_shard(torch.from_numpy(full[name]), spec, mesh)
                    if any(e is not None for e in spec) else
                    torch.from_numpy(full[name]))


def api_dp2mp2(rank, world, pl):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet, mp_ops
    from paddle_tpu_torch.distributed.sharding_utils import gather_shard
    from paddle_tpu_torch.profiler import counters
    out = {}
    env = D.ParallelEnv()
    out["env"] = (D.get_rank(), D.get_world_size(), env.rank, env.world_size,
                  D.is_initialized())
    m = D.build_mesh({"dp": 2, "mp": -1})
    out["degrees"] = D.hybrid_degrees()
    out["coord"] = dict(m.coord)
    out["data_axes"] = D.data_axes()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    mesh = D.get_mesh()
    out["hcg"] = dict(
        dp=(hcg.get_data_parallel_world_size(), hcg.get_data_parallel_rank(),
            hcg.get_data_parallel_group().ranks),
        mp=(hcg.get_model_parallel_world_size(),
            hcg.get_model_parallel_rank(),
            hcg.get_model_parallel_group().ranks),
        stage=hcg.get_stage_id(), first=hcg.is_first_stage(),
        workers=(fleet.worker_num(), fleet.worker_index(),
                 fleet.is_first_worker()))
    out["comm_list"] = {a: hcg.topology().get_comm_list(a)
                        for a in ("dp", "mp")}
    # -- the eager collectives
    c0 = counters.snapshot()
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    r = {}
    t = x.clone()
    D.all_reduce(t)
    r["all_reduce"] = _np(t)
    t = x.clone()
    D.all_reduce(t, op=D.ReduceOp.MAX, group="mp")
    r["all_reduce_max_mp"] = _np(t)
    t = x.clone()
    D.all_reduce(t, op=D.ReduceOp.AVG, group=hcg.get_data_parallel_group())
    r["all_reduce_avg_dp"] = _np(t)
    lst = []
    D.all_gather(lst, paddle.to_tensor(x.numpy()))
    r["all_gather"] = [_np(v) for v in lst]
    objs = []
    D.all_gather_object(objs, {"rank": rank})
    r["all_gather_object"] = objs
    t = x.clone()
    D.broadcast(t, src=3)
    r["broadcast"] = _np(t)
    t = x.clone()
    D.reduce(t, dst=1)
    r["reduce"] = _np(t)
    t = torch.zeros(2)
    D.reduce_scatter(t, [x[:2].clone(), x[2:].clone(), x[:2] * 2, x[2:] * 2])
    r["reduce_scatter"] = _np(t)
    t = torch.zeros(2)
    D.scatter(t, [torch.full((2,), float(i)) for i in range(4)]
              if rank == 0 else None, src=0)
    r["scatter"] = _np(t)
    outs = []
    D.all_to_all(outs, [torch.full((1,), float(10 * rank + i))
                        for i in range(4)])
    r["all_to_all"] = [_np(v) for v in outs]
    peer = rank ^ 1
    t = torch.zeros(4)
    if rank % 2 == 0:
        D.send(x, dst=peer)
        D.recv(t, src=peer)
    else:
        D.recv(t, src=peer)
        D.send(x, dst=peer)
    r["sendrecv"] = _np(t)
    t = torch.zeros(4)
    tasks = D.batch_isend_irecv([D.P2POp(D.isend, x, peer),
                                 D.P2POp(D.irecv, t, peer)])
    for task in tasks:
        task.wait()
    r["batch_p2p"] = _np(t)
    D.barrier()
    r["launches"] = counters.delta(c0).get("dist.collective_launches", 0)
    out["comm"] = r
    # -- mp_ops over the mp group
    mr = mesh.index("mp")
    a = torch.from_numpy(pl["a"]).requires_grad_()
    ct = torch.from_numpy(pl["ct"])
    g = mp_ops.gather_from_mp(mp_ops.copy_to_mp(a) * (mr + 1))
    (g * ct).sum().backward()
    out["mp_ops"] = {"gather": _np(g), "grad": _np(a.grad)}
    h = torch.from_numpy(pl["a"]).requires_grad_()
    s = mp_ops.reduce_from_mp(mp_ops.scatter_to_mp(h) * (mr + 1))
    (s * ct[..., :s.shape[-1]]).sum().backward()
    out["mp_ops"].update(reduce=_np(s), grad2=_np(h.grad))
    V = pl["logits"].shape[-1]
    lg = torch.from_numpy(pl["logits"][..., mr * V // 2:(mr + 1) * V // 2])
    lg.requires_grad_()
    ce = mp_ops.vocab_parallel_ce_sum(lg, torch.from_numpy(pl["labels"]))
    ce.backward()
    out["ce"] = (float(ce.detach()), _np(lg.grad))
    wte = torch.from_numpy(pl["wte"])
    vl = wte.shape[0] // 2
    emb = mp_ops.vocab_parallel_embedding(
        torch.from_numpy(pl["ids"]), wte[mr * vl:(mr + 1) * vl])
    out["emb"] = _np(emb)
    # -- the tensor-parallel layers against the JAX layers' numbers
    paddle.seed(0)
    lay = {"col": fleet.ColumnParallelLinear(8, 16, has_bias=True,
                                             gather_output=True),
           "row": fleet.RowParallelLinear(16, 8, has_bias=True),
           "emb": fleet.VocabParallelEmbedding(32, 8)}
    res = {}
    for name, layer in lay.items():
        w = pl["layers"][name]
        _load_layer(layer, w["params"], mesh)
        xin = paddle.to_tensor(w["x"])
        if name != "emb":
            xin.stop_gradient = False
        y = layer(xin)
        (y._data * torch.from_numpy(w["ct"])).sum().backward()
        grads = {n: _np(gather_shard(p.grad, p.placements, mesh))
                 for n, p in torch.nn.Module.named_parameters(layer)}
        res[name] = {"y": _np(y), "grads": grads,
                     "xgrad": None if name == "emb" else _np(xin._data.grad)}
    pce = fleet.ParallelCrossEntropy()
    w = pl["layers"]["pce"]
    lgl = w["logits"][..., mr * 16:(mr + 1) * 16]
    li = paddle.to_tensor(lgl)
    li.stop_gradient = False
    loss = pce(li, paddle.to_tensor(w["labels"]))
    loss._data.sum().backward()
    res["pce"] = {"y": _np(loss), "grad": _np(gather_shard(
        li._data.grad, (None, None, "mp"), mesh))}
    out["layers"] = res
    # -- the RNG tracker: global streams agree, local ones differ
    fleet.model_parallel_random_seed(7)
    tr = fleet.get_rng_state_tracker()
    with tr.rng_state("global_seed"):
        gl = _np(paddle.rand([4]))
    with tr.rng_state("local_seed"):
        lo = _np(paddle.rand([4]))
    out["rng"] = (gl, lo)
    # -- DataParallel: the gradients' mean over the world
    lin = paddle.nn.Linear(4, 2)
    dp = D.DataParallel(lin)
    xin = paddle.to_tensor(np.full((2, 4), float(rank + 1), np.float32))
    dp(xin)._data.sum().backward()
    dp.apply_collective_grads()
    out["dp_grad"] = _np(lin.weight.grad)
    # -- the hybrid optimizer: dp mean, clip over mp shards
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD
    col = fleet.ColumnParallelLinear(8, 16, has_bias=True,
                                     gather_output=True)
    _load_layer(col, pl["layers"]["col"]["params"], mesh)
    opt = fleet.distributed_optimizer(SGD(
        0.1, parameters=col.parameters(),
        grad_clip=ClipGradByGlobalNorm(0.01)))
    xin = paddle.to_tensor(pl["layers"]["col"]["x"] * (mesh.index("dp") + 1))
    col(xin)._data.sum().backward()
    opt.step()
    out["hybrid_weight"] = _np(gather_shard(col.weight._data,
                                            col.weight._data.placements,
                                            mesh))
    # -- fleet's UtilBase over the world, then group_sharded_parallel's
    # annotations at sharding 2 x mp 2
    u = fleet.UtilBase()
    out["util"] = {mode: u.all_reduce(np.array([rank + 1.0, -rank]),
                                      mode).tolist()
                   for mode in ("sum", "max", "min")}
    out["util"]["shard"] = u.get_file_shard(list("abcdefg"))
    D.set_mesh(None)
    D.build_mesh({"sharding": 2, "mp": 2})
    out["group_sharded"] = {level: group_sharded_annotations(
        paddle, D.sharding.group_sharded_parallel, level)
        for level in ("os", "os_g", "p_g_os")}
    return out


def group_sharded_model(pkg):
    """The model whose ZeRO annotations both packages compare: two
    linears of 2048 and 1280 weights (above the 1024-element floor) and
    their biases (below it)."""
    class Two(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.l0 = pkg.nn.Linear(64, 32)
            self.l1 = pkg.nn.Linear(32, 40)
    return Two()


def group_sharded_annotations(pkg, group_sharded_parallel, level):
    """``{name: (placements, _opt_state_spec)}`` after
    ``group_sharded_parallel`` at ``level`` (specs as tuples)."""
    from paddle_tpu_torch.core.tensor import unwrap
    model = group_sharded_model(pkg)
    group_sharded_parallel(model, None, level=level)
    out = {}
    for name, p in model.named_parameters():
        t = unwrap(p) if "paddle_tpu_torch" in pkg.__name__ else p
        spec = getattr(t, "placements", None)
        opt = getattr(t, "_opt_state_spec", None)
        out[name] = (None if spec is None else tuple(spec),
                     None if opt is None else tuple(opt))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_moe_mesh.py
# ---------------------------------------------------------------------------

def _moe_loss(crit):
    def loss_fn(m, ids, labels):
        return crit(m(ids), labels) + 0.01 * m.moe_aux_loss()
    return loss_fn


def _moe_train(pl, mesh, control=False):
    """The MoE GPT of ``pl`` built under ``mesh`` and trained
    ``len(pl["ids"])`` AdamW steps on the global batches through the
    mesh step (``control``: the expert stacks' gradients all-reduced over
    dp as a replicated parameter's are)."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    model = _gpt(pl["cfg"], pl["state"])
    opt = AdamW(pl["lr"], parameters=model.parameters())
    step = CompiledTrainStep(model, _moe_loss(GPTPretrainingCriterion()),
                             opt, mesh=mesh)
    if control:
        step._mesh.experts = {}
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in zip(pl["ids"], pl["labels"])]
    return losses, model.gather_numpy_state(), model


def moe_2ranks(rank, world, pl):
    """dp2 expert-parallel training, then mp2 MoE serving, over one group
    of two ranks."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.env import rows_split_over
    from paddle_tpu_torch.profiler import counters
    out = {}
    mesh = D.build_mesh({"dp": world})
    c0 = counters.snapshot()
    out["losses"], out["state"], model = _moe_train(pl, mesh)
    out["ep_collectives"] = counters.delta(c0).get("dist.ep_collectives", 0)
    out["shapes"] = {n: tuple(t.shape) for n, t in model._weights().items()}
    out["placements"] = {n: tuple(getattr(t, "placements", ()))
                         for n, t in model._weights().items()}
    # the first batch's aux at the initial weights, from this rank's rows
    # (an eager forward says that its rows are this rank's own)
    fresh = _gpt(pl["cfg"], pl["state"])
    half = pl["ids"].shape[1] // world
    rows = torch.from_numpy(pl["ids"][0][rank * half:(rank + 1) * half])
    out["whole_batch_refused"] = _raises(lambda: fresh(rows))
    with rows_split_over(("dp",)):
        fresh(rows)
    out["aux0"] = float(fresh.moe_aux_loss().detach())
    out["control_losses"], out["control_state"], _ = _moe_train(
        pl, mesh, control=True)
    # serving an expert-parallel model: its tokens would be replicated
    # over the experts' axis, which the port refuses (the JAX serving
    # mesh splits mp only)
    model.eval()
    out["ep_serving"] = _raises(lambda: model.generate(
        np.asarray([pl["prompts"][0]]), max_new_tokens=2))
    # mp2 serving: the whole model's shards cut by the arena, and a
    # model built under the mesh
    D.set_mesh(None)
    whole = _gpt(pl["serve_cfg"], pl["serve_state"])
    whole.eval()
    prompts = pl["prompts"]
    out["unsharded"] = _serve(whole, prompts)[0]
    out["unsharded_slots"] = _serve(whole, prompts, kv_layout="slots")[0]
    mesh = D.build_mesh({"mp": world})
    out["mp2"], eng = _serve(whole, prompts, mesh)
    out["mp2_fc1_shard"] = tuple(eng._w["lws"]["fc1_w"].shape)
    out["mp2_int8"] = _serve(whole, prompts, mesh, kv_dtype="int8",
                             weight_dtype="int8")[0]
    out["unsharded_int8"] = _serve(whole, prompts, kv_dtype="int8",
                                   weight_dtype="int8")[0]
    out["mp2_slots"] = _serve(whole, prompts, mesh, kv_layout="slots")[0]
    split = _gpt(pl["serve_cfg"], pl["serve_state"])
    split.eval()
    out["split_model"], e = _serve(split, prompts, mesh)
    out["split_fc1_shard"] = tuple(e._w["lws"]["fc1_w"].shape)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py
# ---------------------------------------------------------------------------

def _chunk(a, rank, world, dim=1):
    n = a.shape[dim] // world
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=dim)


def _ring_case(case, rank, world, attend):
    """``attend(q, k, v, causal)`` on this rank's chunks of ``case``'s
    global q/k/v (loss ``sum(o**2)`` over the whole sequence): the output
    chunk and the chunks' gradients."""
    from paddle_tpu_torch.profiler import counters
    q, k, v = (torch.from_numpy(_chunk(case[n], rank, world)).requires_grad_()
               for n in "qkv")
    c0 = counters.snapshot()
    o = attend(q, k, v, causal=case["causal"])
    (o.float() ** 2).sum().backward()
    d = counters.delta(c0)
    return {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad), "shifts": d.get("dist.ring_shifts", 0),
            "fallbacks": d.get("kernels.flash.reference_fallbacks", 0)}


def ring_sep(rank, world, pl):
    """Every case of ``pl`` through the ring over ``sep = world``, and
    its control: a ring that does not rotate, each rank attending within
    its own chunk (``flash_attention_fwd`` on it)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.kernels.ring_attention import ring_attention
    D.build_mesh({"sep": world})
    return {name: {"ring": _ring_case(case, rank, world, ring_attention),
                   "control": _ring_case(case, rank, world,
                                         flash_attention_fwd)}
            for name, case in pl["cases"].items()}


# ---------------------------------------------------------------------------
# tests/test_torch_sequence_parallel.py
# ---------------------------------------------------------------------------

def sp_linears_mp2(rank, world, pl):
    """ScatterOp -> ColumnSequenceParallelLinear -> gelu ->
    RowSequenceParallelLinear -> GatherOp at mp 2 on ``pl``'s weights:
    the output, the input's gradient and every full parameter gradient
    of ``sum(y**2)``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding_utils import gather_shard
    from paddle_tpu_torch.profiler import counters
    mesh = D.build_mesh({"mp": world})
    col = fleet.ColumnSequenceParallelLinear(8, 16, has_bias=True)
    row = fleet.RowSequenceParallelLinear(16, 8, has_bias=True)
    _load_layer(col, {"weight": pl["w1"], "bias": pl["b1"]}, mesh)
    _load_layer(row, {"weight": pl["w2"], "bias": pl["b2"]}, mesh)
    x = paddle.to_tensor(pl["x"], stop_gradient=False)
    c0 = counters.snapshot()
    mid = col(fleet.ScatterOp.apply(x))
    part = row(paddle.nn.functional.gelu(mid))
    y = fleet.GatherOp.apply(part)
    (y._data ** 2).sum().backward()
    moved = counters.delta(c0)

    def full(p):
        t = p._data if hasattr(p, "_data") else p
        spec = getattr(t, "placements", ())
        g = t.grad
        return _np(gather_shard(g, spec, mesh) if any(
            e is not None for e in spec) else g)
    return {"y": _np(y), "dx": _np(x.grad), "mid_shape": tuple(mid.shape),
            "part_shape": tuple(part.shape),
            "grads": {"w1": full(col.weight), "b1": full(col.bias),
                      "w2": full(row.weight), "b2": full(row.bias)},
            "marked": bool(getattr(row.bias._data, "sequence_parallel",
                                   False)),
            "mp_collectives": moved.get("dist.mp_collectives", 0)}


# ---------------------------------------------------------------------------
# tests/test_torch_cp_train.py
# ---------------------------------------------------------------------------

def _cp_train(pl, mesh, cfg, state, batch, steps=None):
    """The GPT ``cfg`` (``state``'s weights) trained AdamW steps on the
    global ``batch`` (ids, labels, loss masks) through the mesh step;
    returns (losses, gathered state, the counters one step moved)."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import counters
    model = _gpt(cfg, state)
    crit = GPTPretrainingCriterion()
    opt = AdamW(pl["lr"], parameters=model.parameters())
    step = CompiledTrainStep(model, lambda m, x, y, w: crit(m(x), y, w), opt,
                             mesh=mesh)
    losses, moved = [], None
    for i in range(len(batch[0]) if steps is None else steps):
        c0 = counters.snapshot()
        losses.append(float(step(*(torch.from_numpy(t[i]) for t in batch))))
        moved = moved or counters.delta(c0)
    return losses, model.gather_numpy_state(), moved


def _dropout_masks(pl, mesh):
    """The keep masks of one training forward with dropout under the sep
    split (this rank's), and the same number of masks of their shape
    drawn afresh from a generator seeded as the chunk's stream: ``(masks,
    redrawn, seed)``."""
    from paddle_tpu_torch.distributed.env import sequence_split_over
    from paddle_tpu_torch.models import gpt
    cfg = {**pl["cfg"], "dropout": 0.5, "context_parallel": True}
    seen, drop = [], gpt._dropout

    def record(x, p, keep):
        seen.append(keep.clone())
        return drop(x, p, keep)
    gpt._dropout = record
    try:
        ids = torch.from_numpy(pl["ids"][0])
        n = ids.shape[1] // mesh.degree("sep")
        me = mesh.index("sep")
        model = _gpt(cfg, pl["state"])
        with sequence_split_over("sep", mesh):
            model(ids[:, me * n:(me + 1) * n])
    finally:
        gpt._dropout = drop
    (gen,) = model.chunk_generators.values()
    again = torch.Generator().manual_seed(gen.initial_seed())
    redrawn = [torch.rand(m.shape, generator=again) < 0.5 for m in seen]
    return ([_np(m) for m in seen], [_np(m) for m in redrawn],
            gen.initial_seed())


def _refusals(mesh):
    """A BERT and a plain linear layer handed to the mesh step on a sep
    mesh: the errors (neither handles the sequence split)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    bert = BertForPretraining(BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64))
    models = {"bert": bert, "linear": paddle.nn.Linear(8, 8)}
    return {name: _raises(lambda: CompiledTrainStep(
        m, lambda m, x: m(x).sum(), AdamW(1e-3, parameters=m.parameters()),
        mesh=mesh)) for name, m in models.items()}


def cp_sep2(rank, world, pl):
    """sep 2 over the two ranks: the context-parallel GPT (with and
    without sequence_parallel, learned positions and RoPE), the
    sequence_parallel-only route, sep with neither flag, each 3 AdamW
    steps under loss masks of unequal counts per chunk; the dropout
    masks; MoE, mesh serving and models that do not handle the split
    refused; then dp2 with the same masks
    (unequal counts per row)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.serving import LLMEngine
    mesh = D.build_mesh({"sep": world})
    batch = (pl["ids"], pl["labels"], pl["masks"])
    out = {}
    for name, flags in pl["runs"].items():
        state = pl["rope_state"] if flags.get("use_rope") else pl["state"]
        out[name] = _cp_train(pl, mesh, {**pl["cfg"], **flags}, state,
                              batch)
    out["masks"], out["masks_redrawn"], out["mask_seed"] = _dropout_masks(
        pl, mesh)
    out["refused"] = _refusals(mesh)
    moe = {**pl["cfg"], "num_experts": 4, "context_parallel": True}
    out["moe"] = _raises(lambda: _cp_train(
        pl, mesh, moe, pl["moe_state"], batch, steps=1))
    model = _gpt({**pl["cfg"], "context_parallel": True}, pl["state"])
    model.eval()
    out["serve_mesh"] = _raises(lambda: LLMEngine(
        model, kv_layout="paged", mesh=mesh, max_seq_len=32))
    D.set_mesh(None)
    out["dp2"] = _cp_train(pl, D.build_mesh({"dp": world}), pl["cfg"],
                           pl["state"], batch)
    return out


def cp_dp2sep2(rank, world, pl):
    """dp 2 x sep 2 over four ranks: the context- and sequence-parallel
    GPT, 3 AdamW steps under loss masks of unequal counts per row and
    per chunk; then the pieces the mesh step cuts from a batch and from
    a window's stacked batch, and its error on a sequence that does not
    divide."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.jit.mesh import MeshPlan
    from paddle_tpu_torch.optimizer import AdamW
    mesh = D.build_mesh({"dp": 2, "sep": 2})
    flags = pl["runs"]["cp_sp"]
    cfg = {**pl["cfg"], **flags}
    out = {"train": _cp_train(pl, mesh, cfg, pl["state"],
                              (pl["ids"], pl["labels"], pl["masks"]))}
    model = _gpt(cfg, pl["state"])
    plan = MeshPlan(mesh, model, AdamW(1e-3, parameters=model.parameters()))
    batch = torch.arange(4 * 32).reshape(4, 32)
    window = torch.arange(2 * 4 * 32).reshape(2, 4, 32)
    out["rows"] = _np(plan.rows((batch, 7), False)[0])
    out["window_rows"] = _np(plan.rows((window,), True)[0])
    out["index"] = (mesh.index("dp"), mesh.index("sep"))
    out["odd_sequence"] = _raises(
        lambda: plan.rows((torch.zeros(4, 31),), False))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_pp_train.py and tests/test_torch_gpt_train.py
# ---------------------------------------------------------------------------

def _pp_step(pl, mesh, over=None, state="state", kind="step", control=None,
             steps=None):
    """The GPT of ``pl["cfg"]`` + ``over`` (``pl[state]``'s weights) built
    under ``mesh`` and trained AdamW steps on ``pl``'s batches through
    ``kind``: ``"step"`` (``CompiledTrainStep(mesh=)``), ``"dist"``
    (``DistributedTrainStep``) or a ``Pipeline1F1BTrainStep`` schedule.
    ``control``: ``"no_shift"`` (stage p + 1 receives zeros in place of
    the shifted activation) or ``"no_pp_sum"`` (the embedding's and the
    head's gradients not summed over pp).  Returns (losses, gathered
    state, ``dist.pp_shifts`` a step, the in-flight gauge)."""
    from paddle_tpu_torch.distributed import pipeline
    from paddle_tpu_torch.distributed.engine import (DistributedTrainStep,
                                                     Pipeline1F1BTrainStep)
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import counters
    cfg = {**pl["cfg"], **(over or {})}
    model = _gpt(cfg, pl[state])
    opt = AdamW(pl["lr"], parameters=model.parameters())
    crit = GPTPretrainingCriterion()
    aux = cfg.get("num_experts", 0) > 0

    def loss_fn(m, x, y):
        loss = crit(m(x), y)
        return loss + pl["aux_w"] * m.moe_aux_loss() if aux else loss

    if kind == "step":
        step = CompiledTrainStep(model, loss_fn, opt, mesh=mesh)
    elif kind == "dist":
        step = DistributedTrainStep(model, loss_fn, opt, mesh=mesh)
    else:
        step = Pipeline1F1BTrainStep(model, opt, num_microbatches=pl["M"],
                                     mesh=mesh, schedule=kind)
    if control == "no_pp_sum":
        step._mesh.sum_pp = False
    shift = pipeline._shift_pp

    def no_shift(x, mesh, step):
        y = shift(x, mesh, step)
        return torch.zeros_like(y) if step == 1 else y

    if control == "no_shift":
        pipeline._shift_pp = no_shift
    losses, shifts = [], []
    try:
        for i in range(len(pl["ids"]) if steps is None else steps):
            c0 = counters.snapshot()
            losses.append(float(step(torch.from_numpy(pl["ids"][i]),
                                     torch.from_numpy(pl["labels"][i]))))
            shifts.append(counters.delta(c0).get("dist.pp_shifts", 0))
    finally:
        pipeline._shift_pp = shift
    return (losses, model.gather_numpy_state(), shifts,
            counters.get("pipeline.max_in_flight", None))


def _pp_apply(pl, mesh, rank, with_aux):
    """``pipeline_apply`` GPipe on this rank's stage of ``pl["chain_w"]``
    (two tanh layers a stage): the output, the aux, and the gradients of
    ``(out ** 2).sum() + 0.5 * aux`` with respect to the stage's rows and
    the input."""
    from paddle_tpu_torch.distributed.pipeline import pipeline_apply
    P_ = mesh.degree("pp")
    w = torch.from_numpy(pl["chain_w"]).reshape(P_, -1, *pl[
        "chain_w"].shape[1:])[rank:rank + 1].clone().requires_grad_()
    x = torch.from_numpy(pl["chain_x"]).requires_grad_()

    def stage(sp, h):
        for i in range(sp["w"].shape[0]):
            h = torch.tanh(h @ sp["w"][i])
        return (h, (h ** 2).sum()) if with_aux else h

    out = pipeline_apply(stage, {"w": w}, x, pl["M"], mesh=mesh,
                         with_aux=with_aux)
    out, aux = out if with_aux else (out, torch.zeros(()))
    ((out ** 2).sum() + 0.5 * aux).backward()
    return (_np(out), float(aux.detach()), _np(w.grad[0]),
            None if x.grad is None else _np(x.grad))


def pp_2ranks(rank, world, pl):
    """pp 2 over the two ranks: ``pipeline_apply`` with and without aux;
    GPipe through ``CompiledTrainStep(mesh=)`` (tied) and
    ``DistributedTrainStep`` (untied), the interleaved schedule at V 2,
    ``Pipeline1F1BTrainStep`` 1F1B, each against the JAX step of the
    same schedule, GPipe and 1F1B under recompute; the two controls;
    dropout 0.1 twice under GPipe and under 1F1B; the logits of
    ``DistributedEvalStep``."""
    from paddle_tpu_torch import distributed as D
    mesh = D.build_mesh({"pp": world})
    out = {"apply": {a: _pp_apply(pl, mesh, rank, a) for a in (False, True)}}
    runs = {"gpipe": ({}, "state", "step"),
            "gpipe_untied": ({"tie_word_embeddings": False}, "state_untied",
                             "dist"),
            "interleaved": ({"pp_schedule": "interleaved",
                             "virtual_pp_degree": 2}, "state", "step"),
            "1f1b": ({}, "state", "1f1b"),
            "gpipe_recompute": ({"recompute": "selective"}, "state", "step"),
            "1f1b_recompute": ({"recompute": True}, "state", "1f1b")}
    for name, (over, state, kind) in runs.items():
        out[name] = _pp_step(pl, mesh, over, state, kind)
    from paddle_tpu_torch.distributed.engine import DistributedEvalStep
    model = _gpt(pl["cfg"], pl["state"])
    model.eval()
    out["eval"] = _np(DistributedEvalStep(model)(torch.from_numpy(
        pl["ids"][0])))
    for control in ("no_shift", "no_pp_sum"):
        out[control] = _pp_step(pl, mesh, control=control)
    drop = {"dropout": 0.1}
    out["dropout"] = {kind: [_pp_step(pl, mesh, drop, kind=kind, steps=2)[0]
                             for _ in range(2)]
                      for kind in ("step", "1f1b")}
    return out


def pp_moe_2ranks(rank, world, pl):
    """pp 2: an MoE GPT (2 experts) under GPipe through
    ``DistributedTrainStep``, its aux in the objective."""
    from paddle_tpu_torch import distributed as D
    return _pp_step(pl, D.build_mesh({"pp": world}), {"num_experts": 2},
                    "state_moe", "dist")


def pp_4ranks(rank, world, pl):
    """Four ranks: 1F1B over pp 2 x mp 2 (the manual tensor-parallel
    stages), zero-bubble over pp 4, then a pp 2 x sep 2 mesh, which the
    mesh step and the 1F1B step refuse, a pp 2 x sharding 2 mesh, which
    the mesh step refuses, and the ZeRO annotations at sharding 4."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.engine import Pipeline1F1BTrainStep
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    out = {"1f1b_mp2": _pp_step(pl, D.build_mesh({"pp": 2, "mp": 2}),
                                kind="1f1b")}
    D.set_mesh(None)
    out["zb_pp4"] = _pp_step(pl, D.build_mesh({"pp": 4}),
                             kind="zero_bubble")
    D.set_mesh(None)
    mesh = D.build_mesh({"pp": 2, "sep": 2})
    model = _gpt(pl["cfg"], pl["state"])
    opt = AdamW(1e-3, parameters=model.parameters())
    out["sep_refused"] = [
        _raises(lambda: CompiledTrainStep(model, lambda m, x: m(x).sum(),
                                          opt, mesh=mesh)),
        _raises(lambda: Pipeline1F1BTrainStep(model, opt, mesh=mesh))]
    D.set_mesh(None)
    mesh = D.build_mesh({"pp": 2, "sharding": 2})
    model = _gpt(pl["cfg"], pl["state"])
    out["sharding_refused"] = _raises(lambda: CompiledTrainStep(
        model, lambda m, x: m(x).sum(),
        AdamW(1e-3, parameters=model.parameters()), mesh=mesh))
    D.set_mesh(None)
    out["zero_storage"] = _zero_storage(D.build_mesh({"sharding": world}))
    return out


def _zero_storage(mesh):
    """For ZeRO stages 1 and 3 (``fleet.apply_fsdp_annotations`` at the
    mesh's sharding degree): each parameter's recorded specs and the
    storage spec ``MeshPlan`` takes from them, ``{stage: {name:
    (placements, _opt_state_spec, storage)}}``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit.mesh import MeshPlan
    from paddle_tpu_torch.optimizer import AdamW
    out = {}
    for stage in (1, 3):
        nn = paddle.nn
        model = nn.LayerList([nn.Embedding(64, 32), nn.Linear(32, 48),
                              nn.Linear(48, 8)])
        fleet.apply_fsdp_annotations(model, stage=stage)
        plan = MeshPlan(mesh, model, AdamW(1e-3,
                                           parameters=model.parameters()))
        out[stage] = {n: tuple(None if s is None else tuple(s) for s in (
            getattr(p._data, "placements", None),
            getattr(p._data, "_opt_state_spec", None),
            plan.storage.get(id(p._data))))
            for n, p in model.named_parameters()}
    return out


def pp_gpipe_smoke(rank, world, pl):
    """GPipe through ``CompiledTrainStep(mesh=build_mesh(pl["degrees"]))``,
    ``pl``'s steps: the losses, the gathered state, and the error of the
    mesh step handed a model built without the mesh."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    mesh = D.build_mesh(pl["degrees"])
    losses, state = _pp_step(pl, mesh)[:2]
    D.set_mesh(None)
    whole = _gpt(pl["cfg"], pl["state"])
    refused = _raises(lambda: CompiledTrainStep(
        whole, lambda m, x: m(x).sum(),
        AdamW(1e-3, parameters=whole.parameters()), mesh=mesh))
    return losses, state, refused


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_checkpoint.py
# ---------------------------------------------------------------------------

def _mse(m, x, y):
    from paddle_tpu_torch.core.tensor import unwrap
    return ((unwrap(m(x)) - y) ** 2).mean()


def ck_mlp(pl, mesh=None):
    """The MLP of ``pl`` (``Linear(8, 16)``, GELU, ``Linear(16, 4)``, the
    JAX net's weights) with AdamW, through the mesh step; at mp > 1 the
    weights' optimizer state splits over mp (the JAX test's rule).
    Returns (net, step)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.sharding_utils import P
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience.manager import model_state
    net = torch.nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 4))
    with torch.no_grad():
        for k, t in model_state(net).items():
            t.copy_(torch.from_numpy(pl["mlp_state"][k]))
    opt = AdamW(pl["mlp_lr"], parameters=net.parameters())
    rules = ([(r"\.weight$", P(None, "mp"))]
             if mesh is not None and mesh.degree("mp") > 1 else None)
    return net, CompiledTrainStep(net, _mse, opt, mesh=mesh,
                                  shard_rules=rules)


def ck_mlp_run(step, pl, lo, hi):
    return [float(step(torch.from_numpy(pl["xs"][i]),
                       torch.from_numpy(pl["ys"][i]))) for i in range(lo, hi)]


def ck_mlp_params(net):
    from paddle_tpu_torch.resilience.manager import model_state
    return {k: _np(t) for k, t in model_state(net).items()}


def ck_gpt(pl, mesh=None, over=None, state="state"):
    """The GPT of ``pl["cfg"]`` + ``over`` (``pl[state]``'s weights; built
    under the global mesh, a rank holds its shards) with AdamW, through
    the mesh step; an MoE model's aux joins the loss.  Returns (model,
    step)."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    cfg = {**pl["cfg"], **(over or {})}
    model = _gpt(cfg, pl[state])
    opt = AdamW(pl["lr"], parameters=model.parameters())
    crit = GPTPretrainingCriterion()
    loss = (_moe_loss(crit) if cfg.get("num_experts", 0) > 0
            else lambda m, x, y: crit(m(x), y))
    return model, CompiledTrainStep(model, loss, opt, mesh=mesh)


def ck_gpt_run(step, pl, lo, hi):
    return [float(step(torch.from_numpy(pl["ids"][i]),
                       torch.from_numpy(pl["labels"][i])))
            for i in range(lo, hi)]


def _ck_restore(step, root):
    """Restore ``root``'s newest checkpoint into ``step``: (info, the
    counters it moved)."""
    from paddle_tpu_torch.profiler import counters
    from paddle_tpu_torch.resilience import CheckpointManager
    c0 = counters.snapshot()
    info = CheckpointManager(root).restore(step)
    d = counters.delta(c0)
    info = {k: v for k, v in info.items() if k != "ms"}
    return info, {k: d.get(k, 0) for k in (
        "resilience.restores", "resilience.resharded_restores",
        "jit.syncs")}


def _ck_save(step, root, at):
    """Save ``step`` as step ``at`` under ``root``: the counters it moved
    and the bytes this rank wrote."""
    from paddle_tpu_torch.profiler import counters
    from paddle_tpu_torch.resilience import CheckpointManager
    c0 = counters.snapshot()
    mgr = CheckpointManager(root)
    mgr.save(step, at)
    d = counters.delta(c0)
    return {"syncs": d.get("jit.syncs", 0), "saves":
            d.get("resilience.saves", 0), "bytes": mgr.last_save["bytes"]}


def _ck_gpt_leg(pl, degrees, root, over=None, state="state"):
    """The GPT built under ``degrees``: 2 steps, a save (step 2) under
    ``root``, 2 more; then a fresh model under the same mesh restores
    and repeats the 2 (same-mesh).  Returns the record."""
    from paddle_tpu_torch import distributed as D
    D.set_mesh(None)
    mesh = D.build_mesh(degrees)
    model, step = ck_gpt(pl, mesh, over, state)
    out = {"first": ck_gpt_run(step, pl, 0, 2)}
    opt = step.optimizer
    attr = dict(zip(opt._param_names, (
        n for n, _ in torch.nn.Module.named_parameters(model))))
    out["state_dict"] = {
        acc: {attr[n]: _np(v) for n, v in store.items()}
        for acc, store in opt.state_dict()["accumulators"].items()}
    out["saved_state"] = model.gather_numpy_state()
    out["save"] = _ck_save(step, root, 2)
    out["cont"] = ck_gpt_run(step, pl, 2, 4)
    out["final"] = model.gather_numpy_state()
    model2, step2 = ck_gpt(pl, mesh, over, state)
    out["same_info"], out["same_counts"] = _ck_restore(step2, root)
    out["same_cont"] = ck_gpt_run(step2, pl, 2, 4)
    out["same_final"] = model2.gather_numpy_state()
    return out


def _ck_trainer(pl, mesh, root, schedule=None):
    """``FaultTolerantTrainer`` over the dp2 MLP: 6 steps of the global
    batches, a save every 2, under ``schedule``."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             FaultTolerantTrainer,
                                             faultinject)
    import contextlib
    net, step = ck_mlp(pl, mesh)
    ds = tio.TensorDataset([torch.from_numpy(np.concatenate(pl["xs"])),
                            torch.from_numpy(np.concatenate(pl["ys"]))])
    trainer = FaultTolerantTrainer(
        step, lambda e: tio.DataLoader(ds, batch_size=pl["xs"].shape[1],
                                       shuffle=False),
        CheckpointManager(root, keep_last=2), epochs=2, max_steps=6,
        save_every=2)
    with (faultinject.fault_schedule(schedule) if schedule
          else contextlib.nullcontext()):
        losses = trainer.run()
    return {"losses": losses, "params": ck_mlp_params(net),
            "recoveries": trainer.recoveries}


def ck_2ranks(rank, world, pl):
    """Two ranks: the JAX dp2 x mp2 saves restored at mp2 and their
    continuations; the port's mp2 saves (MLP, GPT); the GPT at
    ``sharding`` 2 saved, restored on the same mesh and at mp2; the sep2
    GPT with dropout saved and restored; the dp2 trainer with and
    without a preemption; ``counters.allreduce``."""
    import os
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.profiler import counters
    root = pl["root"]
    out = {}
    mesh = D.build_mesh({"mp": world})
    # JAX -> port at mp2
    net, step = ck_mlp(pl, mesh)
    info, counts = _ck_restore(step, pl["jax_mlp_dir"])
    out["jax_mlp"] = {"info": info, "counts": counts,
                      "cont": ck_mlp_run(step, pl, 3, 5),
                      "params": ck_mlp_params(net)}
    model, step = ck_gpt(pl, mesh)
    info, counts = _ck_restore(step, pl["jax_gpt_dir"])
    out["jax_gpt"] = {"info": info, "counts": counts,
                      "cont": ck_gpt_run(step, pl, 2, 4),
                      "state": model.gather_numpy_state()}
    # the port's mp2 saves, for the JAX package to restore
    net, step = ck_mlp(pl, mesh)
    first = ck_mlp_run(step, pl, 0, 3)
    save = _ck_save(step, os.path.join(root, "mlp_mp2"), 3)
    out["port_mlp"] = {"first": first, "save": save,
                       "cont": ck_mlp_run(step, pl, 3, 5),
                       "params": ck_mlp_params(net)}
    model, step = ck_gpt(pl, mesh)
    first = ck_gpt_run(step, pl, 0, 2)
    saved = model.gather_numpy_state()
    save = _ck_save(step, os.path.join(root, "gpt_mp2"), 2)
    out["port_gpt"] = {"first": first, "save": save, "saved_state": saved,
                       "qkv_w_shard": tuple(model.qkv_w.shape),
                       "cont": ck_gpt_run(step, pl, 2, 4),
                       "state": model.gather_numpy_state()}
    # storage sharding: saved, restored on the same mesh and at mp2
    out["sharding2"] = _ck_gpt_leg(pl, {"sharding": world},
                                   os.path.join(root, "sharding2"))
    D.set_mesh(None)
    mesh = D.build_mesh({"mp": world})
    model, step = ck_gpt(pl, mesh)
    info, counts = _ck_restore(step, os.path.join(root, "sharding2"))
    out["sharding2_to_mp2"] = {"info": info, "counts": counts,
                               "cont": ck_gpt_run(step, pl, 2, 4),
                               "state": model.gather_numpy_state()}
    # the sequence split with dropout: every rank's streams
    out["sep2"] = _ck_gpt_leg(pl, {"sep": world},
                              os.path.join(root, "sep2"),
                              {"dropout": 0.1, "context_parallel": True})
    # the trainer over dp2
    D.set_mesh(None)
    mesh = D.build_mesh({"dp": world})
    out["trainer"] = _ck_trainer(pl, mesh, os.path.join(root, "tr_base"))
    out["trainer_preempt"] = _ck_trainer(
        pl, mesh, os.path.join(root, "tr_preempt"), "preempt@3")
    counters.inc("test.mesh_checkpoint.rank_plus_one", rank + 1)
    out["allreduce"] = counters.allreduce()[
        "test.mesh_checkpoint.rank_plus_one"]
    return out


def ck_pp_moe_2ranks(rank, world, pl):
    """Two ranks: the pp2 GPT under GPipe and the interleaved schedule
    (V 2), and the dp2 expert-parallel MoE GPT, each saved after 2 steps
    and restored on the same mesh."""
    import os
    root = pl["root"]
    out = {}
    for name, degrees, over, state in (
            ("pp_gpipe", {"pp": world}, None, "state"),
            ("pp_interleaved", {"pp": world},
             {"pp_schedule": "interleaved", "virtual_pp_degree": 2},
             "state"),
            ("moe_dp2", {"dp": world}, pl["moe_over"], "moe_state")):
        out[name] = _ck_gpt_leg(pl, degrees, os.path.join(root, name),
                                over, state)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_auto_parallel.py
# ---------------------------------------------------------------------------

#: the JAX GPT's placements of its weights (``gpt.py`` ``mk``), as
#: auto-parallel placements on a one-axis ``mp`` mesh
GPT_MP_PLACEMENTS = {"wte": 0, "qkv_w": 2, "qkv_b": 1, "proj_w": 1,
                     "fc1_w": 2, "fc1_b": 1, "fc2_w": 1}


def gpt_shard_fn(pkg_ap):
    """A ``shard_layer`` ``shard_fn`` placing the GPT's weights as the
    tensor-parallel layers split them (``GPT_MP_PLACEMENTS``), the rest
    replicated."""
    def fn(name, layer, mesh):
        for pname, p in layer.named_parameters(include_sublayers=False):
            dim = GPT_MP_PLACEMENTS.get(pname)
            pl = [pkg_ap.Replicate() if dim is None else pkg_ap.Shard(dim)]
            pkg_ap.shard_tensor(p, mesh, pl)
    return fn


def _ap_moves(pl, rank):
    """The four moves of ``reshard`` on ``pl["x"]`` over mp2, with the
    local pieces and the whole values they give."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import auto_parallel as ap
    mesh = ap.ProcessMesh([0, 1], ["mp"])
    out = {}
    moves = {"s0_r": ([ap.Shard(0)], [ap.Replicate()]),
             "r_s1": ([ap.Replicate()], [ap.Shard(1)]),
             "s0_s1": ([ap.Shard(0)], [ap.Shard(1)])}
    for name, (src, dst) in moves.items():
        a = ap.shard_tensor(pl["x"], mesh, src)
        b = ap.reshard(a, mesh, dst)
        out[name] = {"src_local": _np(ap.dtensor_to_local(a)),
                     "dst_local": _np(ap.dtensor_to_local(b)),
                     "whole": _np(D.unshard_dtensor(b)),
                     "spec": tuple(b.placements)}
    part = ap.dtensor_from_local(pl["x"] * (rank + 1), mesh, [ap.Partial()])
    rep = ap.reshard(part, mesh, [ap.Replicate()])
    out["p_r"] = {"dst_local": _np(ap.dtensor_to_local(rep))}
    # Partial from a whole tensor: the summand on the axis' first rank
    pz = ap.shard_tensor(pl["x"], mesh, [ap.Partial()])
    out["p_from_whole"] = {"local": _np(ap.dtensor_to_local(pz)),
                           "whole": _np(D.unshard_dtensor(pz))}
    return out


def _ap_compat(rank, world):
    import paddle_tpu_torch.distributed as D
    out = {}
    ins = [torch.full((2,), float(10 * rank + i)) for i in range(world)]
    outs = []
    D.alltoall(outs, ins)
    out["alltoall"] = [_np(t) for t in outs]
    single = torch.empty(4)
    D.alltoall_single(single, torch.arange(4.0) + 10 * rank)
    out["alltoall_single"] = _np(single)
    got = D.gather(torch.full((3,), float(rank)), dst=1)
    out["gather"] = None if got is None else [_np(t) for t in got]
    objs = [{"rank": rank}, f"from {rank}"]
    D.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    mine = []
    D.scatter_object_list(mine, [f"to {r}" for r in range(world)]
                          if rank == 0 else None, src=0)
    out["scatter_object_list"] = mine
    return out


def _ap_train(pl):
    """The plain GPT of ``pl``, placed by :func:`gpt_shard_fn` on
    ``ProcessMesh([0, 1], ["mp"])`` and trained through ``to_static``
    with AdamW: (losses, gathered state, the optimizer's moment shape of
    ``qkv_w``)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    D.set_mesh(None)
    model = _gpt(pl["cfg"], pl["state"])
    mesh = ap.ProcessMesh([0, 1], ["mp"])
    ap.shard_layer(model, mesh, gpt_shard_fn(ap))
    opt = ap.shard_optimizer(AdamW(pl["lr"], parameters=model.parameters()))
    step = ap.to_static(model, loss=GPTPretrainingCriterion(),
                        optimizer=opt)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in zip(pl["ids"], pl["labels"])]
    moment = opt._accumulators["moment1"][id(model._parameters["qkv_w"])]
    return {"losses": losses, "state": model.gather_numpy_state(),
            "qkv_w_moment": tuple(moment.shape),
            "step_type": type(step).__name__,
            "placements": {n: tuple(getattr(p, "placements", ()) or ())
                           for n, p in torch.nn.Module.named_parameters(
                               model)}}


def auto_parallel_2ranks(rank, world, pl):
    return {"moves": _ap_moves(pl, rank), "compat": _ap_compat(rank, world),
            "train": _ap_train(pl)}


def spawn_env(path):
    """A child of ``distributed.spawn``: write the launcher variables it
    was given to ``path`` + its PID."""
    import json
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
            "PADDLE_LOCAL_RANK")
    with open(f"{path}.{os.getpid()}", "w") as f:
        json.dump({k: os.environ.get(k) for k in keys}, f)
