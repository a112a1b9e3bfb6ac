"""The serving fleet's control plane on a tensor-parallel mesh of two
ranks: fault injection, crash respawn, the autoscaler, deadlines and
cancels, each decided on mesh rank 0 and applied on every rank, held
against the JAX package's fleet and engine on its two-device ``mp`` mesh
(``tests/test_fleet.py``, ``tests/test_serving.py`` and
``tests/test_torch_fleet.py`` pin the JAX behaviour).

The port's mp2 fleets run in two spawned gloo ranks
(``tests/_torch_mesh_workers.py`` ``fleet_control_mp2``, one spawn for
the module) on the JAX model's fp32 weights (``load_numpy_state``); the
JAX fleets run here through the same scenario functions (``control_*``:
both packages' classes take the same arguments).  Decoding is greedy and
the tolerance is token equality.  What only rank 0 does in a scenario
models what one rank sees alone: the fault schedule is installed, the
hung replica's heartbeat set back and the latency burns recorded on rank
0 only, and rank 1's clock runs an hour ahead of rank 0's in the
deadline scenarios.

What is held:

* ``replica_crash@0;decode_stall@1`` on a unified pair, the crash on a
  disaggregated pair, and ``kv_migrate_drop@0,kv_migrate_drop@2``: the
  tokens, finish reasons, retries, faults fired and ``serving.fleet.*``
  movement of each rank equal the JAX fleet's;
* an exception out of a replica's engine step on every rank: the replica
  is drained and respawned once, and its request replays to the tokens
  of a fleet without the fault;
* ``router_queue`` sheds with JAX's ``RetryAfter`` on both ranks;
* the autoscaler's two patterns (disaggregate on an ITL burn; grow the
  prefill side, then retire): each rank's roles and replica counts after
  every tick, the autoscaler's history and its counters equal JAX's, and
  a threaded fleet equals the pumped one;
* ``spawn_replica``, ``set_role`` and ``retire_replica`` called on both
  ranks leave JAX's replicas and serve JAX's tokens;
* deadlines, paged, slot and speculative engines and the fleet: a
  queued request expires before prefill, a running one is evicted with
  its partial output (the speculative one at the sweep before its next
  round), by rank 0's clock, as in JAX;
* a cancel that rank 1's caller makes one pump before rank 0's takes
  effect at the same tick on both ranks (the race of a threaded fleet;
  without the repair the ranks stepped different batches), and a
  threaded cancel during a crash's replay terminates with nothing lost;
* a mesh engine's decode step without a deadline issues as many
  collectives as before the control plane, and one with a deadline one
  more (rank 0's verdict);
* two ranks sharing ``FLAGS_flight_dir`` leave one ``replica_died``
  bundle each.
"""

import numpy as np
import pytest

import _torch_mesh_workers as W

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, initializer_range=0.3, use_flash_attention=False)
_RNG = np.random.default_rng(22)
PROMPTS = [_RNG.integers(1, 64, size=n).tolist() for n in (5, 6, 9, 7)]
PAIR = PROMPTS[:2]
DISAGG = dict(prefill_replicas=1, max_retries=2)
CHAOS = {
    "crash_stall": dict(prompts=PAIR, stall=True,
                        schedule="replica_crash@0;decode_stall@1"),
    "disagg_crash": dict(prompts=PROMPTS, kw=DISAGG,
                         schedule="replica_crash@0"),
    "disagg_drop": dict(prompts=PROMPTS, kw=DISAGG,
                        schedule="kv_migrate_drop@0,kv_migrate_drop@2"),
}
#: the clean runs the faulted ones are held to (JAX side)
CLEAN = {"crash_stall": dict(prompts=PAIR, schedule=None),
         "disagg": dict(prompts=PROMPTS, kw=DISAGG, schedule=None)}
GROW = dict(prompts=PROMPTS[:3], hist="serving.ttft_ns",
            pattern=[False, True, False, False, False, False],
            kw=dict(replicas=2, prefill_replicas=1,
                    autoscale_kw=dict(cooldown_ticks=0, ok_streak=2,
                                      max_replicas=3)))
AUTOSCALE = {
    "autoscale_disagg": dict(
        prompts=PROMPTS[:3], hist="serving.itl_ns",
        pattern=[False, True, False, False], submit_at=(0, 3),
        kw=dict(replicas=2, autoscale_kw=dict(cooldown_ticks=1,
                                              ok_streak=100))),
    "autoscale_grow": GROW,
    "autoscale_grow_threaded": dict(GROW, threaded=True),
}
#: ``dist.collective_launches`` of one decode step of the 2-layer model
#: at mp2 before the control plane: 2 all-reduces a layer, the
#: embedding's, the head's gather and rank 0's token broadcast
DECODE_COLLECTIVES = 7


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_registries():
    """The JAX fleets here fill the JAX package's global registries:
    cleared after the module."""
    yield
    from paddle_tpu.profiler import devicetime, flight, metrics, trace
    from paddle_tpu.resilience import faultinject
    metrics.reset_metrics()
    flight.clear()
    trace.clear()
    devicetime.reset()
    faultinject.clear()


def _jax_model():
    import paddle_tpu as jp
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    jp.seed(0)
    m = GPTForCausalLM(GPTConfig(**CFG))
    m.eval()
    return m, {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _jax_side(jm, mesh):
    from paddle_tpu.serving import LLMEngine, ServingFleet
    out = {name: W.control_chaos(ServingFleet, jm, mesh, 0, **a)
           for name, a in {**CHAOS, **{f"clean_{k}": v
                                       for k, v in CLEAN.items()}}.items()}
    out["router_queue"] = W.control_router_queue(ServingFleet, jm, mesh, 0)
    for name, a in AUTOSCALE.items():
        if not a.get("threaded"):
            out[name] = W.control_autoscale(ServingFleet, jm, mesh, 0, **a)
    out["user_calls"] = W.control_user_calls(ServingFleet, jm, mesh,
                                             PROMPTS)
    for layout in ("paged", "slots", "spec"):
        out[f"deadline_{layout}"] = W.control_engine_deadlines(
            LLMEngine, jm, mesh, 0, PROMPTS, layout)
    out["deadline_fleet"] = W.control_fleet_deadlines(ServingFleet, jm, mesh,
                                                      0, PROMPTS)
    out["cancel_race"] = W.control_cancel_race(ServingFleet, jm, mesh, 0,
                                               PROMPTS)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import jax
    from jax.sharding import Mesh
    jm, state = _jax_model()
    tmp = tmp_path_factory.mktemp("fc")
    flight_dir = tmp / "flight"
    flight_dir.mkdir()
    ranks = W.spawn("fleet_control_mp2", 2, tmp, {
        "cfg": CFG, "state": state, "prompts": PROMPTS, "chaos": CHAOS,
        "autoscale": AUTOSCALE, "flight_dir": str(flight_dir)})
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    return _jax_side(jm, mesh), ranks.results()


def _as_jax(served, key, keys=("tokens", "reasons", "retries", "fired",
                               "moved")):
    """Each rank's result under ``key`` equals the JAX fleet's in
    ``keys``."""
    j, res = served
    for out in res:
        for k in keys:
            assert out[key][k] == j[key][k], (key, k)
    return j[key]


def _clean(served, name):
    return served[0][f"clean_{name}"]["tokens"]


def test_mp2_crash_and_stall_as_jax(served):
    """The schedule and the set-back heartbeat on rank 0 only: both ranks
    fire both faults, see the same replica hang, drain and respawn both
    replicas, and replay to the unfaulted tokens."""
    j = _as_jax(served, "crash_stall", keys=("tokens", "reasons", "retries",
                                             "fired", "moved", "hung"))
    assert j["tokens"] == _clean(served, "crash_stall")
    _, res = served
    for out in res:
        rec = out["crash_stall"]
        assert rec["fired"] == [("decode_stall", 1), ("replica_crash", 0)]
        assert rec["retries"] == [1, 1]
        m = rec["moved"]
        assert (m["serving.fleet.replica_deaths"],
                m["serving.fleet.respawns"],
                m.get("serving.fleet.lost", 0)) == (2, 2, 0)


@pytest.mark.parametrize("name", ["disagg_crash", "disagg_drop"])
def test_mp2_disaggregated_faults_as_jax(served, name):
    j = _as_jax(served, name)
    assert j["tokens"] == _clean(served, "disagg")
    assert j["reasons"] == ["length"] * len(PROMPTS)
    _, res = served
    for out in res:
        m = out[name]["moved"]
        if name == "disagg_drop":
            assert m["serving.fleet.migrate.dropped"] == 2
        else:
            assert m["serving.fleet.replica_deaths"] == 1
        assert m.get("serving.fleet.lost", 0) == 0


def test_mp2_replica_step_exception_respawns(served):
    """An exception out of the replica's engine step on both ranks: the
    next tick's gathered verdict drains it and respawns it once on each
    rank, and the request replays to the unfaulted fleet's tokens."""
    _, res = served
    for out in res:
        rec = out["crash"]
        assert (rec["deaths"], rec["respawns"]) == (1, 1)
        assert rec["reason"] == "length"
        assert rec["tokens"] == out["crash_ref"]


def test_mp2_router_queue_sheds_as_jax(served):
    j = _as_jax(served, "router_queue", keys=("shed", "tokens", "fired",
                                              "moved"))
    assert j["shed"] == ("router_queue", 0.0)
    assert j["fired"] == [("router_queue", 1)]


@pytest.mark.parametrize("name", ["autoscale_disagg", "autoscale_grow"])
def test_mp2_autoscaler_as_jax(served, name):
    """Burns on rank 0 only: rank 0's alerts, and every rank's roles and
    replica counts tick by tick, history and ``serving.autoscale.*``
    equal the JAX fleet's."""
    j, res = served
    want = j[name]
    assert res[0][name]["trail"] == want["trail"]
    for out in res:
        rec = out[name]
        assert [t[1] for t in rec["trail"]] == [t[1] for t in want["trail"]]
        assert rec["history"] == want["history"]
        assert rec["moved"] == want["moved"]
        assert rec["reasons"] == want["reasons"]
    assert all(not t[0] for t in res[1][name]["trail"])
    actions = [h["action"] for h in want["history"]]
    if name == "autoscale_grow":
        assert actions == ["grow_prefill", "retire"]
        assert (want["moved"]["serving.autoscale.spawns"],
                want["moved"]["serving.autoscale.retires"]) == (1, 1)
    else:
        assert actions == ["disaggregate"]


def test_mp2_threaded_autoscaler_equals_pumped(served):
    _, res = served
    for out in res:
        got, want = out["autoscale_grow_threaded"], out["autoscale_grow"]
        assert [t[1] for t in got["trail"]] == [t[1] for t in want["trail"]]
        for k in ("history", "moved", "reasons"):
            assert got[k] == want[k]


def test_mp2_user_calls_as_jax(served):
    j = _as_jax(served, "user_calls", keys=("views", "tokens", "moved"))
    assert [len(v) for v in j["views"]] == [3, 3, 2]
    assert j["moved"]["serving.fleet.migrate.requests"] > 0


@pytest.mark.parametrize("name", ["deadline_paged", "deadline_slots",
                                  "deadline_spec", "deadline_fleet"])
def test_mp2_deadlines_by_rank0_clock_as_jax(served, name):
    """Rank 1's clock runs an hour ahead: were it read, every deadline
    would expire at once.  Both ranks evict by rank 0's, as the JAX
    engine does: the 0 s request before prefill, the 60 s one after the
    clock moved past it, with its partial output."""
    j = _as_jax(served, name, keys=("tokens", "reasons", "first",
                                    "counters"))
    assert j["reasons"] == ["deadline", "length", "deadline"]
    assert j["tokens"][0] == [] and len(j["tokens"][2]) == j["first"] >= 1
    assert j["counters"]["serving.deadline_expired"] == 1


def test_mp2_cancel_race_applied_at_rank0s_tick(served):
    """Rank 1's caller cancels one pump before rank 0's: the cancel is
    posted and applied at the tick rank 0's count reaches it, so both
    ranks evict the request at the step JAX does."""
    _as_jax(served, "cancel_race", keys=("tokens", "reasons"))
    assert served[0]["cancel_race"]["reasons"] == ["cancelled", "length"]


def test_mp2_threaded_cancel_during_churn_terminates(served):
    _, res = served
    for out in res:
        rec = out["cancel_churn"]
        assert rec["reason"] in ("cancelled", "retried", "length")
        assert rec["lost"] == 0


@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_mp2_decode_step_collectives(served, layout):
    _, res = served
    for out in res:
        assert out[f"collectives_{layout}"] == [
            (DECODE_COLLECTIVES, 1), (DECODE_COLLECTIVES + 1, 1)]


def test_mp2_flight_bundles_one_per_rank(served):
    _, res = served
    names = res[0]["flight"]
    assert names == res[1]["flight"] and len(names) == 2
    assert sum("-rank1-" in n for n in names) == 1
