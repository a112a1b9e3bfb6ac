"""The port's launcher, ``spawn`` and elastic agent
(``paddle_tpu_torch.distributed.launch``/``spawn``/``elastic``) against
the JAX package's.

Everything starts at once in the module's fixture and each test reads
its part:

* both launchers run one torch-free script at ``--nproc_per_node`` 1
  and 2 with the same ``--master``; the ``PADDLE_*`` variables the ranks
  see agree, each package sets its own card variable
  (``FLAGS_selected_gpus`` in the port; ``FLAGS_selected_tpus`` and
  ``COORDINATOR_ADDRESS`` in the JAX package only), and a failing rank's
  exit code comes back;
* both agents supervise one torch-free script that crashes, hangs
  (heartbeat timeout 2 s), fails the same rank twice (shrink) or keeps
  failing (``max_restarts``): their event kinds, restart counts, shrink
  decisions and exit codes are equal; the port's survivor of a shrink
  keeps its own slot's card;
* the port's agent supervises two gloo ranks training a 2-layer,
  64-wide GPT over mp2 through ``FaultTolerantTrainer``; rank 1 dies
  right after the checkpoints of step 2 (incarnation 0) and step 4
  (incarnation 1), so three incarnations rendezvous in a row, and the
  losses of the three equal an uninterrupted run's (the non-elastic
  launcher's) bit for bit;
* ``spawn``: the port's children get the launcher's variables, the JAX
  package's none (ROADMAP.md C).
"""

import json
import os
import subprocess
import sys
import socket
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

import _torch_mesh_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV_SCRIPT = textwrap.dedent("""
    import json, os, sys
    env = {k: v for k, v in os.environ.items()
           if k.startswith(("PADDLE_", "FLAGS_selected", "COORDINATOR"))}
    rank = os.environ["PADDLE_TRAINER_ID"]
    with open(os.path.join(sys.argv[1], f"env.{rank}.json"), "w") as f:
        json.dump(env, f)
    print(json.dumps(env))
    sys.exit(int(sys.argv[2]) if rank == "1" else 0)
""")

AGENT_SCRIPT = textwrap.dedent("""
    import json, os, sys, time
    mode, out = sys.argv[1], sys.argv[2]
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    n = int(os.environ["PADDLE_TRAINERS_NUM"])
    restart = int(os.environ["PADDLE_RESTART_COUNT"])
    with open(os.path.join(out, f"seen.r{restart}.{rank}.json"), "w") as f:
        json.dump({"n": n, "dev": os.environ.get(
            "FLAGS_selected_gpus", os.environ.get("FLAGS_selected_tpus"))},
            f)
    hb = os.environ["PADDLE_ELASTIC_HEARTBEAT_FILE"]
    open(hb, "a").close()
    os.utime(hb, None)
    if mode == "crash" and restart == 0 and rank == 1:
        sys.exit(17)
    if mode == "hang" and restart == 0 and rank == 0:
        time.sleep(60)
    if mode == "shrink" and n == 2 and rank == 1:
        sys.exit(5)
    if mode == "shrink0" and n == 2 and rank == 0:
        sys.exit(5)
    if mode == "giveup":
        sys.exit(3)
    time.sleep(0.3)
""")

GPT_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             FaultTolerantTrainer)
    paddle.set_device("cpu")
    torch.set_num_threads(1)
    out, mode = sys.argv[1], sys.argv[2]
    restart = int(os.environ.get("PADDLE_RESTART_COUNT", 0))
    D.init_parallel_env()
    rank, world = D.get_rank(), D.get_world_size()
    D.build_mesh({"mp": world})
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=16, use_flash_attention=False)
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    crit = GPTPretrainingCriterion()
    step = D.DistributedTrainStep(model, lambda m, x, y: crit(m(x), y),
                                  AdamW(1e-3, parameters=model.parameters()))
    g = torch.Generator().manual_seed(1)
    ids, labels = (torch.randint(0, 128, (24, 16), generator=g)
                   for _ in range(2))
    ds = tio.TensorDataset([ids, labels])
    trainer = None

    def record():
        with open(os.path.join(out, f"losses.r{restart}.{rank}.json"),
                  "w") as f:
            json.dump({str(k): v for k, v in trainer.losses.items()}, f)

    class CrashAfterSave(CheckpointManager):
        def save(self, train_step, at, **kw):
            super().save(train_step, at, **kw)
            self.wait()
            record()
            if mode == "crash" and rank == 1 and (restart, at) in (
                    (0, 2), (1, 4)):
                os._exit(17)

    trainer = FaultTolerantTrainer(
        step, lambda e: tio.DataLoader(ds, batch_size=4, shuffle=False),
        CrashAfterSave(os.path.join(out, "ckpt")), max_steps=6,
        save_every=2)
    trainer.run()
    record()
    D.reset_parallel_env()
""")

AGENT_MODES = {
    "crash": dict(nproc=2, max_restarts=3),
    "hang": dict(nproc=2, max_restarts=3, heartbeat_timeout=2),
    "shrink": dict(nproc=2, max_restarts=3, min_nproc=1),
    "shrink0": dict(nproc=2, max_restarts=3, min_nproc=1),
    "giveup": dict(nproc=1, max_restarts=2),
}


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep
            + os.environ.get("PYTHONPATH", ""), "JAX_PLATFORMS": "cpu"}


def _launcher(pkg, tmp, nproc, code):
    d = tmp / f"launch_{pkg}_{nproc}"
    d.mkdir()
    script = d / "env.py"
    script.write_text(ENV_SCRIPT)
    mod = ("paddle_tpu" if pkg == "jax" else "paddle_tpu_torch") \
        + ".distributed.launch"
    r = subprocess.run(
        [sys.executable, "-m", mod, f"--nproc_per_node={nproc}",
         "--master", "127.0.0.1:29555", "--log_dir", str(d / "log"),
         str(script), str(d), str(code)],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    envs = [json.loads((d / f"env.{r_}.json").read_text())
            for r_ in range(nproc)]
    return r.returncode, envs, r.stdout


def _agent(pkg, tmp, mode, devices=None):
    if pkg == "jax":
        from paddle_tpu.distributed.elastic import ElasticAgent
    else:
        from paddle_tpu_torch.distributed.elastic import ElasticAgent
    d = tmp / f"agent_{pkg}_{mode}_{devices}"
    d.mkdir()
    script = d / "w.py"
    script.write_text(AGENT_SCRIPT)
    kw = dict(AGENT_MODES[mode])
    if devices is not None:
        kw["devices"] = devices
    agent = ElasticAgent([sys.executable, str(script), mode, str(d)],
                         log_dir=str(d / "log"), poll_interval=0.1,
                         env=_env(), **kw)
    rc = agent.run()
    seen = {p.name: json.loads(p.read_text()) for p in d.glob("seen.*")}
    return rc, agent.events, agent.restart_count, seen


def _gpt(tmp, elastic):
    d = tmp / ("gpt_elastic" if elastic else "gpt_ref")
    d.mkdir()
    script = d / "train.py"
    script.write_text(GPT_SCRIPT)
    args = ["--elastic", "--max_restarts", "3"] if elastic else \
        ["--master", f"127.0.0.1:{_free_port()}"]
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--log_dir", str(d / "log"), *args,
         str(script), str(d), "crash" if elastic else "clean"],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=_env())
    losses = {p.name: json.loads(p.read_text()) for p in d.glob("losses.*")}
    events = []
    ev = d / "log" / "elastic_events.jsonl"
    if ev.exists():
        events = [json.loads(line) for line in ev.read_text().splitlines()]
    return r.returncode, losses, events, r.stderr


def _spawn(pkg, tmp):
    if pkg == "jax":
        from paddle_tpu.distributed import spawn
    else:
        from paddle_tpu_torch.distributed import spawn
    d = tmp / f"spawn_{pkg}"
    d.mkdir()
    procs = spawn(W.spawn_env, args=(str(d / "env"),), nprocs=2)
    return [p.exitcode for p in procs], [json.loads(p.read_text())
                                         for p in d.glob("env.*")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    jobs = {}
    with ThreadPoolExecutor(max_workers=20) as ex:
        jobs["gpt_elastic"] = ex.submit(_gpt, tmp, True)
        jobs["gpt_ref"] = ex.submit(_gpt, tmp, False)
        for pkg in ("jax", "port"):
            for nproc, code in ((1, 0), (2, 3)):
                jobs[("launch", pkg, nproc)] = ex.submit(
                    _launcher, pkg, tmp, nproc, code)
            for mode in AGENT_MODES:
                jobs[("agent", pkg, mode)] = ex.submit(_agent, pkg, tmp,
                                                       mode)
        jobs[("agent", "port", "shrink", "0,0")] = ex.submit(
            _agent, "port", tmp, "shrink", [0, 0])
        jobs[("agent", "port", "shrink0", "3,5")] = ex.submit(
            _agent, "port", tmp, "shrink0", [3, 5])
        for pkg in ("jax", "port"):
            jobs[("spawn", pkg)] = ex.submit(_spawn, pkg, tmp)
        return {k: v.result() for k, v in jobs.items()}


LAUNCH_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
               "PADDLE_LOCAL_RANK")


@pytest.mark.parametrize("nproc", [1, 2])
def test_launcher_env_matches_jax(runs, nproc):
    jrc, jenvs, _ = runs[("launch", "jax", nproc)]
    prc, penvs, pout = runs[("launch", "port", nproc)]
    # a failing rank's code comes back (rank 1 exits 3 at nproc 2)
    assert prc == jrc == (0 if nproc == 1 else 3)
    for r, (je, pe) in enumerate(zip(jenvs, penvs)):
        assert {k: pe.get(k) for k in LAUNCH_KEYS} == \
            {k: je.get(k) for k in LAUNCH_KEYS}, r
        assert pe["PADDLE_TRAINER_ID"] == str(r)
        assert pe["PADDLE_MASTER"] == "127.0.0.1:29555"
        # each package's own card variable
        assert pe["FLAGS_selected_gpus"] == je["FLAGS_selected_tpus"] == \
            str(r)
        assert "FLAGS_selected_tpus" not in pe
        assert "COORDINATOR_ADDRESS" not in pe
        assert je["COORDINATOR_ADDRESS"] == "127.0.0.1:29555"
        assert "FLAGS_selected_gpus" not in je
    assert json.loads(pout.strip().splitlines()[-1]) == penvs[0]


def _kinds(events):
    return [e[1] for e in events]


@pytest.mark.parametrize("mode", sorted(AGENT_MODES))
def test_agent_decisions_match_jax(runs, mode):
    jrc, jev, jrestarts, jseen = runs[("agent", "jax", mode)]
    prc, pev, prestarts, pseen = runs[("agent", "port", mode)]
    assert prc == jrc == (1 if mode == "giveup" else 0)
    assert _kinds(pev) == _kinds(jev)
    assert prestarts == jrestarts
    want = {"crash": ["launch", "failure", "launch", "done"],
            "hang": ["launch", "failure", "launch", "done"],
            "shrink": ["launch", "failure", "launch", "failure", "shrink",
                       "launch", "done"],
            "giveup": ["launch", "failure"] * 3 + ["giveup"]}
    want["shrink0"] = want["shrink"]
    assert _kinds(pev) == want[mode]
    for (_, k, jd), (_, _, pd) in zip(jev, pev):
        if k == "shrink":
            assert pd.split()[:2] == jd.split()[:2]
        if k == "failure" and mode == "hang":
            assert "heartbeat stale" in pd and "heartbeat stale" in jd
    # the world the last incarnation saw (an earlier one's other rank
    # may be killed before it starts)
    last = f"seen.r{prestarts}."
    assert {k: v["n"] for k, v in pseen.items() if k.startswith(last)} == \
        {k: v["n"] for k, v in jseen.items() if k.startswith(last)}


@pytest.mark.parametrize("mode,devices,survivor", [
    ("shrink", "0,0", "0"), ("shrink0", "3,5", "5")])
def test_shrink_keeps_the_survivors_card(runs, mode, devices, survivor):
    """The shrink drops the failed rank's slot, not its card: two slots
    on card 0 keep card 0 when rank 1 goes; with cards 3 and 5, rank 0's
    double failure leaves the survivor on 5.  The JAX agent's survivor
    takes the first device left in ``range(nproc)``."""
    rc, events, _, seen = runs[("agent", "port", mode, devices)]
    assert rc == 0 and _kinds(events)[-3:] == ["shrink", "launch", "done"]
    last = max(int(k.split(".")[1][1:]) for k in seen)
    assert seen[f"seen.r{last}.0.json"] == {"n": 1, "dev": survivor}
    _, _, _, jseen = runs[("agent", "jax", mode)]
    assert jseen[f"seen.r{last}.0.json"]["dev"] == \
        ("0" if mode == "shrink" else "1")


def test_gpt_resumes_bit_for_bit_over_three_incarnations(runs):
    """Three incarnations rendezvous in a row (a fresh ``file://`` store
    each); the losses of steps 1-2, 3-4 and 5-6 are the uninterrupted
    run's, bit for bit, on both ranks."""
    rc, losses, events, err = runs["gpt_elastic"]
    ref_rc, ref, _, ref_err = runs["gpt_ref"]
    assert ref_rc == 0, ref_err
    assert rc == 0, (err, events)
    assert _kinds(events) == ["launch", "failure", "launch", "failure",
                              "launch", "done"]
    for rank in (0, 1):
        want = ref[f"losses.r0.{rank}.json"]
        assert sorted(want) == [str(i) for i in range(1, 7)]
        got = {}
        for restart, steps in ((0, (1, 2)), (1, (3, 4)), (2, (5, 6))):
            mine = losses[f"losses.r{restart}.{rank}.json"]
            assert all(str(s) in mine for s in steps), (restart, mine)
            got.update({str(s): mine[str(s)] for s in steps})
        assert got == want, rank
    assert ref["losses.r0.0.json"] == ref["losses.r0.1.json"]


def test_spawn_gives_the_launcher_variables(runs):
    pcodes, penvs = runs[("spawn", "port")]
    jcodes, jenvs = runs[("spawn", "jax")]
    assert pcodes == jcodes == [0, 0]
    assert sorted(e["PADDLE_TRAINER_ID"] for e in penvs) == ["0", "1"]
    assert {e["PADDLE_TRAINERS_NUM"] for e in penvs} == {"2"}
    assert len({e["PADDLE_MASTER"] for e in penvs}) == 1
    assert all(v is None for e in jenvs for v in e.values())


def test_heartbeat_is_a_no_op_outside_elastic_runs(tmp_path, monkeypatch):
    """``heartbeat()`` touches the file the agent names and nothing
    else; ``CompiledTrainStep`` beats once a call."""
    import torch
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.distributed.elastic import heartbeat
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import SGD
    monkeypatch.delenv("PADDLE_ELASTIC_HEARTBEAT_FILE", raising=False)
    heartbeat()
    hb = tmp_path / "hb"
    monkeypatch.setenv("PADDLE_ELASTIC_HEARTBEAT_FILE", str(hb))
    # the default device, restored after the test
    monkeypatch.setattr(tdevice, "_CURRENT", [torch.device("cpu")])
    net = torch.nn.Linear(2, 1)
    step = CompiledTrainStep(net, lambda m, x: m(x).square().mean(),
                             SGD(0.1, parameters=net.parameters()))
    step(torch.ones(3, 2))
    assert hb.exists()
    os.utime(hb, (0, 0))
    step(torch.ones(3, 2))
    assert os.path.getmtime(hb) > 0
