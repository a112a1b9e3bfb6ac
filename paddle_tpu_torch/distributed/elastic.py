"""Elastic training: worker supervision, a heartbeat watchdog and the
relaunch (port of ``paddle_tpu/distributed/elastic.py``; reference:
fleet/elastic/manager.py:124, ElasticManager, and the comm-task watchdog
paddle/phi/core/distributed/comm_task_manager.cc:171-217).

One agent on one host owns the worker processes, one a rank.  A worker
that exits non-zero, or whose heartbeat file goes stale, makes the agent
kill the whole world and launch it again; the new world resumes from
the newest checkpoint (``resilience.CheckpointManager``, whose restore
reshards when the world shrank).  This is what recovers a rank process
that dies: the other ranks of its world would wait in their next
collective until its timeout, so the agent ends them and starts over.

**What the heartbeat marks.**  The train steps (``jit.CompiledTrainStep``
and so ``distributed.DistributedTrainStep``) call :func:`heartbeat` when
they are called, that is when the host enqueues a step.  Kernels run
asynchronously, so a kernel that hangs stalls the host only once the
queue blocks (a synchronising read such as the loss's ``float``, or a
host-side collective), and the heartbeat goes stale only then.  What
the watchdog catches is a host that stopped issuing steps: a wedged
collective, a stuck loader, a sleeping process.

**Devices.**  Each rank's slot has a card (``devices``; default slot
``r`` on card ``r``), passed as ``FLAGS_selected_gpus``, which
``distributed.init_parallel_env`` selects.  Several slots may share a
card (``devices=[0, 0]``: two gloo ranks on one card).  A shrink
excludes the failed rank's slot, never every slot on its card, so the
survivors keep their own cards.

**Rendezvous.**  Each incarnation gets a fresh ``file://`` store under
``log_dir`` (``rendezvous.r<restart>``) as ``PADDLE_MASTER``, unless the
caller fixed ``master``: a relaunched world never meets the store of
the world it replaced.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time

_HEARTBEAT_ENV = "PADDLE_ELASTIC_HEARTBEAT_FILE"


def heartbeat():
    """Touch this worker's heartbeat file (a no-op outside elastic runs).
    The train steps call it at every call; any training loop may."""
    path = os.environ.get(_HEARTBEAT_ENV)
    if not path:
        return
    try:
        with open(path, "a"):
            os.utime(path, None)
    except OSError:
        pass


class ElasticAgent:
    """Supervise ``nproc`` worker processes with restart on failure.

    - A worker exiting non-zero (or a heartbeat staler than
      ``heartbeat_timeout`` seconds) kills the whole world and launches it
      again, up to ``max_restarts`` times.  ``PADDLE_RESTART_COUNT`` tells
      the workers which incarnation they are.
    - Shrinkable worlds: if ``min_nproc`` < nproc and the same rank fails
      twice in a row, the relaunch drops that rank's slot and runs one
      process fewer; the checkpoint's reshard-on-load absorbs the new
      world size.
    - ``events`` lists ``(wallclock, kind, detail)``: ``launch``,
      ``failure``, ``shrink``, ``giveup``, ``done``; each is also appended
      to ``log_dir/elastic_events.jsonl`` for whoever started the agent
      in another process (the launcher).
    """

    def __init__(self, cmd, nproc, log_dir="log", max_restarts=3,
                 heartbeat_timeout=None, min_nproc=None, env=None,
                 master=None, poll_interval=0.5, devices=None):
        self.cmd = cmd
        self.nproc = nproc
        self.log_dir = os.path.abspath(log_dir)
        self.max_restarts = max_restarts
        self.heartbeat_timeout = heartbeat_timeout
        self.min_nproc = min_nproc or nproc
        self.base_env = dict(env if env is not None else os.environ)
        self.master = master
        self.poll_interval = poll_interval
        self.devices = (list(range(nproc)) if devices is None
                        else [int(d) for d in devices])
        if len(self.devices) != nproc:
            raise ValueError(f"devices {self.devices}: one a rank's slot "
                             f"({nproc} slots)")
        self.restart_count = 0
        self.events = []
        self.bad_slots = set()  # excluded after a repeated same-rank failure

    def _slot_pool(self):
        return [s for s in range(self.nproc) if s not in self.bad_slots]

    def _event(self, kind, detail=""):
        ev = (time.time(), kind, detail)
        self.events.append(ev)
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "elastic_events.jsonl"),
                  "a") as f:
            f.write(json.dumps(ev) + "\n")

    def _rendezvous(self):
        if self.master:
            return self.master
        path = os.path.join(self.log_dir,
                            f"rendezvous.r{self.restart_count}")
        try:
            os.unlink(path)
        except OSError:
            pass
        return "file://" + path

    # -- one incarnation -----------------------------------------------------
    def _spawn(self, nproc):
        os.makedirs(self.log_dir, exist_ok=True)
        pool = self._slot_pool()
        master = self._rendezvous()
        procs = []
        for rank in range(nproc):
            env = dict(self.base_env)
            hb = os.path.join(self.log_dir, f"heartbeat.{rank}")
            try:
                os.unlink(hb)
            except OSError:
                pass
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(nproc),
                "PADDLE_LOCAL_RANK": str(rank),
                "PADDLE_RESTART_COUNT": str(self.restart_count),
                "PADDLE_MASTER": master,
                # the slot's card: a shrunk world keeps the survivors'
                "FLAGS_selected_gpus": str(self.devices[pool[rank]]),
                _HEARTBEAT_ENV: hb,
            })
            log = open(os.path.join(
                self.log_dir,
                f"workerlog.{rank}.r{self.restart_count}"), "w")
            procs.append({
                "proc": subprocess.Popen(self.cmd, env=env, stdout=log,
                                         stderr=subprocess.STDOUT),
                "log": log, "hb": hb, "rank": rank, "start": time.time(),
            })
        return procs

    def _kill_all(self, procs):
        for w in procs:
            if w["proc"].poll() is None:
                w["proc"].send_signal(signal.SIGTERM)
        deadline = time.time() + 5
        for w in procs:
            timeout = max(0.1, deadline - time.time())
            try:
                w["proc"].wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                w["proc"].kill()
                w["proc"].wait()
        for w in procs:
            w["log"].close()

    def _check(self, procs):
        """Returns (status, detail, failed_rank)."""
        codes = [w["proc"].poll() for w in procs]
        if any(c is not None and c != 0 for c in codes):
            bad = [(w["rank"], c) for w, c in zip(procs, codes)
                   if c is not None and c != 0]
            return "failed", f"worker exit codes {bad}", bad[0][0]
        if all(c == 0 for c in codes):
            return "done", "", None
        if self.heartbeat_timeout:
            now = time.time()
            for w in procs:
                if w["proc"].poll() is not None:
                    continue
                try:
                    last = os.path.getmtime(w["hb"])
                except OSError:
                    # no heartbeat yet: the clock starts at the first one
                    # (start-up stalls are caught by exit codes)
                    continue
                if now - last > self.heartbeat_timeout:
                    return "failed", (
                        f"rank {w['rank']} heartbeat stale "
                        f"{now - last:.1f}s > {self.heartbeat_timeout}s "
                        "(hung step / dead collective)"), w["rank"]
        return "running", "", None

    # -- supervision loop ----------------------------------------------------
    def run(self):
        nproc = self.nproc
        last_failed_rank = None
        while True:
            self._event("launch",
                        f"nproc={nproc} restart={self.restart_count}")
            procs = self._spawn(nproc)
            status, detail, failed_rank = "running", "", None
            try:
                while status == "running":
                    time.sleep(self.poll_interval)
                    status, detail, failed_rank = self._check(procs)
            finally:
                self._kill_all(procs)
            if status == "done":
                self._event("done")
                return 0
            self._event("failure", detail)
            if self.restart_count >= self.max_restarts:
                self._event("giveup", f"after {self.restart_count} restarts")
                return 1
            # the same rank failing twice in a row looks like a lost
            # resource, not a transient fault: drop its slot and shrink
            if (failed_rank is not None and failed_rank == last_failed_rank
                    and nproc > self.min_nproc):
                slot = self._slot_pool()[failed_rank]
                self.bad_slots.add(slot)
                nproc -= 1
                self._event("shrink", f"nproc={nproc} excluded_dev="
                            f"{self.devices[slot]} slot={slot}")
                # ranks remap after a shrink: a fresh double failure is
                # needed before the next exclusion
                failed_rank = None
            last_failed_rank = failed_rank
            self.restart_count += 1


__all__ = ["ElasticAgent", "heartbeat"]
