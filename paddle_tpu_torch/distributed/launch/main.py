"""python -m paddle_tpu_torch.distributed.launch (port of
``paddle_tpu/distributed/launch/main.py``; reference: launch/main.py:21).

Usage:
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=N \\
        [--devices 0,1,...] [--elastic [--min_nproc M]] train.py args

Every rank gets ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_MASTER`` (``host:port``; ``distributed.init_parallel_env``
rendezvouses there), ``PADDLE_LOCAL_RANK`` and ``FLAGS_selected_gpus``
(its card: ``--devices``' entry for its slot, else its local rank).  The
rest of the environment passes through, so the caller picks the backend
(``PADDLE_DISTRI_BACKEND``; two ranks on one card need ``gloo``, NCCL
refuses two ranks of one communicator on one device).  The JAX
package's ``COORDINATOR_ADDRESS`` and ``FLAGS_selected_tpus`` are its
own and are not set.  The exit code is the first failing rank's.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=str, default="1")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes on this host, one a rank")
    p.add_argument("--master", type=str, default=None,
                   help="rendezvous host:port")
    p.add_argument("--rank", type=int, default=0, help="node rank")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--devices", "--gpus", type=str, default=None,
                   help="the card of each local rank, comma-separated "
                        "(0,0: two ranks on card 0); default: the local "
                        "rank")
    p.add_argument("--elastic", action="store_true",
                   help="supervise workers: restart the world on worker "
                        "failure or stale heartbeat (reference: fleet "
                        "elastic manager)")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--heartbeat_timeout", type=float, default=None,
                   help="seconds without a train-step heartbeat before a "
                        "worker counts as hung (watchdog; needs --elastic)")
    p.add_argument("--min_nproc", type=int, default=None,
                   help="allow the world to shrink to this size after "
                        "repeated failures (resume reshards the checkpoint)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _devices(args):
    if args.devices is None:
        return list(range(args.nproc_per_node))
    devs = [int(d) for d in args.devices.split(",") if d.strip()]
    if len(devs) != args.nproc_per_node:
        raise SystemExit(f"--devices {args.devices}: one card a local rank "
                         f"({args.nproc_per_node} ranks)")
    return devs


def launch(argv=None):
    args = parse_args(argv)
    nproc = args.nproc_per_node
    devices = _devices(args)
    cmd = [sys.executable, args.training_script] + args.training_script_args
    if args.elastic:
        if int(args.nnodes.split(":")[0]) > 1 or args.rank != 0:
            raise NotImplementedError(
                "--elastic supervises a single host (per-host agents with "
                "a shared store are the multi-node path); run one "
                "launcher per host without --elastic, or drop "
                "--nnodes/--rank")
        from ..elastic import ElasticAgent
        agent = ElasticAgent(
            cmd, nproc, log_dir=args.log_dir, max_restarts=args.max_restarts,
            heartbeat_timeout=args.heartbeat_timeout,
            min_nproc=args.min_nproc, master=args.master, devices=devices)
        sys.exit(agent.run())
    master = args.master or f"127.0.0.1:{_free_port()}"
    os.makedirs(args.log_dir, exist_ok=True)
    procs = []
    base_env = dict(os.environ)
    nnodes = int(args.nnodes.split(":")[0])
    for local_rank in range(nproc):
        env = dict(base_env)
        env.update({
            "PADDLE_TRAINER_ID": str(args.rank * nproc + local_rank),
            "PADDLE_TRAINERS_NUM": str(nproc * nnodes),
            "PADDLE_MASTER": master,
            "PADDLE_LOCAL_RANK": str(local_rank),
            "FLAGS_selected_gpus": str(devices[local_rank]),
        })
        log = open(os.path.join(args.log_dir,
                                f"workerlog.{local_rank}"), "w")
        procs.append((subprocess.Popen(
            cmd, env=env, stdout=log if local_rank != 0 else None,
            stderr=subprocess.STDOUT if local_rank != 0 else None), log))
    exit_code = 0
    try:
        for p, _ in procs:
            ret = p.wait()
            exit_code = exit_code or ret
    except KeyboardInterrupt:
        for p, _ in procs:
            p.send_signal(signal.SIGTERM)
        time.sleep(3)
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        exit_code = 1
    finally:
        for _, log in procs:
            log.close()
    sys.exit(exit_code)


def main(argv=None):
    """Console-script entry (``fleetrun``, reference setup.py:1907)."""
    launch(argv)


if __name__ == "__main__":
    launch()
