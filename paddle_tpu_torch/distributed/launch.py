"""python -m paddle_tpu_torch.distributed.launch (port of
paddle_tpu/distributed/launch.py; reference:
python/paddle/distributed/fleet/launch.py:334).

One process per GPU (--nproc_per_node of them on this host), each with
the env contract of spawn.py: rank, world size, the trainer endpoints
(--ips x consecutive ports from --port), its own endpoint,
FLAGS_selected_gpus and CUDA_VISIBLE_DEVICES (the card of its rank).
The launcher watches its children: when one fails it stops the others
and exits with that child's code. --max_restarts > 0 hands the workers
to the port's ElasticSupervisor instead, which restarts a crashed (or,
with --heartbeat_timeout, hung) worker.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from .spawn import rank_env, visible_cards

__all__ = ["launch"]


def _parse(argv=None):
    ap = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    ap.add_argument("--ips", default="127.0.0.1",
                    help="comma-separated host ips")
    ap.add_argument("--nproc_per_node", type=int, default=1)
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--node_rank", type=int,
                    default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    ap.add_argument("--port", type=int, default=6170)
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="elastic mode: restart a crashed/hung worker up to "
                         "N times (0 = classic fail-fast pod teardown)")
    ap.add_argument("--heartbeat_timeout", type=float, default=None,
                    help="elastic mode: seconds without a worker heartbeat "
                         "before it is treated as hung")
    ap.add_argument("training_script")
    ap.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return ap.parse_args(argv)


def _envs(args):
    """(rank, env contract) of each local worker."""
    ips = args.ips.split(",")
    world = len(ips) * args.nproc_per_node
    endpoints = [f"{ip}:{args.port + i}" for ip in ips
                 for i in range(args.nproc_per_node)]
    cards = visible_cards(args.nproc_per_node)
    ranks = [args.node_rank * args.nproc_per_node + local
             for local in range(args.nproc_per_node)]
    return [(r, rank_env(r, world, endpoints, cards)) for r in ranks]


def launch(*, argv=None):
    args = _parse(argv)
    cmd = [sys.executable, args.training_script] + args.training_script_args
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    def log_path(rank):
        return (os.path.join(args.log_dir, f"worker.{rank}.log")
                if args.log_dir else None)

    if args.max_restarts > 0:
        from .elastic import ElasticSupervisor, WorkerSpec
        specs = [WorkerSpec(cmd, env=env, log_path=log_path(rank))
                 for rank, env in _envs(args)]
        ElasticSupervisor(max_restarts=args.max_restarts,
                          heartbeat_timeout=args.heartbeat_timeout
                          ).run(specs)
        return
    procs, logs = [], []
    for rank, env in _envs(args):
        out = open(log_path(rank), "w") if args.log_dir else None
        logs.append(out)
        procs.append(subprocess.Popen(
            cmd, env={**os.environ, **env}, stdout=out,
            stderr=subprocess.STDOUT if out else None))
    # watch loop (reference: launch_utils.py watch_local_trainers): a
    # failed child stops the pod
    try:
        while procs:
            for p in list(procs):
                ret = p.poll()
                if ret is None:
                    continue
                procs.remove(p)
                if ret != 0:
                    for q in procs:
                        q.send_signal(signal.SIGTERM)
                    for q in procs:
                        q.wait()
                    sys.exit(ret)
            time.sleep(0.2)
    except KeyboardInterrupt:
        for q in procs:
            q.send_signal(signal.SIGTERM)
        raise
    finally:
        for f in logs:
            if f is not None:
                f.close()


if __name__ == "__main__":
    launch()
