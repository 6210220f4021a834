"""paddle.distributed.spawn (port of paddle_tpu/distributed/spawn.py;
reference: python/paddle/distributed/spawn.py).

`spawn(func, args, nprocs)` runs func(*args) in nprocs fresh processes
(multiprocessing's spawn context), each with the launcher's env
contract: PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
PADDLE_TRAINER_ENDPOINTS (free local ports, the first one the
rendezvous of init_parallel_env), PADDLE_CURRENT_ENDPOINT,
FLAGS_selected_gpus and CUDA_VISIBLE_DEVICES (the card of its rank, of
the cards this process sees). func must be importable by the children
(a module-level function). With join, a child that fails makes spawn
raise. nprocs=1 runs func here, as the JAX package does.
"""
from __future__ import annotations

import multiprocessing as mp
import os

from .parallel import free_port

__all__ = ["spawn"]


def rank_env(rank: int, nprocs: int, endpoints, cards) -> dict:
    """The env contract of one rank; it sees the card of its place on
    its host (rank modulo the host's cards) as its only card."""
    return {"PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "FLAGS_selected_gpus": "0",
            "CUDA_VISIBLE_DEVICES": cards[rank % len(cards)]}


def visible_cards(nprocs: int) -> list:
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return visible.split(",") if visible else \
        [str(r) for r in range(nprocs)]


def _worker(func, env, args):
    os.environ.update(env)
    func(*args)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    if nprocs == 1:
        os.environ.setdefault("PADDLE_TRAINER_ID", "0")
        os.environ.setdefault("PADDLE_TRAINERS_NUM", "1")
        func(*args)
        return None
    endpoints = [f"127.0.0.1:{free_port()}" for _ in range(nprocs)]
    cards = visible_cards(nprocs)
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker, daemon=daemon, args=(
            func, rank_env(rank, nprocs, endpoints, cards), args))
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode]
        if bad:
            raise RuntimeError(f"spawned workers failed: exitcodes {bad}")
    return procs
