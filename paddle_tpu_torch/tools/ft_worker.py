"""A supervised GPT training worker for the elastic supervisor
(distributed/elastic.py): the CPU tests' kill-and-resume job and
chip_smoke.py's phase 33.

    python -m paddle_tpu_torch.tools.ft_worker --ckpt-dir DIR --out OUT
        [--model tiny|bench] [--device cuda|cpu] [--steps N]
        [--save-every K] [--seed S]

It trains a GPT under use_recompute="full" through jit.TrainStep
(AdamW(1e-4) with ClipGradByGlobalNorm(1.0); bench: bench.py's
bench_gpt widths, 12 layers, hidden 768, 6 heads of 128, vocab 32768,
batch 32 x 1024, AMP O2 bf16; tiny: GPTConfig.tiny() at batch 2 x 16 in
float32) for N steps under AutoCheckpointManager.train_step_range,
which restores the newest step snapshot, snapshots every K steps
(keeping one) and beats the elastic heartbeat once a step. Faults
come from testing.faults.FaultInjector's environment contract
(PADDLE_TPU_FAULTS, e.g. "kill@4" or "stall@4:3600", and
PADDLE_TPU_FAULT_STATE_DIR, so a restarted worker passes the step that
killed its predecessor). Every batch is a function of its step index and
the model runs at dropout 0, so a killed and resumed job must end with
parameters bitwise equal to an uninterrupted one.

Each step appends one JSON line to OUT.steps (incarnation, step, host
clock at its start and end, loss, the flash kernel K1's launches so far
in this incarnation); the worker that finishes writes OUT (atomically):
a sha256 digest of each parameter's bytes, its losses, the first step it
ran, its incarnation, K1's launches, and its snapshots' save and restore
seconds and bytes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np

__all__ = ["build", "batch", "param_digests", "main"]


def build(model: str, device, seed: int):
    """(GPT, AdamW, TrainStep) for the worker's model, under full
    recompute."""
    from .. import amp, jit
    from ..models.gpt import GPT, GPTConfig, gpt_loss_fn
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from .train_bench import bench_config
    cfg = bench_config(6) if model == "bench" else GPTConfig.tiny()
    cfg.use_recompute = "full"
    net = GPT(cfg, device=device, seed=seed)
    opt = AdamW(1e-4, parameters=net.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    if model == "bench":
        net, opt = amp.decorate(net, opt, level="O2", dtype="bfloat16")
    return net, opt, jit.TrainStep(net, gpt_loss_fn, opt)


def batch(model: str, step: int, vocab: int, device):
    """The step's tokens and labels: a function of the step alone, so a
    replayed step sees the bytes the killed incarnation saw."""
    import torch
    b, t = (32, 1024) if model == "bench" else (2, 16)
    rs = np.random.RandomState(1000 + step)
    x = torch.from_numpy(rs.randint(0, vocab, (b, t)))
    y = torch.from_numpy(rs.randint(0, vocab, (b, t)))
    return x.to(device), y.to(device)


def param_digests(net) -> dict:
    """{name: sha256 of the parameter's bytes}."""
    import torch
    out = {}
    for name, p in net.named_parameters():
        raw = p.detach().contiguous().cpu().view(torch.uint8).numpy()
        out[name] = hashlib.sha256(raw.tobytes()).hexdigest()
    return out


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", choices=("tiny", "bench"), default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--save-every", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    from .. import obs
    from ..core.place import default_device
    from ..incubate.checkpoint import AutoCheckpointManager
    from ..ops.kernels import flash_attention as k1
    from ..testing.faults import FaultInjector
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)  # one order of the CPU's sums
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    incarnation = int(os.environ.get("PADDLE_ELASTIC_RESTART_COUNT", "0"))
    net, opt, step_fn = build(args.model, device, args.seed)
    vocab = net.cfg.vocab_size
    inj = FaultInjector()  # env-driven; inert without PADDLE_TPU_FAULTS
    acp = AutoCheckpointManager(args.ckpt_dir, models=[net],
                                optimizers=[opt],
                                save_every_n_steps=args.save_every,
                                max_keep=1)
    fns = (k1.flash_attention_fwd, k1.flash_attention_bwd)
    start = [f.launches for f in fns]
    losses, first = [], None
    # snapshots restore onto the worker's device
    with default_device(device), open(args.out + ".steps", "a") as log:
        for step in acp.train_step_range(args.steps):
            t0 = time.time()
            inj.step(step, checkpoint_dir=args.ckpt_dir)
            x, y = batch(args.model, step, vocab, device)
            loss = float(step_fn(x, y))
            first = step if first is None else first
            losses.append(loss)
            log.write(json.dumps({
                "incarnation": incarnation, "step": step, "t0": t0,
                "t1": time.time(), "loss": loss,
                "k1": [f.launches - s for f, s in zip(fns, start)]}) + "\n")
            log.flush()
    save = obs.histogram("checkpoint_save_seconds",
                         labels=("kind",)).labels(kind="step")
    restore = obs.histogram("checkpoint_restore_seconds").labels()
    result = {
        "params": param_digests(net), "losses": losses,
        "first_step": first, "incarnation": incarnation,
        "restored": acp.restored_index,
        "k1": [f.launches - s for f, s in zip(fns, start)],
        "save_s": [save.sum, save.count],
        "restore_s": [restore.sum, restore.count],
        "snapshot_bytes": _dir_bytes(args.ckpt_dir)}
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, args.out)  # the reader never sees a torn file
    return result


if __name__ == "__main__":
    main()
