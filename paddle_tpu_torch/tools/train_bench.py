"""The GPT train step at the geometry of bench.py's `bench_gpt`, on the GPU.

    python -m paddle_tpu_torch.tools.train_bench [--heads 6|12] [--steps N]
        [--warmup N] [--seed N] [--profile]

Builds GPT(vocab 32768, hidden 768, 12 layers, max_seq_len 1024) with
random weights from --seed, casts it with amp.decorate(level="O2",
dtype="bfloat16") (bf16 parameters, f32 master weights), and trains it
with AdamW(1e-4, grad_clip=ClipGradByGlobalNorm(1.0)) through
jit.TrainStep on one random batch of 32 x 1024 tokens (the same batch
every step, as bench_gpt does). With 6 heads of 128 attention runs
through kernel K1, with 12 heads of 64 through K2.

Prints per-step losses and times, tokens/s and MFU over the timed steps,
peak device memory and the flash kernels' launches. MFU counts
bench.py's FLOPs per token (6 x matmul parameters + 12 L h T, copied
below) against the H100 SXM dense bf16 peak, 989 TFLOP/s (NVIDIA data
sheet). --profile records 3 more steps with torch.profiler and prints
the device time by group (flash kernels, GEMMs, cross-entropy, the
optimizer's clip + AdamW per-parameter loop, the rest).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np

__all__ = ["bench_config", "flops_per_token", "run", "H100_BF16_FLOPS"]

H100_BF16_FLOPS = 989e12
BATCH, SEQ = 32, 1024


def bench_config(num_heads: int = 6):
    from ..models.gpt import GPTConfig
    return GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                     num_heads=num_heads, max_seq_len=SEQ)


def flops_per_token(cfg) -> float:
    """fwd+bwd FLOPs/token: 6 * N_matmul + attention 12 * L * hidden *
    seq (bench.py `_gpt_flops_per_token`)."""
    h, L, V, T = (cfg.hidden_size, cfg.num_layers, cfg.vocab_size,
                  cfg.max_seq_len)
    per_layer = 4 * h * h + 2 * cfg.ffn_mult * h * h
    n_matmul = L * per_layer + V * h
    return 6 * n_matmul + 12 * L * h * T


def flash_launches() -> Dict[str, int]:
    from ..ops.kernels import flash_attention as k1
    from ..ops.kernels import packed_flash as k2
    return {"flash_attention_fwd": k1.flash_attention_fwd.launches,
            "flash_attention_bwd": k1.flash_attention_bwd.launches,
            "packed_flash_fwd": k2.packed_flash_fwd.launches,
            "packed_flash_bwd": k2.packed_flash_bwd.launches}


def build(num_heads: int = 6, seed: int = 0, device=None):
    """(model, TrainStep, x, y) at the bench geometry."""
    import torch
    from .. import amp, jit
    from ..models.gpt import GPT, gpt_loss_fn
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    cfg = bench_config(num_heads)
    model = GPT(cfg, device=device, seed=seed)
    optim = AdamW(1e-4, parameters=model.parameters(),
                  grad_clip=ClipGradByGlobalNorm(1.0))
    model, optim = amp.decorate(model, optim, level="O2", dtype="bfloat16")
    step = jit.TrainStep(model, gpt_loss_fn, optim)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    return model, step, x.to(model.device), y.to(model.device)


def run(num_heads: int = 6, warmup: int = 2, steps: int = 10,
        seed: int = 0, built=None, profile: bool = False) -> dict:
    """Warm-up and timed steps; returns losses, step times (host clock
    around each step, which ends in the loss's fetch), tokens/s and MFU
    over the timed steps, peak device memory and the flash kernels'
    launches during the timed steps."""
    import torch
    from ..nn.functional import attention as A
    model, step, x, y = built or build(num_heads, seed)
    dev = model.device
    cuda = dev.type == "cuda"
    losses, times = [], []

    def one():
        t0 = time.perf_counter()
        loss = step(x, y).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)

    for _ in range(warmup):
        one()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = flash_launches()
    for _ in range(steps):
        one()
    launches = {k: v - before[k] for k, v in flash_launches().items()}
    timed = times[warmup:]
    tokens = x.numel()
    tps = tokens * len(timed) / sum(timed) if timed else None
    out = {"num_heads": num_heads, "num_layers": model.cfg.num_layers,
           "batch": int(x.shape[0]), "seq": int(x.shape[1]),
           "losses": losses, "step_s": times, "tokens_per_sec": tps,
           "mfu": (tps * flops_per_token(model.cfg) / H100_BF16_FLOPS
                   if tps and cuda else None),
           "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if cuda else None),
           "last_path": A.LAST_PATH, "launches": launches}
    if profile:
        out["profile"] = profile_steps(step, x, y, 3)
    return out


# device kernels by name: the flash kernels and cuBLAS's GEMMs
_KERNEL_GROUPS = (("flash (K1/K2)", ("fa_fwd", "fa_bwd", "fa_delta")),
                  ("gemm", ("nvjet", "gemm", "Gemm", "cutlass", "xmma")))
# profiler ranges the port opens: nn/functional/loss.py (forward and
# backward of the fused CE) and jit.TrainStep (clip + AdamW loop)
_RANGES = ("cross_entropy", "optimizer")


def profile_steps(step, x, y, n: int = 3) -> dict:
    """torch.profiler over n steps: wall, device busy time, idle share,
    and device time by group: the flash kernels and the GEMMs by kernel
    name, cross-entropy and the optimizer (global-norm clip + the AdamW
    per-parameter loop) by the profiler ranges the port opens, and the
    rest (LayerNorm, GELU, residual adds, casts, embedding); and each
    range's span on the device timeline (its kernels plus the idle gaps
    between them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(x, y).item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows, without the ranges' own device-side spans (a range
    # shows on the device timeline as one row spanning its kernels and
    # the gaps between them)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in _RANGES]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    spans = {r: sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.key == r) / 1e6
             for r in _RANGES}
    groups = {g: 0.0 for g, _ in _KERNEL_GROUPS}
    for e in rows:
        for g, keys in _KERNEL_GROUPS:
            if any(k in e.key for k in keys):
                groups[g] += e.self_device_time_total / 1e6
                break
    for r in _RANGES:
        groups[r] = sum(e.device_time_total for e in prof.events()
                        if e.name == r and e.device_type == DeviceType.CPU
                        ) / 1e6
    groups["other"] = busy - sum(groups.values())
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:15]
    return {"steps": n, "wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / wall if wall else None,
            "groups_s": groups, "range_spans_s": spans,
            "top": [(e.key[:90], e.count, e.self_device_time_total / 1e6)
                    for e in top]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run(args.heads, args.warmup, args.steps, args.seed,
              profile=args.profile)
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
