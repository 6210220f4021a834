"""K3 (ragged paged decode attention) timed across split sizes on one
NVIDIA GPU.

    python -m paddle_tpu_torch.tools.k3_sweep [--seed N] [--profile]

At the serving bench's kernel shapes (engine_bench.K3_SHAPE: 8 rows, 6
heads of 128, 32-position blocks of a 512-block f32 pool, 32 table
columns) under two sets of lengths, the mixed lengths of chip_smoke.py
phase 4 and full context (8 rows of 1024), it holds the kernel against
the plain version and times it with CUDA events (cold L2, mean of 50) at
each split size and at the wrapper's default. Prints one JSON line per
(lengths, split size), then the card's name and power limit.

--profile instead times the default split size three ways, one JSON
line per set of lengths (mixed, full, and every row dead): CUDA events
around each call after an L2 flush (as chip_smoke.py times it), the
kernel's own device time under torch.profiler (same flushes), and CUDA
events around 50 back-to-back calls with no flush (warm L2, host enqueue
overlapped); and the wrapper's host time per call (200 calls enqueued
without a sync).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional

from paddle_tpu_torch.tools.engine_bench import K3_SHAPE
from paddle_tpu_torch.tools.measure import K3_MIXED_LENGTHS

N, H, D, BS, NB, MB = K3_SHAPE
FULL = (MB * BS,) * N
DEAD = (0,) * N
SPLITS = (1, 2, 3, 4, 6, 8)


def profile_default(shapes: dict) -> None:
    """The default split size's time per call three ways (module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    from paddle_tpu_torch.tools.measure import cold_ms
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name, a in shapes.items():
        events_ms = cold_ms(lambda: ragged_decode_attention(*a), 50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flush.zero_()
                ragged_decode_attention(*a)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if "ragged_split_kernel" in e.key]
        kernel_ms = (sum(e.self_device_time_total for e in rows)
                     / sum(e.count for e in rows) / 1e3) if rows else None
        x = torch.cuda.Event(enable_timing=True)
        y = torch.cuda.Event(enable_timing=True)
        x.record()
        for _ in range(50):
            ragged_decode_attention(*a)
        y.record()
        y.synchronize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            ragged_decode_attention(*a)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"lengths": name, "events_cold_ms": events_ms,
                          "profiler_kernel_ms": kernel_ms,
                          "back_to_back_warm_ms": x.elapsed_time(y) / 50,
                          "wrapper_host_us": host_us}), flush=True)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="time the default split size three ways instead")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k3_sweep: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k3
    from paddle_tpu_torch.tools.measure import cold_ms, k3_inputs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def inputs(lengths):
        return k3_inputs(dev, torch.float32, args.seed, lengths, *K3_SHAPE)

    shapes = {"mixed": inputs(K3_MIXED_LENGTHS), "full": inputs(FULL)}
    if args.profile:
        profile_default({**shapes, "dead": inputs(DEAD)})
        print(card)
        return 0
    default = k3.default_blocks_per_split(N, H, MB, k3.sm_count(dev))
    for name, a in shapes.items():
        plain = k3.ragged_attention_reference(*a)
        for bps in sorted(set(SPLITS) | {default}):
            err = (k3.ragged_decode_attention(*a, blocks_per_split=bps)
                   - plain).abs().max()
            ms = cold_ms(lambda: k3.ragged_decode_attention(
                *a, blocks_per_split=bps), 50)
            print(json.dumps({
                "lengths": name, "blocks_per_split": bps,
                "default": bps == default, "ms": ms,
                "max_abs_err": err.item()}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
