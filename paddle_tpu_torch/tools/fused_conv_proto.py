"""A/B of kernel K4 (fused BN-apply + ReLU (+ residual) -> 1x1-conv
matmul) against the composed torch path at ResNet-50's block boundaries,
on the GPU.

    python -m paddle_tpu_torch.tools.fused_conv_proto [--seed N] [--sweep]

Port of tools/fused_conv_proto.py: the same five geometries at batch 128
and the same input recipe from --seed (one numpy RandomState drawn in
geometry order: x, z ~ N(0, 1) bf16, w ~ N(0, 1/K) bf16, scale in
[0.5, 1.5), shift ~ N(0, 0.01) f32). For each geometry it prints, as one
JSON line per geometry, the device time (CUDA events, L2 flushed before
each call) of
- K4 (ops/kernels/fused_conv.py, csrc/fused_conv.cu);
- the composed path: the transform as eager torch runs it (addcmul into
  f32, the residual add, relu, the cast to bf16) then torch.matmul;
- torch.matmul alone on the transformed bf16 input, the GEMM's share;
- K4's plain version (f32 transform and an f32 matmul);
beside the bound (bytes of x, z, w, scale, shift and out over the HBM
rate, or the FLOPs over the bf16 tensor peak, whichever is larger), its
share, K4's tile width, grid and ring depth from `k4_tile` and
`k4_ring`, and K4's agreement with its plain version. Two more readings
of K4 separate the device from the host: its kernel's own device time
under torch.profiler (same flushes), and the wrapper's host time per
call (100 calls enqueued without a sync). The events time includes any
gap in which the flushed card waits for a slow wrapper. The JAX tool's
verdict was taken on a TPU and says nothing of this card. The last line
is the card's name and power limit.

--sweep instead times K4 at every tile width whose ring fits (pinned
through `block_n=`), one JSON line per (geometry, width), to check the
rule's choice.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Iterator, Optional

import numpy as np

__all__ = ["GEOMETRIES", "BATCH", "inputs", "composed", "measure", "tiling",
           "sweep"]

BATCH = 128
# block-boundary sites: (name, H*W, C_in, C_out, with residual)
GEOMETRIES = (
    ("layer1->conv1 56x56 256->64", 56 * 56, 256, 64, True),
    ("layer2->conv1 28x28 512->128", 28 * 28, 512, 128, True),
    ("layer3->conv1 14x14 1024->256", 14 * 14, 1024, 256, True),
    ("layer4->conv1 7x7 2048->512", 7 * 7, 2048, 512, True),
    ("bn2->conv3 56x56 64->256", 56 * 56, 64, 256, False),
)


def inputs(seed: int, device) -> Iterator[tuple]:
    """(name, x, z or None, w, scale, shift) for each geometry in order,
    from one RandomState(seed), on `device`."""
    import torch
    rng = np.random.RandomState(seed)
    for name, hw, cin, cout, with_res in GEOMETRIES:
        m = BATCH * hw

        def bf16(a):
            return torch.from_numpy(a.astype(np.float32)).to(
                device, torch.bfloat16)

        x = bf16(rng.randn(m, cin))
        z = bf16(rng.randn(m, cin)) if with_res else None
        w = bf16(rng.randn(cin, cout) / np.sqrt(cin))
        scale = torch.from_numpy((rng.rand(cin) + 0.5).astype(
            np.float32)).to(device)
        shift = torch.from_numpy((rng.randn(cin) * 0.1).astype(
            np.float32)).to(device)
        yield name, x, z, w, scale, shift


def _transform(x, z, scale, shift):
    import torch
    t = torch.addcmul(shift, x, scale)
    if z is not None:
        t.add_(z)
    return t.relu_().to(torch.bfloat16)


def composed(x, z, w, scale, shift):
    """The yardstick: the transform as eager torch runs it, then
    torch.matmul (cuBLAS bf16)."""
    import torch
    return torch.matmul(_transform(x, z, scale, shift), w)


def tiling(x, z, w) -> dict:
    """K4's tile width, grid and ring depth for these inputs."""
    from ..ops.kernels.fused_conv import k4_ring, k4_tile
    from ..ops.kernels.ragged_paged_attention import sm_count
    m, k = x.shape
    block_n, grid = k4_tile(m, k, w.shape[1], sm_count(x.device),
                            z is not None)
    return {"block_n": block_n, "grid": grid,
            "stages": k4_ring(k, block_n, z is not None)[0]}


def measure(name, x, z, w, scale, shift, iters: int = 20) -> dict:
    """K4 at one geometry: agreement with its plain version, the device
    times (CUDA events) of K4, its plain version, the composed path and
    torch.matmul alone beside the bound, K4's profiler kernel time and
    wrapper host time, and its tiling."""
    import torch
    from ..ops.kernels.fused_conv import (fused_scale_relu_matmul,
                                          fused_scale_relu_matmul_reference)
    from .measure import agreement, bound, cold_ms
    m, k = x.shape
    n = w.shape[1]
    before = fused_scale_relu_matmul.launches
    got = fused_scale_relu_matmul(x, z, w, scale, shift)
    torch.cuda.synchronize()
    if fused_scale_relu_matmul.launches != before + 1:
        raise RuntimeError("K4 did not launch")
    agree = agreement(got, fused_scale_relu_matmul_reference(
        x, z, w, scale, shift))
    del got
    t = _transform(x, z, scale, shift)
    res = {
        "ms": cold_ms(lambda: fused_scale_relu_matmul(x, z, w, scale, shift),
                      iters),
        "plain_ms": cold_ms(lambda: fused_scale_relu_matmul_reference(
            x, z, w, scale, shift), max(iters // 4, 3)),
        "composed_ms": cold_ms(lambda: composed(x, z, w, scale, shift),
                               iters),
        "matmul_ms": cold_ms(lambda: torch.matmul(t, w), iters)}
    nbytes = (m * k * 2 * (2 if z is not None else 1) + k * n * 2
              + 2 * k * 4 + m * n * 2)
    flops = 2 * m * k * n
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    res.update(name=name, m=m, k=k, n=n, residual=z is not None,
               mbytes=nbytes / 1e6, gflop=flops / 1e9,
               share=res["bound_ms"] / res["ms"],
               tb_per_s=nbytes / res["ms"] / 1e9,
               tflop_per_s=flops / res["ms"] / 1e9, agreement=agree,
               **device_and_host(x, z, w, scale, shift, iters),
               **tiling(x, z, w))
    return res


def sweep(name, x, z, w, scale, shift, iters: int = 20) -> list:
    """K4 timed at every tile width whose ring fits at this geometry."""
    from ..ops.kernels.fused_conv import (K4_BLOCK_NS, fused_scale_relu_matmul,
                                          fused_scale_relu_matmul_reference,
                                          k4_ring)
    from .measure import agreement, cold_ms
    chosen = tiling(x, z, w)["block_n"]
    want = fused_scale_relu_matmul_reference(x, z, w, scale, shift)
    rows = []
    for bn in K4_BLOCK_NS:
        if k4_ring(x.shape[1], bn, z is not None)[0] < 2:
            continue
        got = fused_scale_relu_matmul(x, z, w, scale, shift, block_n=bn)
        rows.append({"name": name, "block_n": bn, "rule": bn == chosen,
                     "ms": cold_ms(lambda: fused_scale_relu_matmul(
                         x, z, w, scale, shift, block_n=bn), iters),
                     "l2": agreement(got, want)["l2"]})
    return rows


def device_and_host(x, z, w, scale, shift, iters: int = 20) -> dict:
    """K4's kernel time under torch.profiler (L2 flushed before each call)
    and the wrapper's host time per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ..ops.kernels.fused_conv import fused_scale_relu_matmul

    def call():
        return fused_scale_relu_matmul(x, z, w, scale, shift)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if "fused_scale_relu_matmul_kernel" in e.key]
    kernel_ms = (sum(e.self_device_time_total for e in rows)
                 / sum(e.count for e in rows) / 1e3) if rows else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        call()
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    return {"profiler_ms": kernel_ms, "host_us": host_us}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true",
                    help="time every tile width instead")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fused_conv_proto: needs a CUDA device")
    from .measure import card_line
    torch.backends.cuda.matmul.allow_tf32 = False
    for geom in inputs(args.seed, torch.device("cuda")):
        rows = (sweep(*geom, iters=args.iters) if args.sweep
                else [measure(*geom, iters=args.iters)])
        for res in rows:
            res["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(res), flush=True)
        del geom
        torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
