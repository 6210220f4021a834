"""A/B of kernel K4 (fused BN-apply + ReLU (+ residual) -> 1x1-conv
matmul) against the composed torch path at ResNet-50's block boundaries,
on the GPU.

    python -m paddle_tpu_torch.tools.fused_conv_proto [--seed N]

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
rate, or the FLOPs over the bf16 tensor peak, whichever is larger) and
K4's agreement with its plain version. The JAX tool's verdict was taken
on a TPU and says nothing of this card.
"""
from __future__ import annotations

import argparse
import json
from typing import Iterator, Optional

import numpy as np

__all__ = ["GEOMETRIES", "BATCH", "inputs", "composed", "measure"]

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


def measure(name, x, z, w, scale, shift, iters: int = 20) -> dict:
    """K4 at one geometry: agreement with its plain version, and the
    device times of K4, its plain version, the composed path and
    torch.matmul alone, beside the bound."""
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
               mbytes=nbytes / 1e6, gflop=flops / 1e9, agreement=agree)
    return res


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fused_conv_proto: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for geom in inputs(args.seed, torch.device("cuda")):
        res = measure(*geom, iters=args.iters)
        res["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(res))
        del geom
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
