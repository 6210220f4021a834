"""Fused BN-apply + ReLU (+ residual) into a 1x1 convolution (kernel K4).

    out = bf16( bf16( relu(x * scale + shift (+ z)) ) @ w )

x, z [M, K] bf16 are a BN input and its residual laid out as [N*H*W, C];
scale, shift [K] f32 are the BN's per-channel fold; w [K, N] bf16 is the
next 1x1 convolution's weight transposed. That is the boundary between
two ResNet-50 bottleneck blocks: `_bn_relu(bn3, conv3(out), add=identity)`
feeding the next block's conv1. The transform runs in f32, each step
rounded as its own f32 operation, and is rounded once to bf16; the
product accumulates in f32 and is rounded to bf16.

Replaces the TPU kernel tools/fused_conv_proto.py:75-106
(`fused_scale_relu_matmul`, `pl.pallas_call` at :97) with the
hand-written CUDA kernel csrc/fused_conv.cu: a persistent Hopper kernel
whose producer warp streams x, z and w by TMA through a ring of
shared-memory stages, and whose two consumer warpgroups apply the
transform to wgmma's A operand in registers (its header says what bounds
it and what the design leaves for later). The TPU kernel has no
backward, and neither has this one.

`k4_tile` picks the kernel's output tile width and grid from the shapes
and the card's SM count alone; `k4_ring` is the depth and shared memory
of its ring. Both mirror the constants of the .cu source.

`fused_scale_relu_matmul_reference` is the plain PyTorch version, the
math stated once; the tests and the checks hold the kernel to it. The
wrapper runs it for tensors on the CPU; for CUDA tensors it launches the
kernel or raises, never falling back.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...core.unported import require_defaults
from . import _build
from .ragged_paged_attention import sm_count

__all__ = ["fused_scale_relu_matmul", "fused_scale_relu_matmul_reference",
           "k4_tile", "k4_ring", "K4_BLOCK_NS"]

# csrc/fused_conv.cu's tiling: output rows a tile, K columns a ring stage,
# the deepest ring, a block's shared memory on sm_90, the alignment slack
K4_BM, K4_BK, K4_MAX_STAGES = 128, 64, 8
K4_SMEM_LIMIT, K4_SLACK = 232448, 1024
K4_BLOCK_NS = (64, 128, 256)
_ERRORS = {-1: "block_n is not 64, 128 or 256",
           -2: "cuTensorMapEncodeTiled is unavailable",
           -3: "cuTensorMapEncodeTiled refused an operand",
           -4: "the ring does not fit in shared memory"}


def _tiles(m: int, n: int, block_n: int) -> int:
    return -(-m // K4_BM) * -(-n // block_n)


def k4_ring(k: int, block_n: int, residual: bool) -> Tuple[int, int]:
    """(stages, dynamic shared memory bytes) of the kernel's ring at K `k`
    and tile width `block_n`: as many stages as fit, at most
    K4_MAX_STAGES, beside the alignment slack, the two consumers' bf16
    staging of a 128 x block_n tile, scale and shift over K rounded up to
    64, and the barriers. A stage is x (and z) [128, 64] and w [64,
    block_n] in bf16. Fewer than 2 stages means the shape does not fit."""
    stage = K4_BM * K4_BK * 2 * (2 if residual else 1) + K4_BK * block_n * 2
    kpad = -(-k // K4_BK) * K4_BK
    fixed = K4_SLACK + K4_BM * block_n * 2 + 8 * kpad + 16 * K4_MAX_STAGES
    stages = min(K4_MAX_STAGES, (K4_SMEM_LIMIT - fixed) // stage)
    return stages, fixed + stages * stage


def k4_tile(m: int, k: int, n: int, num_sms: int,
            residual: bool = True) -> Tuple[int, int]:
    """(block_n, grid) for [m, k] @ [k, n] on a card of `num_sms` SMs.

    block_n starts at n rounded up to 64, at most 256, so x is read once
    where n <= 256. It halves (not below 64) while the tiles of 128 rows
    would number fewer than the SMs, or while the ring would hold fewer
    than 3 stages (with a residual, 256 columns never hold 3; on the H100
    layer3 below ran 0.0576 ms at 128 columns and 3 stages, 0.0750 at 256
    and 2: `fused_conv_proto --sweep`). The grid is one persistent
    CTA per SM, or one per tile where there are fewer. On the H100's 132
    SMs, at ResNet-50's block boundaries (batch 128):
      layer1 401408 x 256 -> 64, residual:  64, grid 132, 3136 tiles
      layer2 100352 x 512 -> 128, residual: 128, grid 132, 784 tiles
      layer3 25088 x 1024 -> 256, residual: 128, grid 132, 392 tiles (256
             would hold 2 stages)
      layer4 6272 x 2048 -> 512, residual:  128, grid 132, 196 tiles (256
             would leave 98 tiles for 132 SMs)
      bn2    401408 x 64 -> 256:            256, grid 132, 3136 tiles
    Raises ValueError where not even 2 stages of 64 columns fit."""
    block_n = min(-(-n // 64) * 64, 256)
    while block_n > 64 and (_tiles(m, n, block_n) < num_sms
                            or k4_ring(k, block_n, residual)[0] < 3):
        block_n //= 2
    if k4_ring(k, block_n, residual)[0] < 2:
        raise ValueError(f"K {k}: K4's ring does not fit in shared memory")
    return block_n, min(_tiles(m, n, block_n), num_sms)


def fused_scale_relu_matmul_reference(x, z, w, scale, shift):
    """Plain version: x, z (or None) [M, K] bf16, w [K, N] bf16, scale and
    shift [K] f32 -> [M, N] bf16."""
    t = x.float() * scale + shift
    if z is not None:
        t = t + z.float()
    t = torch.relu(t).to(torch.bfloat16)
    return (t.float() @ w.float()).to(torch.bfloat16)


def fused_scale_relu_matmul(x, z, w, scale, shift, bm=512, bn=128, bk=256,
                            *, block_n: Optional[int] = None):
    """relu(x * scale + shift (+ z)) @ w as above, for x, z [M, K] bf16, w
    [K, N] bf16 and scale, shift [K] f32 with K and N multiples of 16 (the
    kernel's domain; other shapes and dtypes raise on either device). CPU
    tensors run the plain version; CUDA tensors (contiguous, on one
    device, 16-byte aligned) launch the kernel and count the launch in
    `fused_scale_relu_matmul.launches`. The kernel's tile width and grid
    are `k4_tile`'s; `block_n` (64, 128 or 256) pins the width for tests
    (the grid is then one CTA per SM or per tile) and changes nothing on
    the CPU. bm, bn and bk, the TPU kernel's block sizes, take only
    their defaults: the Hopper kernel's tiling is k4_tile's."""
    require_defaults("fused_scale_relu_matmul", bm=(bm, 512), bn=(bn, 128),
                     bk=(bk, 256))
    _check_shapes(x, z, w, scale, shift)
    if block_n is not None and block_n not in K4_BLOCK_NS:
        raise ValueError(f"block_n {block_n}: K4 takes {K4_BLOCK_NS}")
    args = [t for t in (x, z, w, scale, shift) if t is not None]
    if all(t.device.type == "cpu" for t in args):
        return fused_scale_relu_matmul_reference(x, z, w, scale, shift)
    _check_cuda(x, args)
    m, k = x.shape
    n = w.shape[1]
    sms = sm_count(x.device)
    if block_n is None:
        block_n, grid = k4_tile(m, k, n, sms, z is not None)
    else:
        if k4_ring(k, block_n, z is not None)[0] < 2:
            raise ValueError(f"K {k}, block_n {block_n}: K4's ring does not "
                             f"fit in shared memory")
        grid = min(_tiles(m, n, block_n), sms)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.fused_scale_relu_matmul(
            x.data_ptr(), None if z is None else z.data_ptr(), w.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(), m, k, n,
            block_n, grid, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_scale_relu_matmul kernel launch failed: "
                           f"{_ERRORS.get(err, f'cudaError {err}')}")
    fused_scale_relu_matmul.launches += 1
    return out


fused_scale_relu_matmul.launches = 0


def _check_shapes(x, z, w, scale, shift) -> None:
    named = [("x", x, torch.bfloat16), ("w", w, torch.bfloat16),
             ("scale", scale, torch.float32), ("shift", shift, torch.float32)]
    if z is not None:
        named.append(("z", z, torch.bfloat16))
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} dtype {t.dtype}: expected {dtype}")
    if x.ndim != 2 or w.ndim != 2 or scale.ndim != 1 or shift.ndim != 1:
        raise ValueError("expected x [M, K], w [K, N], scale and shift [K]")
    m, k = x.shape
    if w.shape[0] != k or scale.shape[0] != k or shift.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, scale "
                         f"{tuple(scale.shape)}, shift {tuple(shift.shape)} "
                         f"disagree on K")
    if z is not None and z.shape != x.shape:
        raise ValueError(f"z {tuple(z.shape)} must match x {tuple(x.shape)}")
    n = w.shape[1]
    if not 1 <= m < 2 ** 31 or k < 16 or n < 16 or k % 16 or n % 16:
        raise ValueError(f"M {m}, K {k}, N {n}: K4 takes 1 <= M < 2**31 and "
                         f"K, N positive multiples of 16")


def _check_cuda(x, args) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"x is on {dev}; the kernel takes CUDA tensors")
    for t in args:
        if t.device != dev:
            raise ValueError(f"inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("every input must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("every input must be 16-byte aligned")


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_conv")
    fn = lib.fused_scale_relu_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
