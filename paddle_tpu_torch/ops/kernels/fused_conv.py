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
hand-written CUDA kernel csrc/fused_conv.cu (its header says what bounds
it and what the simple design leaves for later). The TPU kernel has no
backward, and neither has this one.

`fused_scale_relu_matmul_reference` is the plain PyTorch version, the
math stated once; the tests and the checks hold the kernel to it. The
wrapper runs it for tensors on the CPU; for CUDA tensors it launches the
kernel or raises, never falling back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_scale_relu_matmul", "fused_scale_relu_matmul_reference"]


def fused_scale_relu_matmul_reference(x, z, w, scale, shift):
    """Plain version: x, z (or None) [M, K] bf16, w [K, N] bf16, scale and
    shift [K] f32 -> [M, N] bf16."""
    t = x.float() * scale + shift
    if z is not None:
        t = t + z.float()
    t = torch.relu(t).to(torch.bfloat16)
    return (t.float() @ w.float()).to(torch.bfloat16)


def fused_scale_relu_matmul(x, z, w, scale, shift):
    """relu(x * scale + shift (+ z)) @ w as above, for x, z [M, K] bf16, w
    [K, N] bf16 and scale, shift [K] f32 with K and N multiples of 16 (the
    kernel's domain; other shapes and dtypes raise on either device). CPU
    tensors run the plain version; CUDA tensors (contiguous, on one
    device, 16-byte aligned) launch the kernel and count the launch in
    `fused_scale_relu_matmul.launches`."""
    _check_shapes(x, z, w, scale, shift)
    args = [t for t in (x, z, w, scale, shift) if t is not None]
    if all(t.device.type == "cpu" for t in args):
        return fused_scale_relu_matmul_reference(x, z, w, scale, shift)
    _check_cuda(x, args)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_scale_relu_matmul(
            x.data_ptr(), None if z is None else z.data_ptr(), w.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(), m, k, n,
            stream)
    if err != 0:
        raise RuntimeError(
            f"fused_scale_relu_matmul kernel launch failed: cudaError {err}")
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
        fn.argtypes = [p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
