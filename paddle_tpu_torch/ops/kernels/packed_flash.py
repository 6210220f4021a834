"""Packed-pair flash attention at head dim 64 (kernel K2 of the port).

q/k/v/out are [B, H/2, T, 128]: adjacent head pairs merged on the last
dimension, head 2i in lanes 0:64 and head 2i+1 in lanes 64:128 (the
natural [B, T, H, 64] -> [B, T, H/2, 128] reshape order, which
models.gpt.sliced_qkv produces). The scale is the true per-head
1/sqrt(64). lse is [B, H/2, 2, T] f32.

Replaces the TPU kernels of paddle_tpu/ops/pallas/packed_flash.py:
`_fwd_call:212` (`pallas_call:230`), `_bwd_call:241` (`:248`) and
`_bwd_call_fa2:368` (`:394`, `:412`) behind the custom_vjp
`packed_flash_attention:427`. On Hopper the lane packing is no layout
fix: the kernel is K1's CUDA source (csrc/flash_attention.cu) at head
dim 64, addressing each head through strides of (batch, pair, half,
seq). There is no unpack copy and the output stays packed. Its one FA2
backward serves every T <= MAX_SEQ (the TPU package's single-program
backward for T <= 1024 computes the same function).

`packed_flash_reference` is the plain version: unpack, K1's plain
version, repack. The wrappers run it for CPU tensors; for CUDA tensors
they launch the kernels or raise. `packed_flash_fwd.launches` and
`packed_flash_bwd.launches` count the calls that launched them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core import flags as _flags
from . import flash_attention as _fa

__all__ = ["MAX_SEQ", "supported", "route_gate", "packed_flash_attention",
           "packed_flash_fwd", "packed_flash_bwd", "packed_flash_reference"]

MAX_SEQ = 8192


def supported(head_dim: int, num_heads: int, q_seq: int, kv_seq: int) -> bool:
    """K2's scope (the TPU package's `supported` without its backend
    test): head dim 64, an even head count, self-attention, T a multiple
    of 128 up to MAX_SEQ."""
    return (head_dim == 64 and num_heads % 2 == 0
            and q_seq == kv_seq and q_seq % 128 == 0 and q_seq <= MAX_SEQ)


def route_gate(head_dim: int, num_heads: int, q_seq: int, kv_seq: int,
               dropout_active: bool = False, masked: bool = False) -> bool:
    """Model-side routing gate: the packed kernel applies under the
    flash path's conditions (no mask or dropout, the flag on, the
    sequence at least flash_attention_min_seq) and within its scope. The
    port has no tensor-parallel mesh, so the TPU gate's tp test has
    nothing to exclude."""
    if masked or dropout_active:
        return False
    return (_flags.flag("use_flash_attention")
            and q_seq >= _flags.flag("flash_attention_min_seq")
            and supported(head_dim, num_heads, q_seq, kv_seq))


def _unpack(t):
    B, Hp, T, W = t.shape
    return t.reshape(B, Hp, T, 2, W // 2).permute(0, 1, 3, 2, 4).reshape(
        B, 2 * Hp, T, W // 2)


def _repack(t):
    B, H, T, D = t.shape
    return t.reshape(B, H // 2, 2, T, D).permute(0, 1, 3, 2, 4).reshape(
        B, H // 2, T, 2 * D)


def packed_flash_reference(q, k, v, causal: bool = True,
                           scale: Optional[float] = None,
                           return_lse: bool = False):
    """Plain version: (out [B, H/2, T, 128], and with return_lse the
    lse [B, H/2, 2, T] f32). Differentiable."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // 2)
    res = _fa.flash_attention_reference(_unpack(q), _unpack(k), _unpack(v),
                                        causal, scale, return_lse)
    if not return_lse:
        return _repack(res)
    out, lse = res
    B, Hp, T = q.shape[0], q.shape[1], q.shape[2]
    return _repack(out), lse.reshape(B, Hp, 2, T)


def packed_flash_fwd(q, k, v, causal: bool = True,
                     scale: Optional[float] = None):
    """Forward: (out, lse [B, H/2, 2, T] f32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // 2)
    if _fa._on_cpu(q, k, v):
        with torch.no_grad():
            return packed_flash_reference(q, k, v, causal, scale,
                                          return_lse=True)
    o, lse = _fa.launch_fwd(q, k, v, causal, scale, hsplit=2)
    packed_flash_fwd.launches += 1
    B, Hp, T = q.shape[0], q.shape[1], q.shape[2]
    return o, lse.view(B, Hp, 2, T)


def packed_flash_bwd(q, k, v, o, lse, do, causal: bool = True,
                     scale: Optional[float] = None):
    """Backward from the forward's out and lse: (dq, dk, dv), packed."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // 2)
    if _fa._on_cpu(q, k, v, o, lse, do):
        return _fa._reference_bwd(q, k, v, do, causal, scale,
                                  packed_flash_reference)
    out = _fa.launch_bwd(q, k, v, o, lse, do, causal, scale, hsplit=2)
    packed_flash_bwd.launches += 1
    return out


packed_flash_fwd.launches = 0
packed_flash_bwd.launches = 0


def packed_flash_attention(q, k, v, causal: bool, scale: float):
    """Differentiable packed-pair attention: q/k/v [B, H/2, T, 128],
    `scale` the true per-head scale. Returns the packed output. CPU
    tensors run the plain version with autograd; CUDA tensors launch the
    kernels."""
    if _fa._on_cpu(q, k, v):
        return packed_flash_reference(q, k, v, causal, scale)
    return _fa._FlashFn.apply(q, k, v, causal, scale, packed_flash_fwd,
                              packed_flash_bwd)
