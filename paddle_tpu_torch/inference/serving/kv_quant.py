"""int8 KV-block codec: per-block-per-head symmetric quantization.

Port of paddle_tpu/inference/serving/kv_quant.py, the codec behind
`PagedKVCache(kv_cache_dtype="int8")` and its quantized host-tier
spills. The JAX package's codec is XLA-fused jnp code; here it is plain
torch with the same operations in the same order, so on the CPU the
codes and scales equal the JAX codec's bit for bit (tests/
test_torch_kv_quant.py).

Scheme (symmetric, zero-point-free, so 0.0 encodes exactly and a fresh
all-zero block stays all-zero):

    scale[b, h] = absmax over block b, head h / 127
    q           = clip(round(x / scale), -127, 127)  int8
    x_hat       = q * scale

Worst-case error relative to the (block, head) tile's absmax:
0.5 * scale = 0.5/127 * absmax, `KV_INT8_REL_ERR`, in exact arithmetic;
float32 rounding adds at most `KV_INT8_ROUNDING` (two ulps of the
absmax).

`requantize_blocks` keeps scales MONOTONE (s' = max(s_old, absmax/127)),
so a block whose dequantized content did not change re-encodes to the
same codes. `requantize_blocks_` is the in-place form the paged cache
uses on its stored codes and scales.

Left out: the jaxnum registry hook (`kv_block_roundtrip` is kept as the
plain quantize-dequantize composition; the port has no numerics
analyzer yet).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["KV_INT8_LEVELS", "KV_INT8_REL_ERR", "KV_INT8_ROUNDING",
           "quantize_blocks",
           "requantize_blocks", "requantize_blocks_", "dequantize_blocks",
           "kv_block_roundtrip"]

#: symmetric int8 code range [-127, 127] (-128 unused, so |q| * scale
#: never exceeds absmax)
KV_INT8_LEVELS = 127

#: worst-case dequantization error relative to the (block, head) tile's
#: absmax at quantization time
KV_INT8_REL_ERR = 0.5 / KV_INT8_LEVELS

#: what float32 rounding adds to KV_INT8_REL_ERR, relative to the tile's
#: absmax A: x/s is rounded before round() (|x/s - q| <= 0.5 + 127 *
#: 2^-24) and q * s after it (127 s * 2^-24), together at most
#: 254 s * 2^-24 = 2^-23 A, plus the scale's own rounding (under 1e-9 A);
#: two ulps of A cover both. A quantize-dequantize round trip in float32
#: stays within KV_INT8_REL_ERR + KV_INT8_ROUNDING of A.
KV_INT8_ROUNDING = 2.0 ** -22

# 1/127 rounded to float32, held as the python float of that value
_INV_LEVELS = float(np.float32(1.0 / KV_INT8_LEVELS))


def _safe(scale):
    # an all-zero tile has scale 0; dividing by 1 keeps its codes 0
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def _level_scale(x):
    """absmax over each (block, head) tile of x [n, bs, H, D] -> [n, H],
    divided by KV_INT8_LEVELS as the compiled JAX codec divides it: XLA
    turns the division by the constant into a product with its float32
    reciprocal, which is one ulp off true division in some tiles
    (tests/test_torch_kv_quant.py holds both facts)."""
    return x.abs().amax(dim=(1, 3)) * _INV_LEVELS


def _encode(x, scale):
    s = _safe(scale)[:, None, :, None]
    q = torch.clamp(torch.round(x / s), -KV_INT8_LEVELS, KV_INT8_LEVELS)
    return q.to(torch.int8)


def quantize_blocks(x):
    """Fresh per-(block, head) encode of x [n, block_size, H, D] ->
    (q int8, scale f32 [n, H])."""
    scale = _level_scale(x)
    return _encode(x, scale), scale


def requantize_blocks(x, prev_scale):
    """Monotone-scale encode: scales never shrink, so a block whose
    dequantized content is unchanged keeps its codes."""
    scale = torch.maximum(prev_scale, _level_scale(x))
    return _encode(x, scale), scale


def requantize_blocks_(q_pool, s_pool, ids, x) -> None:
    """In-place `requantize_blocks` of the f32 content x [n, bs, H, D]
    into the stored codes q_pool[ids] and scales s_pool[ids]."""
    q, s = requantize_blocks(x, s_pool[ids])
    q_pool[ids] = q
    s_pool[ids] = s


def dequantize_blocks(q, scale):
    """Decode (q int8 [n, bs, H, D], scale f32 [n, H]) -> f32."""
    return q.to(scale.dtype) * scale[:, None, :, None]


def kv_block_roundtrip(x):
    """quantize -> dequantize composition (the codec's error probe)."""
    q, scale = quantize_blocks(x)
    return dequantize_blocks(q, scale)
