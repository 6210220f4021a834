"""Attention functional (port of paddle_tpu/nn/functional/attention.py).

`scaled_dot_product_attention` routes to a flash kernel or to composed
attention (`_sdpa`), as the JAX package does:
- packed head pairs (`_packed_pairs`, head dim 64) go to kernel K2
  (ops/kernels/packed_flash.py); the caller has applied its gate;
- no mask, no active dropout, the `use_flash_attention` flag on, the
  query at least `flash_attention_min_seq` long and the shape within
  K1's scope (ops/kernels/flash_attention.py `supported`): kernel K1,
  whatever q's dtype (it has float32, bfloat16 and float16 instances,
  so AMP's bf16 and fp16 both reach it; another dtype on CUDA raises);
- anything else, composed attention, deliberately.
`LAST_PATH` records which ("flash" or "composed").

Routing is loud. The JAX version catches every kernel exception and
falls back to composed attention with a warning; the port does not. On
CUDA tensors a kernel runs or raises; on CPU tensors the kernel wrappers
run their plain versions, so the routing and `LAST_PATH` read the same
on both devices.
"""
from __future__ import annotations

import math

import torch

from ...core import flags as _flags
from ...core import random as _random
from ...core.dispatch import op
from ...ops.kernels import flash_attention as _k1
from ...ops.kernels import packed_flash as _k2

__all__ = ["scaled_dot_product_attention"]

NEG_INF = -1e30

# which path the last call took: "flash" | "composed", and its q dtype
LAST_PATH = None
LAST_DTYPE = None


def _sdpa(q, k, v, mask, causal, scale, drop_mask, dropout_p,
          heads_major=False):
    """Composed attention in the inputs' dtype. q/k/v [B, T, H, D]
    (Paddle's layout) or [B, H, T, D] with heads_major; the output keeps
    the input layout. Masked scores are -1e30 in that dtype, which in
    float16 is -inf (the JAX package's -1e30 rounds there too)."""
    neg = NEG_INF if torch.finfo(q.dtype).min <= NEG_INF else -math.inf
    if heads_major:
        qh, kh, vh = q, k, v
    else:
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhtd,bhsd->bhts", qh, kh) * scale
    if causal:
        t, s = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(t, s, dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~keep, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, neg)
        else:
            logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    if drop_mask is not None:
        probs = probs * drop_mask / max(1.0 - dropout_p, 1e-12)
    out = torch.einsum("bhts,bhsd->bhtd", probs, vh)
    return out if heads_major else out.transpose(1, 2)


@op("scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None,
                                 _heads_major=False, _packed_pairs=False):
    """q/k/v: [batch, seq, num_heads, head_dim] (Paddle's layout).

    _heads_major (internal, used by models.gpt): q/k/v arrive as
    [batch, heads, seq, head_dim] and the output stays heads-major.
    _packed_pairs (internal): q/k/v arrive as [batch, heads/2, seq,
    2*head_dim], adjacent head pairs merged for K2; the output stays
    packed. The caller applies the gate (packed_flash.route_gate)."""
    global LAST_PATH, LAST_DTYPE
    q, k, v = query, key, value
    LAST_DTYPE = q.dtype
    if _packed_pairs:
        sc = scale if scale is not None else 1.0 / math.sqrt(
            q.shape[-1] // 2)
        out = _k2.packed_flash_attention(q, k, v, is_causal, sc)
        LAST_PATH = "flash"
        return out
    head_dim = q.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(head_dim)
    dropout_active = dropout_p > 0.0 and training
    seq_axis = 2 if _heads_major else 1
    q_seq, kv_seq = q.shape[seq_axis], k.shape[seq_axis]
    if (_flags.flag("use_flash_attention") and attn_mask is None
            and not dropout_active
            and q_seq >= _flags.flag("flash_attention_min_seq")
            and _k1.supported(q_seq, kv_seq, head_dim)):
        out = _k1.flash_attention(q, k, v, causal=is_causal, scale=sc,
                                  heads_major=_heads_major)
        LAST_PATH = "flash"
        return out
    LAST_PATH = "composed"
    drop_mask = None
    if dropout_active:
        if _heads_major:
            shape = (q.shape[0], q.shape[1], q_seq, kv_seq)
        else:
            shape = (q.shape[0], q.shape[2], q_seq, kv_seq)
        keep = torch.rand(shape, generator=_random.generator(q.device),
                          device=q.device) >= dropout_p
        drop_mask = keep.to(q.dtype)
    return _sdpa(q, k, v, attn_mask, is_causal, sc, drop_mask,
                 float(dropout_p), _heads_major)
