"""Ragged paged-attention decode and the fused k-token decode chunk.

Port of paddle_tpu/inference/serving/attention.py. One decode step for N
sequences at different positions against the block-pooled KV cache
(paged_cache.py): per layer the new token's K/V is written into each
sequence's reserved (block, offset) slot, then attention reads each
sequence's context through its block table, masked per sequence by
length. The math outside attention is the SAME code as the dense decode
(models.generation: _token_embed, _decode_qkv, _attn_merge/_decode_attn,
_decode_head).

Two attention routes, chosen explicitly by `kernel`:
- "ragged" (the engine default): ops/kernels/ragged_paged_attention,
  which reads the pools through the tables itself. On CUDA tensors that
  is the hand-written K3 kernel; on CPU tensors its plain version.
- "bucketed": gather each row's context into the dense [N, H, MB*bs, D]
  layout and run the dense masked attention (the JAX package's oracle).

Differences from the JAX package, all deliberate:
- the pools are updated IN PLACE; `fused_decode_chunk` returns them only
  for symmetry with the JAX signature;
- the lax.scan over k trips is a Python loop; every trip stays on the
  device (no host sync inside the chunk);
- a frozen row's write is masked out instead of dropped: torch has no
  dropping scatter (an out-of-range index raises on the CPU and asserts
  on CUDA), so a frozen row repeats a live row's write, or rewrites slot
  (0, 0) with its own value when no row runs (`_write_plan`);
- in-chunk sampling draws Gumbel noise from a counter-based integer hash
  of (seed, tokens generated, vocab index) where JAX used
  fold_in(PRNGKey(seed), out_cnt): the same request samples the same
  tokens on the CPU and the GPU and under any chunk size k, but not the
  JAX package's tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.anomaly import rows_not_finite
from ...models.generation import (NEG_INF, _attn_merge, _decode_attn,
                                  _decode_head, _decode_qkv, _sample_rows,
                                  _token_embed)
from ...ops.kernels.ragged_paged_attention import ragged_decode_attention

__all__ = ["gather_block_kv", "paged_decode_step", "fused_decode_chunk",
           "PACK_COLS", "pack_f32"]

KERNELS = ("ragged", "bucketed")


def gather_block_kv(pool, block_tables):
    """[num_blocks, bs, H, D] pool + [N, MB] tables -> [N, H, MB*bs, D]
    contiguous per-sequence context, positions in block-table order."""
    n, mb = block_tables.shape
    bs, h, d = pool.shape[1], pool.shape[2], pool.shape[3]
    ctx = pool[block_tables.long()]                  # [N, MB, bs, H, D]
    return ctx.reshape(n, mb * bs, h, d).transpose(1, 2)


def _write_plan(run, slot_blocks, slot_offsets):
    """Scatter targets for one trip's K/V write with frozen rows masked
    out, without a host sync: a frozen row repeats the first live row's
    (slot, value); with no live row every row rewrites slot (0, 0) with
    its current value. Duplicate targets then carry identical values, so
    the in-place index_put is deterministic. Returns (blocks, offsets,
    src, any_run): row r writes row src[r]'s value."""
    n = run.shape[0]
    first = torch.argmax(run.to(torch.int32))
    src = torch.where(run, torch.arange(n, device=run.device), first)
    any_run = run.any()
    zero = torch.zeros((), dtype=torch.long, device=run.device)
    blocks = torch.where(any_run, slot_blocks.long()[src], zero)
    offsets = torch.where(any_run, slot_offsets.long()[src], zero)
    return blocks, offsets, src, any_run


def _pool_write(kp, vp, k_new, v_new, plan) -> None:
    """Write the new token's K/V [N, H, 1, D] into the pools in place,
    following `_write_plan`."""
    blocks, offsets, src, any_run = plan
    for pool, new in ((kp, k_new), (vp, v_new)):
        vals = new[:, :, 0][src].to(pool.dtype)
        vals = torch.where(any_run, vals, pool[0, 0].expand_as(vals))
        pool[blocks, offsets] = vals


def _attend(params, i, x, q, kp, vp, tables, positions, lengths, geom,
            kernel):
    """Attention + the rest of block i for one query token per row."""
    if kernel == "ragged":
        att = ragged_decode_attention(q[:, :, 0, :].contiguous(), kp, vp,
                                      tables, lengths)
        return _attn_merge(params, i, x, att[:, :, None, :], geom)
    kc = gather_block_kv(kp, tables)
    vc = gather_block_kv(vp, tables)
    return _decode_attn(params, i, x, q, kc, vc, positions, geom)


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")


@torch.no_grad()
def paged_decode_step(params, pools, tokens, positions, block_tables,
                      slot_blocks, slot_offsets, geom, kernel="ragged"):
    """One ragged decode step over the block pool.

    pools: L-tuple of (k_pool, v_pool) [num_blocks, bs, H, D], written in
        place. tokens [N] (last sampled token), positions [N] (the new
        token's position == cached length), block_tables [N, MB] int32,
        slot_blocks/slot_offsets [N] (the new token's write slot; padded
        rows point slot_blocks outside [0, num_blocks) and are not
        written). Returns (logits [N, V], pools).
    """
    _check_kernel(kernel)
    dev = pools[0][0].device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.int32)
    positions = torch.as_tensor(positions, device=dev).to(torch.int32)
    tables = torch.as_tensor(block_tables, device=dev).to(
        torch.int32).contiguous()
    slot_blocks = torch.as_tensor(slot_blocks, device=dev)
    slot_offsets = torch.as_tensor(slot_offsets, device=dev)
    run = (slot_blocks >= 0) & (slot_blocks < pools[0][0].shape[0])
    plan = _write_plan(run, slot_blocks, slot_offsets)
    lengths = positions + 1
    x = _token_embed(params, tokens, positions)
    for i, (kp, vp) in enumerate(pools):
        qkv = _decode_qkv(params, i, x, geom)
        _pool_write(kp, vp, qkv[1], qkv[2], plan)
        x = _attend(params, i, x, qkv[0], kp, vp, tables, positions,
                    lengths, geom, kernel)
    return _decode_head(params, x), pools


# ----------------------------------- fused k-token decode + prefill chunks
# Packed per-sequence control state, one int32 [N, PACK_COLS + k + MB]
# upload per chunk (float fields travel as raw f32 bits):
#   0 tok        last sampled token (the next step's input)
#   1 pos        next KV write position (== cached length)
#   2 active     1 for live rows, 0 for padding
#   3 out_cnt    tokens generated so far (keys the in-chunk sampling)
#   4 max_out    SamplingParams.max_tokens
#   5 eos        eos_token_id, -1 when unset
#   6 temp       temperature as float32 bits
#   7 top_k      0 = disabled
#   8 top_p      top_p as float32 bits (>=1.0 = disabled)
#   9 seed       per-request sampling seed (masked to 31 bits)
#   10 pf_feed   prompt tokens to consume this chunk (0 = pure decode row)
#   11 pf_more   1 if prompt remains after this chunk
#   12..12+k-1   the pf_feed prompt tokens for this chunk (0-padded)
#   12+k..       the block table row [MB]
PACK_COLS = 12


def pack_f32(x) -> int:
    """Host-side helper: float -> raw float32 bits as a python int, for
    the packed control columns above."""
    return int(np.float32(x).view(np.int32))


@torch.no_grad()
def fused_decode_chunk(params, pools, packed, geom, k: int,
                       kernel: str = "ragged"):
    """k decode steps for N sequences on the device, with sampling and
    termination tracking. The host uploads ONE packed int32 array
    (layout at PACK_COLS) and fetches ONE int32 [k+2, N] result:

        rows 0..k-1   sampled token per trip, -1 where the row was frozen
                      (inactive / finished / flagged bad) or silently
                      consuming a prompt token
        row  k        finished mask after the chunk (EOS or max_tokens)
        row  k+1      per-row not-finite flag, latched at the first bad
                      trip

    Chunked prefill: rows with pf_feed > 0 spend their first pf_feed trips
    consuming prompt tokens from the feed columns (KV written, nothing
    sampled); the trip that consumes the last prompt token (pf_left == 1
    and pf_more == 0) samples the request's first output, then the row
    decodes normally. Frozen rows keep their carry and write nothing.
    Sampling depends only on (seed, tokens generated), so a chunk emits
    the same tokens as k single-trip chunks.

    kernel: "ragged" (K3 on CUDA, its plain version on the CPU) or
    "bucketed" (gather + dense attention). pools are written in place.
    Returns (out [k+2, N] int32, pools).
    """
    _check_kernel(kernel)
    S = geom[3]
    packed = torch.as_tensor(packed, device=pools[0][0].device)
    tables = packed[:, PACK_COLS + k:].contiguous()
    feed = packed[:, PACK_COLS:PACK_COLS + k].t()      # [k, N]
    block_size = pools[0][0].shape[1]
    n = packed.shape[0]
    active = packed[:, 2] > 0
    max_out = packed[:, 4]
    eos = packed[:, 5]
    temps = packed[:, 6].contiguous().view(torch.float32)
    top_ks = packed[:, 7]
    top_ps = packed[:, 8].contiguous().view(torch.float32)
    seeds = packed[:, 9]
    pf_more = packed[:, 11] > 0
    tok, pos, out_cnt = packed[:, 0], packed[:, 1], packed[:, 3]
    pf_left = packed[:, 10]
    finished = torch.zeros(n, dtype=torch.bool, device=packed.device)
    bad = torch.zeros_like(finished)
    emits = []
    for j in range(k):
        run = active & ~finished & ~bad
        prefilling = run & (pf_left > 0)
        last_pf = prefilling & (pf_left == 1) & ~pf_more
        sampling = (run & ~prefilling) | last_pf
        tok_in = torch.where(prefilling, feed[j], tok)
        blk_idx = torch.where(run, pos // block_size, 0).long()
        slot_blocks = tables.gather(1, blk_idx[:, None])[:, 0]
        plan = _write_plan(run, slot_blocks, pos % block_size)
        # frozen rows may sit at pos == max_seq_len: clamp their (unused)
        # embedding lookup in range, as JAX's clamping gather does
        x = _token_embed(params, tok_in, pos.clamp(max=S - 1))
        lengths = torch.where(run, pos + 1, 0).to(torch.int32)
        for i, (kp, vp) in enumerate(pools):
            qkv = _decode_qkv(params, i, x, geom)
            _pool_write(kp, vp, qkv[1], qkv[2], plan)
            x = _attend(params, i, x, qkv[0], kp, vp, tables, pos, lengths,
                        geom, kernel)
        logits = _decode_head(params, x)
        row_bad = rows_not_finite(logits) & run
        bad = bad | row_bad
        tok_new = _sample_rows(logits, seeds, out_cnt, temps, top_ks,
                               top_ps)
        ok = run & ~row_bad
        step_ok = ok & sampling
        emits.append(torch.where(step_ok, tok_new, -1))
        finished = finished | (step_ok & ((tok_new == eos)
                                          | (out_cnt + 1 >= max_out)))
        tok = torch.where(step_ok, tok_new, tok)
        pos = torch.where(ok, pos + 1, pos)
        out_cnt = torch.where(step_ok, out_cnt + 1, out_cnt)
        pf_left = torch.where(ok & prefilling, pf_left - 1, pf_left)
    out = torch.cat([torch.stack(emits).to(torch.int32),
                     finished[None].to(torch.int32),
                     bad[None].to(torch.int32)], dim=0)
    return out, pools
