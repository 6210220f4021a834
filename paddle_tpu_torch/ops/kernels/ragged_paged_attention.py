"""Ragged paged attention for decode (kernel K3 of the port).

One query token per row attends over exactly `lengths[i]` KV positions
read straight from the paged-cache block pools through the row's block
table: no bucket padding, and a dead row (length 0) costs no work.

Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_paged_attention.py
:60-173 (`ragged_decode_attention`, `pl.pallas_call` at :165) with the
hand-written CUDA kernel csrc/ragged_paged_attention.cu: flash-decoding
in one launch. The KV axis of each (row, head) is split across CTAs of
`blocks_per_split` table blocks each, every CTA streams its blocks
through a cp.async ring and writes a partial softmax state, and the
last CTA of the (row, head) to finish merges the partials (its header
says what bounds it and how the design answers that).

Plain PyTorch versions, both of the same function:
- `ragged_attention_reference`: a loop over the table's block axis doing
  the streaming-softmax update (the port of the JAX lax.scan reference,
  :177). The wrapper runs it for tensors on the CPU.
- `ragged_attention_split_reference`: the kernel's order of work, the
  same update over each split's blocks from a fresh state, then the
  merge of the partials in split order. The tests and chip_smoke.py hold
  the kernel against it; the main path never calls it.
For CUDA tensors the wrapper launches the kernel or raises, never
falling back.

Semantics (all versions): masked scores are -1e30, `scale` defaults to
1/sqrt(D), the math is f32, table entries at or past a row's length are
never read, and an entry outside [0, num_blocks) inside the length skips
its whole block (the JAX reference's rule; the Pallas kernel would clamp
such an entry to block 0 and read it). A split whose every block is
skipped contributes nothing; a row with no live block returns zeros.

The wrapper picks `blocks_per_split` from (N, H, max_blocks) and the
card's SM count alone, never from `lengths` (reading them would sync the
device inside the decode chunk), and keeps the merge's scratch (partials
and arrival counters) per device and stream.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["ragged_decode_attention", "ragged_attention_reference",
           "ragged_attention_split_reference", "default_blocks_per_split",
           "sm_count"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_BLOCK_SIZE = 128
# CTAs a launch aims at for each SM when every row is full (three fit on
# an SM at once, so the last wave is short)
_CTAS_PER_SM = 4
# the most table blocks one CTA takes (the kernel reads them up front),
# and the most splits of one (row, head) (the merge reads their m and l
# up front)
_MAX_SPLIT_BLOCKS = 128
_MAX_SPLITS = 128


def _stream(qf, k_pool, v_pool, tables, lens, blocks, scale, n_pool):
    """The streaming-softmax update over table blocks `blocks` from a
    fresh state: (m [N, H, 1], l [N, H, 1], acc [N, H, D]) in f32."""
    n, h, d = qf.shape
    bs = k_pool.shape[1]
    m = torch.full((n, h, 1), NEG_INF, dtype=torch.float32, device=qf.device)
    l = torch.zeros((n, h, 1), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((n, h, d), dtype=torch.float32, device=qf.device)
    offs = torch.arange(bs, device=qf.device)
    for j in blocks:
        idx = tables[:, j]
        live = (j * bs < lens) & (idx >= 0) & (idx < n_pool)
        safe = torch.where(live, idx, torch.zeros_like(idx))
        k = k_pool[safe].float()                       # [N, bs, H, D]
        v = v_pool[safe].float()
        s = torch.einsum("nhd,nshd->nhs", qf, k) * scale
        pos = j * bs + offs
        s = s.masked_fill(~(pos[None, None, :] < lens[:, None, None]),
                          NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = alpha * l + p.sum(dim=2, keepdim=True)
        acc_new = acc * alpha + torch.einsum("nhs,nshd->nhd", p, v)
        keep = live[:, None, None]
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
        acc = torch.where(keep, acc_new, acc)
    return m, l, acc


def _finish(acc, l, dtype):
    """acc / l, and exact zeros where l is 0 (no live block)."""
    return (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(dtype)


def ragged_attention_reference(q, k_pool, v_pool, block_tables, lengths,
                               scale: Optional[float] = None):
    """Plain version. q [N, H, D]; pools [NB, bs, H, D]; block_tables
    [N, MB] int; lengths [N] int. Returns [N, H, D] in q's dtype; dead
    rows return zeros."""
    d = q.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    m, l, acc = _stream(q.float(), k_pool, v_pool, block_tables.long(),
                        lengths.long(), range(block_tables.shape[1]), scale,
                        k_pool.shape[0])
    return _finish(acc, l, q.dtype)


def ragged_attention_split_reference(q, k_pool, v_pool, block_tables,
                                     lengths, blocks_per_split: int,
                                     scale: Optional[float] = None):
    """Plain version in the kernel's order: the table's block axis cut
    into splits of `blocks_per_split` blocks, each split's partial
    (m, l, acc) streamed from a fresh state, then the partials merged in
    split order: with M the largest m of the splits that have l > 0,
    out = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - M), and
    w_s = 0 for a split with l = 0 (none of its blocks live). A row
    with no live split returns zeros."""
    if blocks_per_split < 1:
        raise ValueError(f"blocks_per_split must be >= 1, got "
                         f"{blocks_per_split}")
    d = q.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    mb = block_tables.shape[1]
    qf, tables, lens = q.float(), block_tables.long(), lengths.long()
    parts = [_stream(qf, k_pool, v_pool, tables, lens,
                     range(j0, min(j0 + blocks_per_split, mb)), scale,
                     k_pool.shape[0])
             for j0 in range(0, mb, blocks_per_split)]
    mx = torch.full_like(parts[0][0], NEG_INF)
    for m, l, _ in parts:
        mx = torch.where(l > 0, torch.maximum(mx, m), mx)
    lsum = torch.zeros_like(mx)
    out = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - mx), torch.zeros_like(m))
        lsum = lsum + w * l
        out = out + w * acc
    return _finish(out, lsum, q.dtype)


def default_blocks_per_split(n: int, h: int, max_blocks: int,
                             num_sms: int) -> int:
    """Table blocks per CTA along the KV axis: the fewest that keep
    n * h * ceil(max_blocks / blocks) at or under _CTAS_PER_SM * num_sms,
    so rows at full length fill the card, in at most _MAX_SPLITS splits.
    A function of the shapes and the card alone (3 at the serving shape,
    8 x 6 heads x 32 columns, on the H100's 132 SMs)."""
    splits = max(1, min(max_blocks, _CTAS_PER_SM * num_sms // max(n * h, 1),
                        _MAX_SPLITS))
    return -(-max_blocks // splits)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA `device`, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ragged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                            scale: Optional[float] = None, *,
                            blocks_per_split: Optional[int] = None):
    """One attention step over ragged paged KV state.

    q [N, H, D]; k_pool/v_pool [num_blocks, block_size, H, D];
    block_tables [N, MB] int32; lengths [N] int32 (0 = dead row).
    Returns [N, H, D] in q's dtype. CPU tensors run the plain version;
    CUDA tensors launch the kernel (f32 or bf16, q and pools of one
    dtype, all contiguous on one device, D * element size a multiple of
    16 bytes) and count the launch in `ragged_decode_attention.launches`.
    `blocks_per_split` (1..128) overrides the split size that the wrapper
    picks (`default_blocks_per_split(N, H, MB, sm_count(q.device))`);
    the result does not
    depend on it beyond the order of summation."""
    args = (q, k_pool, v_pool, block_tables, lengths)
    if not q.is_cuda and all(t.device.type == "cpu" for t in args):
        return ragged_attention_reference(*args, scale)
    _check(*args)
    n, h, d = q.shape
    num_blocks, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bps = default_blocks_per_split(n, h, mb, sm_count(q.device)) \
        if blocks_per_split is None else blocks_per_split
    if not 1 <= bps <= _MAX_SPLIT_BLOCKS or -(-mb // bps) > _MAX_SPLITS:
        raise ValueError(f"blocks_per_split {bps} over {mb} table columns: "
                         f"the kernel takes 1..{_MAX_SPLIT_BLOCKS} blocks "
                         f"a split and at most {_MAX_SPLITS} splits")
    out = torch.empty_like(q)
    lib = _lib()
    dev = q.device
    # the launch goes to the calling thread's current device: switch only
    # when q lies elsewhere (the switch costs host time on every call)
    with torch.cuda.device(dev) if dev.index != torch.cuda.current_device() \
            else contextlib.nullcontext():
        stream = torch.cuda.current_stream(dev)
        partials, counters = _scratch(dev, stream, n, h, -(-mb // bps), d)
        err = lib.ragged_paged_attention(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), partials, counters, n, h, d, num_blocks, bs,
            mb, bps, float(scale), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed: cudaError {err}")
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0

# (device, stream) -> (partials f32, counters int32): the merge's scratch,
# grown on demand. The counters are zero between launches (the merging
# CTA resets its own), and launches that share them are ordered on one
# stream.
_SCRATCH: Dict[Tuple[torch.device, int],
               Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device, stream, n, h, splits, d) -> Tuple[int, int]:
    """Pointers to partials [n, h, splits, d + 2] and counters [n, h]
    (0, 0 when a row never splits)."""
    if splits == 1:
        return 0, 0
    key = (device, stream.cuda_stream)
    partials, counters = _SCRATCH.get(key, (None, None))
    need = n * h * splits * (d + 2)
    if partials is None or partials.numel() < need:
        partials = torch.empty(need, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n * h:
        counters = torch.zeros(n * h, dtype=torch.int32, device=device)
    _SCRATCH[key] = (partials, counters)
    return partials.data_ptr(), counters.data_ptr()


def _check(q, k_pool, v_pool, block_tables, lengths) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q is on {dev}; the kernel takes CUDA tensors")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}, {v_pool.dtype}) must "
                        f"match q ({q.dtype})")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if q.ndim != 3 or k_pool.ndim != 4 or block_tables.ndim != 2 \
            or lengths.ndim != 1:
        raise ValueError("expected q [N,H,D], pools [NB,bs,H,D], "
                         "block_tables [N,MB], lengths [N]")
    n, h, d = q.shape
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[2:]) != (h, d):
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_tables.shape[0] != n or lengths.shape[0] != n:
        raise ValueError("block_tables and lengths need one row per q row")
    if not 1 <= d <= _MAX_HEAD_DIM or d * q.element_size() % 16:
        raise ValueError(f"head_dim {d}: the kernel takes 1..{_MAX_HEAD_DIM} "
                         f"with rows of a multiple of 16 bytes")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not 1 <= k_pool.shape[1] <= _MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {k_pool.shape[1]} outside "
                         f"[1, {_MAX_BLOCK_SIZE}]")
    if block_tables.shape[1] < 1:
        raise ValueError("block_tables needs at least one column")


def _lib() -> ctypes.CDLL:
    lib = _build.load("ragged_paged_attention")
    fn = lib.ragged_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
