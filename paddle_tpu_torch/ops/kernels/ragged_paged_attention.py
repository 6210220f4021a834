"""Ragged paged attention for decode (kernel K3 of the port).

One query token per row attends over exactly `lengths[i]` KV positions
read straight from the paged-cache block pools through the row's block
table: no bucket padding, and a dead row (length 0) costs no work.

Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_paged_attention.py
:60-173 (`ragged_decode_attention`, `pl.pallas_call` at :165) with the
hand-written CUDA kernel csrc/ragged_paged_attention.cu (its header says
what bounds it and what the simple design leaves for later).

`ragged_attention_reference` is the plain PyTorch version: a loop over
the table's block axis doing the same streaming-softmax update as the
kernel (the port of the JAX lax.scan reference, :177). The wrapper runs
it for tensors on the CPU; for CUDA tensors it launches the kernel or
raises, never falling back.

Semantics (both versions): masked scores are -1e30, `scale` defaults to
1/sqrt(D), the math is f32, table entries at or past a row's length are
never read, and an entry outside [0, num_blocks) inside the length skips
its whole block (the JAX reference's rule; the Pallas kernel would clamp
such an entry to block 0 and read it).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["ragged_decode_attention", "ragged_attention_reference"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_BLOCK_SIZE = 128


def ragged_attention_reference(q, k_pool, v_pool, block_tables, lengths,
                               scale: Optional[float] = None):
    """Plain version. q [N, H, D]; pools [NB, bs, H, D]; block_tables
    [N, MB] int; lengths [N] int. Returns [N, H, D] in q's dtype; dead
    rows return zeros."""
    n, h, d = q.shape
    num_blocks, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tables = block_tables.long()
    lens = lengths.long()
    qf = q.float()
    m = torch.full((n, h, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((n, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, h, d), dtype=torch.float32, device=q.device)
    offs = torch.arange(bs, device=q.device)
    for j in range(mb):
        idx = tables[:, j]
        live = (j * bs < lens) & (idx >= 0) & (idx < num_blocks)
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
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / denom).to(q.dtype)


def ragged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                            scale: Optional[float] = None):
    """One attention step over ragged paged KV state.

    q [N, H, D]; k_pool/v_pool [num_blocks, block_size, H, D];
    block_tables [N, MB] int32; lengths [N] int32 (0 = dead row).
    Returns [N, H, D] in q's dtype. CPU tensors run the plain version;
    CUDA tensors launch the kernel (f32 or bf16, q and pools of one
    dtype, all contiguous on one device) and count the launch in
    `ragged_decode_attention.launches`."""
    args = (q, k_pool, v_pool, block_tables, lengths)
    if all(t.device.type == "cpu" for t in args):
        return ragged_attention_reference(q, k_pool, v_pool, block_tables,
                                          lengths, scale)
    _check(q, k_pool, v_pool, block_tables, lengths)
    n, h, d = q.shape
    num_blocks, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ragged_paged_attention(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), n, h, d, num_blocks, bs, mb, float(scale),
            stream)
    if err != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed: cudaError {err}")
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0


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
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside [1, {_MAX_HEAD_DIM}]")
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
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
