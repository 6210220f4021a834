"""Paged KV cache: a fixed block pool + per-sequence block tables.

Port of the core of paddle_tpu/inference/serving/paged_cache.py. KV
lives in a per-layer block pool [num_blocks, block_size, H, D]; a
sequence owns an ordered list of block ids (its block table) and holds
ceil(len / block_size) blocks. Token position p of a sequence lives in
table entry p // block_size at slot p % block_size.

Host/device split: block accounting (free list, tables, lengths,
counters) is plain Python. The pools are torch tensors on the engine's
device and are updated IN PLACE (`write_prefill`, `scrub_blocks` and the
fused decode chunk write into them), where the JAX package rebinds new
arrays.

Not ported yet (raise NotImplementedError): the prefix cache, the host
spill tier and int8 KV blocks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ...core.place import DeviceLike, resolve_device
from ...core.unported import require_defaults

__all__ = ["PagedKVCache", "CacheExhausted"]


class CacheExhausted(RuntimeError):
    """Block pool exhaustion report: who needed how much vs. what's free.
    The scheduler catches this to preempt."""

    def __init__(self, seq_id, needed: int, free: int, total: int,
                 what: str = "block"):
        self.seq_id = seq_id
        self.needed = needed
        self.free = free
        self.total = total
        super().__init__(
            f"KV {what} pool exhausted: seq {seq_id!r} needs {needed} "
            f"{what}(s), {free}/{total} free")


class PagedKVCache:
    """Fixed-size per-layer KV block pools with alloc/free accounting.

    pools: L-tuple of (k_pool, v_pool), each [num_blocks, block_size, H,
    D] on `device`, zero-filled at start. Lifetime counters:
    blocks_allocated == blocks_freed once every sequence is freed (the
    zero-leak invariant `check_integrity` audits)."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int, block_size: int,
                 dtype: torch.dtype = torch.float32,
                 enable_prefix_cache: bool = False,
                 host_tier_blocks: int = 0,
                 promote_timeout_s: Optional[float] = None,
                 kv_cache_dtype: str = "float32", *,
                 device: DeviceLike = None):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        if enable_prefix_cache or host_tier_blocks:
            raise NotImplementedError("later slice")
        require_defaults("PagedKVCache",
                         promote_timeout_s=(promote_timeout_s, None))
        if kv_cache_dtype != "float32":
            if kv_cache_dtype == "int8":
                raise NotImplementedError("later slice")
            raise ValueError(f"kv_cache_dtype must be 'float32' or 'int8', "
                             f"got {kv_cache_dtype!r}")
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_cache_dtype = kv_cache_dtype
        self.device = resolve_device(device)
        shape = (num_blocks, block_size, num_heads, head_dim)
        self.pools: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = tuple(
            (torch.zeros(shape, dtype=dtype, device=self.device),
             torch.zeros(shape, dtype=dtype, device=self.device))
            for _ in range(num_layers))
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lens: Dict[object, int] = {}
        self.blocks_allocated = 0
        self.blocks_freed = 0
        self.alloc_failures = 0
        self.high_water = 0

    # ------------------------------------------------------------ queries
    def num_free(self) -> int:
        return len(self._free)

    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def utilization(self) -> float:
        return self.num_used() / self.num_blocks

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def has_seq(self, seq_id) -> bool:
        return seq_id in self._tables

    def seq_len(self, seq_id) -> int:
        return self._lens[seq_id]

    def block_table(self, seq_id) -> List[int]:
        return list(self._tables[seq_id])

    # ------------------------------------------------------- alloc / free
    def _take_blocks(self, seq_id, n: int) -> List[int]:
        if n > len(self._free):
            self.alloc_failures += 1
            raise CacheExhausted(seq_id, n, len(self._free),
                                 self.num_blocks)
        got = [self._free.pop() for _ in range(n)]
        self.blocks_allocated += n
        self.high_water = max(self.high_water, self.num_used())
        return got

    def allocate(self, seq_id, num_tokens: int) -> List[int]:
        """Claim blocks for a new sequence of num_tokens cached tokens
        (0 for a chunked admission, whose prefill grows the table).
        Raises CacheExhausted without side effects."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id!r} already allocated")
        ids = self._take_blocks(seq_id, self.blocks_needed(num_tokens))
        self._tables[seq_id] = ids
        self._lens[seq_id] = num_tokens
        return ids

    def append_slot(self, seq_id) -> Tuple[int, int, int]:
        """Reserve the slot for the sequence's next token, growing the
        table by one block on a block boundary. Returns (block_id,
        offset, position); CacheExhausted leaves the sequence as it
        was."""
        return self.reserve_slots(seq_id, 1)

    def reserve_slots(self, seq_id, n: int) -> Tuple[int, int, int]:
        """Reserve the slots for the sequence's next n tokens in one
        atomic claim (the fused k-token decode writes slot j at position
        + j) and advance the length by n. Returns the FIRST reserved slot
        (block_id, offset, position). A sequence that finishes mid-chunk
        leaves its tail unwritten; the whole table is freed with it."""
        if n <= 0:
            raise ValueError(f"reserve_slots needs n >= 1, got {n}")
        pos = self._lens[seq_id]
        table = self._tables[seq_id]
        need = self.blocks_needed(pos + n) - len(table)
        if need > 0:
            table.extend(self._take_blocks(seq_id, need))
        self._lens[seq_id] = pos + n
        return table[pos // self.block_size], pos % self.block_size, pos

    def free(self, seq_id, scrub: bool = False) -> int:
        """Drop seq_id's table (completion, preemption, cancellation) and
        return its blocks to the pool. `scrub=True` (quarantine/recovery)
        zeroes them first: finite stale KV is erased exactly by the
        attention length mask, but NaN survives it (0 * NaN = NaN), so a
        poisoned block must not re-enter the free list carrying NaN."""
        ids = self._tables.pop(seq_id)
        self._lens.pop(seq_id)
        if scrub:
            self.scrub_blocks(ids)
        self._free.extend(reversed(ids))
        self.blocks_freed += len(ids)
        return len(ids)

    def scrub_blocks(self, block_ids) -> None:
        """Zero the given blocks in every layer's pools, in place."""
        if not block_ids:
            return
        idx = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.device)
        for kp, vp in self.pools:
            kp[idx] = 0.0
            vp[idx] = 0.0

    def check_integrity(self) -> dict:
        """Invariant audit: the free list and the table-owned blocks must
        exactly partition the pool, no block may sit in two tables or
        twice on the free list, and the lifetime counters must account
        for every block off the free list. Returns the audit dict;
        raises RuntimeError on any violation."""
        in_tables = [b for ids in self._tables.values() for b in ids]
        owned = set(in_tables)
        free = set(self._free)
        report = {
            "leaked": self.num_blocks - len(owned | free),
            "double_owned": len(in_tables) - len(owned),
            "double_free": len(self._free) - len(free),
            "free_and_owned": len(owned & free),
            "counter_drift": (self.blocks_allocated - self.blocks_freed)
            - (self.num_blocks - len(self._free)),
        }
        if any(report.values()):
            raise RuntimeError(f"paged cache integrity violated: {report} "
                               f"(tables={len(self._tables)}, "
                               f"free={len(free)}/{self.num_blocks})")
        return report

    # ------------------------------------------------------- device side
    @torch.no_grad()
    def write_prefill(self, seq_id, dense_cache, num_tokens: int,
                      batch_index: int = 0) -> None:
        """Scatter one sequence's dense prefill cache (the L-list of
        (k [B, H, S, D], v) from models.generation.prefill) into its
        allocated blocks, in place. Positions past num_tokens inside the
        last block are copied as the prefill left them (zero), matching
        a fresh block."""
        ids = self._tables[seq_id]
        n_blocks, bs = len(ids), self.block_size
        if n_blocks == 0:
            return
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)

        def blocks(dense):
            # [H, S, D] -> [S, H, D] -> [n_blocks, bs, H, D]
            blk = dense[batch_index].transpose(0, 1)[:n_blocks * bs]
            return blk.reshape(n_blocks, bs, self.num_heads, self.head_dim)

        for (kp, vp), (kc, vc) in zip(self.pools, dense_cache):
            kp[idx] = blocks(kc).to(kp.dtype)
            vp[idx] = blocks(vc).to(vp.dtype)

    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "kv_cache_dtype": self.kv_cache_dtype,
            "free": self.num_free(),
            "used": self.num_used(),
            "utilization": self.utilization(),
            "blocks_allocated": self.blocks_allocated,
            "blocks_freed": self.blocks_freed,
            "alloc_failures": self.alloc_failures,
            "high_water": self.high_water,
        }
