"""Paged KV cache: a fixed block pool + per-sequence block tables.

Port of paddle_tpu/inference/serving/paged_cache.py. KV lives in a
per-layer block pool [num_blocks, block_size, H, D]; a sequence owns an
ordered list of block ids (its block table) and holds
ceil(len / block_size) blocks. Token position p of a sequence lives in
table entry p // block_size at slot p % block_size.

Prefix caching (`enable_prefix_cache=True`): blocks are REFCOUNTED and
content-addressed through a radix trie (prefix_cache.py) at full-block
granularity. Admission attaches the longest cached prefix of a prompt
to the new sequence's table (the same physical blocks, refcount + 1),
forks a private copy-on-write block when the prompt diverges mid-block,
and only the uncached suffix is prefilled. A freed block returns to the
free list at refcount 0 unless the trie indexes it: then it is RETAINED
(evictable, LRU leaf first). Scrub is refcount-aware: a quarantined
sequence scrubs only blocks it held last, and distrusts (trie-evicts
and taints) what it shared; a tainted block is scrubbed when its last
reference drops.

Host tier (`host_tier_blocks > 0`): eviction demotes instead of
freeing. The victim's payload is spilled to a HostTierStore (numpy
copies plus a sha256 digest) and its trie node turns host-resident; a
later match promotes the payload back into a fresh device block
(`ensure_promoted`), re-verifying the digest. A promotion that is
killed, times out, races a store eviction or fails the digest degrades
to re-prefill of the missing suffix.

int8 pools (`kv_cache_dtype="int8"`): the pools are STORED as int8 codes
plus per-(block, head) f32 scales (kv_quant.py). `pools` stays the
logical f32 interface: the getter dequantizes, the setter re-encodes
with monotone scales. The decode chunk does not go through it: it reads
`stage_chunk`, a transient f32 copy of only the blocks the chunk's rows
name, and `commit_chunk` re-encodes only the blocks the chunk wrote
(every other block's codes are what a monotone re-encode of the whole
pool would leave). Host-tier spills in this mode carry the codes and
the scale rows under one digest.

Host/device split: block accounting (free list, tables, lengths,
refcounts, trie, counters) is plain Python. The pools are torch tensors
on the engine's device and are updated IN PLACE, where the JAX package
rebinds new arrays. In-place writes make sharing dangerous: a write
into a block that the trie or another table holds would change every
sharer. So every write path checks first that its blocks are private
(`write_blocks`, refcount 1 and not indexed) and raises otherwise.

Left out (later slices): KV migration and peer prefix fetch
(`export_blocks`, `import_blocks`, `export_prefix`, `admit_prefix`,
`payload_bytes` raise NotImplementedError), the tenant plumbing
(`note_seq_tenant`, share-weighted eviction: every node belongs to the
"default" tenant), and the flight-recorder dump on a failed audit.
"""
from __future__ import annotations

import hashlib
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.place import DeviceLike, resolve_device
from . import kv_quant
from .host_tier import HostTierStore
from .prefix_cache import PrefixCacheIndex, PrefixNode

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


def _later_slice(what: str):
    raise NotImplementedError(
        f"PagedKVCache.{what} (KV migration / peer prefix fetch) is not "
        f"ported yet")


class PagedKVCache:
    """Fixed-size per-layer KV block pools with alloc/free accounting.

    Block lifecycle: free list -> owned (refcount = number of tables
    holding the block) -> back to the free list at refcount 0, or, when
    the prefix trie indexes it, retained at refcount 0 as an evictable
    cached block. `blocks_allocated`/`blocks_freed` count free-list
    crossings only; with the prefix cache off they reconcile to
    allocated == freed once every sequence is freed."""

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
        if kv_cache_dtype not in ("float32", "int8"):
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

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if kv_cache_dtype == "int8":
            self._qpools = tuple((zeros(shape, torch.int8),
                                  zeros(shape, torch.int8))
                                 for _ in range(num_layers))
            self._scales = tuple(
                (zeros((num_blocks, num_heads), torch.float32),
                 zeros((num_blocks, num_heads), torch.float32))
                for _ in range(num_layers))
            self._pools = None
        else:
            self._qpools = self._scales = None
            self._pools = tuple((zeros(shape, dtype), zeros(shape, dtype))
                                for _ in range(num_layers))
        # int8 mode: the decode chunk's f32 staging buffers, grown on
        # demand (stage_chunk)
        self._stage: Optional[tuple] = None
        # ----------------------------------------------- host accounting
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lens: Dict[object, int] = {}
        # refcount[b] = number of tables containing b; present exactly
        # while b is off the free list (0 only for trie-cached blocks)
        self._refcount: Dict[int, int] = {}
        # blocks whose content is distrusted (shared at scrub time):
        # never re-indexed, scrubbed when their last reference drops
        self._tainted: set = set()
        self.prefix_index: Optional[PrefixCacheIndex] = \
            PrefixCacheIndex(block_size) if enable_prefix_cache else None
        self.host_tier: Optional[HostTierStore] = \
            HostTierStore(host_tier_blocks) \
            if (enable_prefix_cache and host_tier_blocks > 0) else None
        self.promote_timeout_s = promote_timeout_s
        self.tier_demotions = 0
        self.tier_promotions = {"hit": 0, "timeout": 0,
                                "integrity": 0, "raced": 0}
        self._promote_seconds: List[float] = []
        # fault hooks, armed per step by the owning engine; the promote
        # guard keeps an in-progress promotion path out of demotion
        self._tier_faults = None
        self._tier_step = 0
        self._promote_guard: set = set()
        self.blocks_allocated = 0
        self.blocks_freed = 0
        self.blocks_attached = 0
        self.alloc_failures = 0
        self.high_water = 0

    # ------------------------------------------------ pool storage view
    @property
    def pools(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """L-tuple of (k, v) [num_blocks, block_size, H, D] in the
        logical f32 layout. In f32 mode this is the storage itself
        (write into it in place); in int8 mode a dequantized COPY (write
        it back through the setter)."""
        if self._qpools is None:
            return self._pools
        return tuple(
            (kv_quant.dequantize_blocks(qk, sk),
             kv_quant.dequantize_blocks(qv, sv))
            for (qk, qv), (sk, sv) in zip(self._qpools, self._scales))

    @pools.setter
    def pools(self, new_pools) -> None:
        if self._qpools is None:
            self._pools = tuple((k, v) for k, v in new_pools)
            return
        every = torch.arange(self.num_blocks, device=self.device)
        for (k, v), (qk, qv), (sk, sv) in zip(new_pools, self._qpools,
                                              self._scales):
            kv_quant.requantize_blocks_(qk, sk, every, k)
            kv_quant.requantize_blocks_(qv, sv, every, v)

    def stored_pools(self) -> tuple:
        """What the cache keeps resident: the f32 pools, or the int8
        (codes, scales) pairs per layer."""
        if self._qpools is None:
            return self._pools
        return tuple(zip(self._qpools, self._scales))

    def _reset_block_scales(self, ids) -> None:
        """Zero freshly claimed blocks' scale rows (int8 mode): stale
        codes then dequantize to exact zeros (the fresh-block
        invariant) and the next write derives its scale from the new
        content alone."""
        at = self._index(ids)
        for sk, sv in self._scales:
            sk[at] = 0.0
            sv[at] = 0.0

    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.long,
                               device=self.device)

    def _put_f32(self, ids, per_layer) -> None:
        """Write f32 content [n, bs, H, D] per layer ((k, v) pairs) into
        blocks `ids`, in place (int8 mode: a monotone re-encode)."""
        at = self._index(ids)
        for li, (k, v) in enumerate(per_layer):
            if self._qpools is None:
                kp, vp = self._pools[li]
                kp[at] = k.to(kp.dtype)
                vp[at] = v.to(vp.dtype)
            else:
                (qk, qv), (sk, sv) = self._qpools[li], self._scales[li]
                kv_quant.requantize_blocks_(qk, sk, at, k.float())
                kv_quant.requantize_blocks_(qv, sv, at, v.float())

    def arm_tier_faults(self, faults, step: int) -> None:
        """Point the demote/promote fault hooks (kill_demotion /
        kill_promotion) at the engine's injector for this step."""
        self._tier_faults = faults
        self._tier_step = step

    # ------------------------------------------------------------ queries
    def num_free(self) -> int:
        return len(self._free)

    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def num_evictable(self) -> int:
        """Trie-cached blocks no table references (admission headroom:
        they reclaim on demand)."""
        if self.prefix_index is None:
            return 0
        return sum(1 for b in self.prefix_index.blocks()
                   if self._refcount.get(b, 0) == 0)

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
        if n > len(self._free) and self.prefix_index is not None:
            self._evict_cached(n - len(self._free))
        if n > len(self._free):
            self.alloc_failures += 1
            raise CacheExhausted(seq_id, n, len(self._free),
                                 self.num_blocks)
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refcount[b] = 1
        if self._qpools is not None and got:
            self._reset_block_scales(got)
        self.blocks_allocated += n
        self.high_water = max(self.high_water, self.num_used())
        return got

    def _give_back(self, b: int) -> None:
        """Return a claimed, unreferenced block to the free list."""
        del self._refcount[b]
        self._free.append(b)
        self.blocks_freed += 1

    def _evict_cached(self, n: int) -> int:
        """Reclaim up to n unreferenced cached blocks, LRU leaf first.
        Evicted blocks are not scrubbed: finite stale KV is erased
        exactly by the attention length mask. With a host tier eviction
        demotes instead: victims are selected first (pending nodes count
        as demoted for frontier eligibility, so the sequence matches the
        one-at-a-time loop), then spilled with one gather per pool
        tensor. A victim the demote path refuses (tainted, or an
        injected kill_demotion) flushes what is staged and is evicted
        plainly."""
        idx = self.prefix_index
        evicted = 0
        if self.host_tier is not None:
            pending: List[PrefixNode] = []
            pset: set = set()
            faults = self._tier_faults
            while evicted < n:
                node = idx.lru_demotable(
                    lambda b: self._refcount.get(b, 0) == 0,
                    skip=self._promote_guard, pending=pset)
                if node is None:
                    break
                evicted += 1
                if node.block in self._tainted or (
                        faults is not None
                        and faults.kill_demotion(self._tier_step)):
                    self._flush_demotions(pending)
                    pending, pset = [], set()
                    self._plain_evict(node)
                    continue
                pending.append(node)
                pset.add(node)
            self._flush_demotions(pending)
            return evicted
        while evicted < n:
            node = idx.pop_lru_leaf(lambda b: self._refcount.get(b, 0) == 0)
            if node is None:
                break
            self._give_back(node.block)
            idx.evictions += 1
            evicted += 1
        return evicted

    # ---------------------------------------------------- host tiering
    def _payload_digest(self, payload) -> str:
        """sha256 over a per-block payload (tuple of (k, v) numpy
        arrays), taken at spill time and re-checked on every fill."""
        h = hashlib.sha256()
        for k, v in payload:
            h.update(np.ascontiguousarray(k).tobytes())
            h.update(np.ascontiguousarray(v).tobytes())
        return h.hexdigest()

    def _dequant_payload(self, payload) -> tuple:
        """Decode a quantized spill payload (L int8 code pairs plus the
        trailing (k_scales [L, H], v_scales [L, H]) pair) to L f32
        pairs. int8 mode only; called after the digest verified."""
        ks, vs = payload[self.num_layers]
        return tuple(
            (payload[li][0].astype(np.float32) * ks[li][None, :, None],
             payload[li][1].astype(np.float32) * vs[li][None, :, None])
            for li in range(self.num_layers))

    def _flush_demotions(self, nodes: List[PrefixNode]) -> None:
        """Spill the staged victims' payloads to the host tier and free
        their device blocks. One gather per pool tensor for the batch;
        `nodes` is leaf-ward, so each `demote` sees its device children
        already host-resident."""
        if not nodes:
            return
        at = self._index([n.block for n in nodes])
        if self._qpools is not None:
            per_layer = [(qk[at].cpu().numpy(), qv[at].cpu().numpy())
                         for qk, qv in self._qpools]
            sc = [(sk[at].cpu().numpy(), sv[at].cpu().numpy())
                  for sk, sv in self._scales]
        else:
            per_layer = [(kp[at].cpu().numpy(), vp[at].cpu().numpy())
                         for kp, vp in self._pools]
            sc = None
        for i, node in enumerate(nodes):
            b = node.block
            payload = tuple((np.array(pk[i]), np.array(pv[i]))
                            for pk, pv in per_layer)
            if sc is not None:
                payload += ((np.stack([k[i] for k, _ in sc]),
                             np.stack([v[i] for _, v in sc])),)
            hid, dropped = self.host_tier.put(
                payload, self._payload_digest(payload))
            self.prefix_index.demote(node, hid)
            for dh in dropped:
                # store-side LRU eviction: unlink the orphaned subtree
                dn = self.prefix_index.node_of_host(dh)
                if dn is not None:
                    self._drop_host_subtree(dn)
            self._give_back(b)
            self.tier_demotions += 1

    def _plain_evict(self, node: PrefixNode) -> None:
        """Destroy a frontier node the demote path refused: its host
        children go with it and the device block returns to the free
        list, scrubbed if tainted."""
        for child in list(node.children.values()):
            self._drop_host_subtree(child)
        idx = self.prefix_index
        idx.remove(node)
        self._give_back(node.block)
        idx.evictions += 1
        if node.block in self._tainted:
            self._tainted.discard(node.block)
            self.scrub_blocks([node.block])

    def _drop_host_subtree(self, node: PrefixNode,
                           poison: bool = False) -> int:
        """Unlink a subtree rooted at a HOST node and drop its store
        entries (raced store eviction, failed integrity, distrust).
        Returns the number of host entries dropped."""
        dropped = 0
        for n in self.prefix_index.remove_subtree(node):
            if n.tier == "host":
                if self.host_tier is not None:
                    if poison:
                        self.host_tier.poison(n.host_id)
                    else:
                        self.host_tier.drop(n.host_id)
                dropped += 1
            elif self._refcount.get(n.block, 0) == 0:
                # device below host cannot exist (insert stops at host
                # nodes), but never strand a block
                self._give_back(n.block)
        return dropped

    def host_match_len(self, tokens) -> int:
        """How many ADDITIONAL leading tokens are host-resident behind
        the device match (promotable before prefill)."""
        if self.host_tier is None or len(tokens) < 2:
            return 0
        toks = [int(t) for t in tokens[:len(tokens) - 1]]
        _dev, host_path = self.prefix_index.match_tiered(toks)
        return len(host_path) * self.block_size

    def _sync(self) -> None:
        """Wait for the device (a wall-clock reading that covers device
        work must follow it)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ensure_promoted(self, tokens) -> Optional[dict]:
        """Fill the host-resident run extending `tokens`' device match
        back into fresh device blocks, root-ward, stopping at the first
        failure. Outcomes per node: "hit" (digest verified, scattered,
        retagged), "timeout" (injected kill_promotion, promote_timeout_s
        exceeded, or no device block free: the entry stays resident and
        retryable), "raced" (the store evicted the payload first) or
        "integrity" (sha256 mismatch); the last two drop the subtree.
        Returns None when tiering is off or nothing host-resident
        matches, else {"promoted_blocks", "promoted_tokens", "outcomes",
        "seconds"}. Never raises. `seconds` is read after the device
        finished the scatter."""
        if self.host_tier is None or len(tokens) < 2:
            return None
        toks = [int(t) for t in tokens[:len(tokens) - 1]]
        dev_path, host_path = self.prefix_index.match_tiered(toks)
        if not host_path:
            return None
        t0 = time.perf_counter()
        staged: List[Tuple[PrefixNode, int, tuple]] = []
        self._promote_guard = set(dev_path)
        try:
            tail: List[str] = []
            for node in host_path:
                out, b, payload = self._promote_stage(node, t0)
                if out != "hit":
                    tail.append(out)
                    break
                staged.append((node, b, payload))
                self._promote_guard.add(node)
            # a later stage's _take_blocks may have demoted into a full
            # store whose LRU eviction dropped an earlier staged entry:
            # that node and everything staged below it raced
            live: List[Tuple[PrefixNode, int, tuple]] = []
            raced = False
            for node, b, payload in staged:
                if not raced and self.prefix_index.node_of_host(
                        node.host_id) is node:
                    live.append((node, b, payload))
                else:
                    raced = True
                    self._give_back(b)
            if raced:
                tail = ["raced"]
            outcomes = ["hit"] * len(live) + tail
            if live:
                # one scatter per pool tensor for the whole chain
                self._put_f32(
                    [b for _n, b, _p in live],
                    [(torch.from_numpy(np.stack(
                        [p[li][0] for _n, _b, p in live])).to(self.device),
                      torch.from_numpy(np.stack(
                          [p[li][1] for _n, _b, p in live])).to(self.device))
                     for li in range(self.num_layers)])
                for node, b, _p in live:
                    hid = node.host_id       # promote() clears it
                    self._refcount[b] = 0    # trie-cached, unreferenced
                    self.prefix_index.promote(node, b)
                    self.host_tier.drop(hid)
        finally:
            self._promote_guard = set()
        for out in outcomes:
            self.tier_promotions[out] += 1
        self._sync()
        seconds = time.perf_counter() - t0
        if live:
            self._promote_seconds.append(seconds)
        return {"promoted_blocks": len(live),
                "promoted_tokens": len(live) * self.block_size,
                "outcomes": outcomes, "seconds": seconds}

    def _promote_stage(self, node: PrefixNode, t0: float
                       ) -> Tuple[str, Optional[int], Optional[tuple]]:
        """Verify and claim one host->device fill; the caller scatters
        every staged payload at once. Returns (outcome, block, payload);
        block and payload are None unless the outcome is "hit"."""
        faults = self._tier_faults
        if faults is not None and faults.kill_promotion(self._tier_step):
            return "timeout", None, None
        if self.promote_timeout_s is not None \
                and time.perf_counter() - t0 > self.promote_timeout_s:
            return "timeout", None, None
        entry = self.host_tier.get(node.host_id)
        if entry is None:
            self._drop_host_subtree(node)
            return "raced", None, None
        if self._payload_digest(entry["payload"]) != entry["digest"]:
            self._drop_host_subtree(node)
            return "integrity", None, None
        try:
            b = self._take_blocks("_promote", 1)[0]
        except CacheExhausted:
            self.alloc_failures -= 1     # not an admission failure
            return "timeout", None, None
        if self.prefix_index.node_of_host(node.host_id) is not node:
            # _take_blocks demoted into the store, whose LRU eviction
            # dropped this very entry
            self._give_back(b)
            return "raced", None, None
        payload = entry["payload"]
        if self._qpools is not None:
            payload = self._dequant_payload(payload)
        return "hit", b, payload

    def drain_promote_seconds(self) -> List[float]:
        """Hand accumulated promote-latency samples to the engine
        (cleared on read)."""
        out, self._promote_seconds = self._promote_seconds, []
        return out

    def allocate(self, seq_id, num_tokens: int) -> List[int]:
        """Claim blocks for a new sequence of num_tokens cached tokens
        (dense prefill). Raises CacheExhausted without side effects."""
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

    def write_blocks(self, seq_id, pos: int) -> List[int]:
        """The blocks holding seq_id's positions [pos, seq_len): where a
        write at pos and after lands. Raises RuntimeError unless each is
        PRIVATE (refcount 1 and not indexed by the trie): the pools are
        written in place, so a write into a shared block would change
        every sharer."""
        table = self._tables[seq_id]
        end = self._lens[seq_id]
        blocks = table[pos // self.block_size:self.blocks_needed(end)]
        idx = self.prefix_index
        for b in blocks:
            if self._refcount.get(b, 0) != 1 or (
                    idx is not None and idx.node_of(b) is not None):
                raise RuntimeError(
                    f"seq {seq_id!r} would write positions [{pos}, {end}) "
                    f"into block {b}, which is shared (refcount "
                    f"{self._refcount.get(b, 0)}, indexed "
                    f"{idx is not None and idx.node_of(b) is not None})")
        return blocks

    # -------------------------------------------------- prefix caching
    def match_len(self, tokens) -> int:
        """Pricing probe (no LRU side effects): how many leading tokens
        the cache could serve at admission, capped at len(tokens) - 1
        (the last prompt token must run through the model)."""
        if self.prefix_index is None or len(tokens) < 2:
            return 0
        toks = [int(t) for t in tokens[:len(tokens) - 1]]
        path, partial = self.prefix_index.match(toks, touch=False)
        return len(path) * self.block_size + \
            (partial[1] if partial is not None else 0)

    def allocate_with_prefix(self, seq_id, tokens) -> int:
        """Admission with prefix reuse: start seq_id's table with the
        longest cached prefix of `tokens` (shared full blocks, refcount
        + 1), forking a private copy-on-write block at a mid-block
        divergence. Returns the number of prompt tokens served from
        cache (the sequence's initial length). With the prefix cache
        off this is `allocate(seq_id, 0)` returning 0."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id!r} already allocated")
        idx = self.prefix_index
        if idx is None:
            self._tables[seq_id] = []
            self._lens[seq_id] = 0
            return 0
        toks = [int(t) for t in tokens]
        path, partial = idx.match(toks[:len(toks) - 1], touch=True)
        table = [node.block for node in path]
        for b in table:
            self._refcount[b] += 1
        self.blocks_attached += len(table)
        cached = len(table) * self.block_size
        if partial is not None:
            donor, m = partial
            try:
                fork = self._take_blocks(seq_id, 1)[0]
            except CacheExhausted:
                # the fork is an optimisation: recompute the partial
                # block instead; the attached blocks stay attached
                self.alloc_failures -= 1
            else:
                self._copy_block(donor.block, fork)
                table.append(fork)
                cached += m
                idx.cow_forks += 1
        self._tables[seq_id] = table
        self._lens[seq_id] = cached
        if cached > 0:
            idx.hits += 1
        else:
            idx.misses += 1
        idx.cached_tokens_total += cached
        idx.prompt_tokens_total += len(toks)
        return cached

    def note_prefix_miss(self, num_tokens: int) -> None:
        """Hit-rate accounting for dense admissions (taken exactly when
        nothing matched)."""
        if self.prefix_index is not None:
            self.prefix_index.misses += 1
            self.prefix_index.prompt_tokens_total += num_tokens

    def register_prefix(self, seq_id, tokens) -> int:
        """Index seq_id's full blocks under `tokens`, the tokens whose KV
        the sequence has WRITTEN. First-wins dedupe; tainted blocks are
        never indexed. Idempotent. Returns the newly indexed count."""
        idx = self.prefix_index
        if idx is None:
            return 0
        table = self._tables[seq_id]
        toks = [int(t) for t in tokens]
        full = min(len(toks) // self.block_size, len(table))
        if full <= 0:
            return 0
        return idx.insert(toks, table[:full],
                          skip=lambda b: b in self._tainted)

    def clear_prefix_cache(self) -> int:
        """Drop the whole trie (and the host store), returning
        unreferenced cached blocks to the free list (tainted ones
        scrubbed). Returns the number of blocks released."""
        idx = self.prefix_index
        if idx is None:
            return 0
        if self.host_tier is not None:
            self.host_tier.clear()
        released: List[int] = []
        for b in idx.clear():
            if self._refcount.get(b, 0) == 0:
                del self._refcount[b]
                self._free.append(b)
                released.append(b)
        self.blocks_freed += len(released)
        dirty = [b for b in released if b in self._tainted]
        if dirty:
            self._tainted.difference_update(dirty)
            self.scrub_blocks(dirty)
        return len(released)

    @torch.no_grad()
    def _copy_block(self, src: int, dst: int) -> None:
        """Device-side block duplication for copy-on-write forks (dst is
        freshly claimed and private)."""
        if self._qpools is None:
            for kp, vp in self._pools:
                kp[dst] = kp[src]
                vp[dst] = vp[src]
            return
        at = self._index([src])
        self._put_f32([dst], [
            (kv_quant.dequantize_blocks(qk[at], sk[at]),
             kv_quant.dequantize_blocks(qv[at], sv[at]))
            for (qk, qv), (sk, sv) in zip(self._qpools, self._scales)])

    # ------------------------------------------- migration (later slice)
    def export_blocks(self, seq_id):
        _later_slice("export_blocks")

    def import_blocks(self, seq_id, payload, num_tokens: int):
        _later_slice("import_blocks")

    def payload_bytes(self, payload):
        _later_slice("payload_bytes")

    def export_prefix(self, tokens):
        _later_slice("export_prefix")

    def admit_prefix(self, tokens, blocks):
        _later_slice("admit_prefix")

    # ---------------------------------------------------------- freeing
    def _distrust(self, b: int, to_scrub: List[int]) -> None:
        """Scrub-path hygiene for block b's trie entry: remove its whole
        subtree from the index. Subtree blocks nobody references are
        released scrubbed; referenced ones are tainted; host-resident
        descendants are poisoned. b itself is left to the caller."""
        idx = self.prefix_index
        if idx is None:
            return
        node = idx.node_of(b)
        if node is None:
            return
        for n in idx.remove_subtree(node):
            if n.tier == "host":
                if self.host_tier is not None:
                    self.host_tier.poison(n.host_id)
                continue
            blk = n.block
            if blk == b:
                continue
            if self._refcount.get(blk, 0) == 0:
                self._give_back(blk)
                self._tainted.discard(blk)
                to_scrub.append(blk)
            else:
                self._tainted.add(blk)

    def free(self, seq_id, scrub: bool = False, cache_tokens=None) -> int:
        """Drop seq_id's table (completion, preemption, cancellation),
        decrementing refcounts; blocks return to the pool at refcount 0
        unless the trie indexes them (retained, evictable).
        `cache_tokens`, the sequence's tokens with written KV, indexes
        its full blocks first. `scrub=True` (quarantine/recovery) zeroes
        every block this call releases (NaN survives the attention mask:
        0 * NaN = NaN); a block others still hold is never zeroed under
        them, but trie-evicted, tainted and scrubbed at its last free."""
        idx = self.prefix_index
        if idx is not None and cache_tokens is not None and not scrub \
                and len(cache_tokens):
            self.register_prefix(seq_id, cache_tokens)
        ids = self._tables.pop(seq_id)
        self._lens.pop(seq_id)
        to_scrub: List[int] = []
        for b in reversed(ids):
            self._refcount[b] -= 1
            if scrub:
                self._distrust(b, to_scrub)
            if self._refcount[b] > 0:
                if scrub:
                    self._tainted.add(b)
                continue
            if not scrub and idx is not None \
                    and idx.node_of(b) is not None:
                continue                     # retained: cached, evictable
            self._give_back(b)
            if scrub or b in self._tainted:
                self._tainted.discard(b)
                to_scrub.append(b)
        if to_scrub:
            self.scrub_blocks(to_scrub)
        return len(ids)

    @torch.no_grad()
    def scrub_blocks(self, block_ids) -> None:
        """Zero the given blocks in every layer's pools, in place (int8
        mode: codes and scales)."""
        if not block_ids:
            return
        at = self._index(block_ids)
        stores = self._pools if self._qpools is None \
            else self._qpools + self._scales
        for kp, vp in stores:
            kp[at] = 0
            vp[at] = 0

    @torch.no_grad()
    def corrupt_block(self, block: int) -> None:
        """Write NaN into `block` of layer 0's K pool (the cache_corrupt
        fault; int8 mode: that block's layer-0 K scales, so it decodes
        to NaN)."""
        if self._qpools is None:
            self._pools[0][0][block] = float("nan")
        else:
            self._scales[0][0][block] = float("nan")

    def check_integrity(self) -> dict:
        """Invariant audit: the free list and the LIVE blocks (table-
        owned plus trie-cached) partition the pool, refcounts equal
        table multiplicity, unreferenced live blocks are trie-cached,
        taints point at owned blocks, the trie is sound, every host node
        points at a store entry and back, per-tenant counters reconcile,
        and the lifetime counters account for every block off the free
        list. Returns the audit dict; raises RuntimeError on any
        violation."""
        in_tables = [b for ids in self._tables.values() for b in ids]
        owned = set(in_tables)
        free = set(self._free)
        idx = self.prefix_index
        cached = set(idx.blocks()) if idx is not None else set()
        live = owned | cached
        mult = Counter(in_tables)
        report = {
            "leaked": self.num_blocks - len(live | free),
            "double_owned": sum(
                1 for b in set(self._refcount) | owned
                if self._refcount.get(b, 0) != mult.get(b, 0)),
            "free_and_owned": len(live & free),
            "counter_drift": (self.blocks_allocated - self.blocks_freed)
            - (self.num_blocks - len(self._free)),
            "unreachable_zero_ref": sum(
                1 for b, rc in self._refcount.items()
                if rc == 0 and b not in cached),
            "stale_tainted": len(self._tainted - owned),
            "trie_defects": idx.audit() if idx is not None else 0,
        }
        if self.host_tier is not None and idx is not None:
            trie_hids = set(idx.host_ids())
            store_hids = set(self.host_tier.ids())
            report["host_orphans"] = len(trie_hids - store_hids)
            report["host_leaked"] = len(store_hids - trie_hids)
        else:
            report["host_orphans"] = 0
            report["host_leaked"] = 0
        if idx is not None:
            census = idx.tenant_census()
            names = set(idx.tenant_inserted) | set(idx.tenant_removed) \
                | set(census)
            report["tenant_drift"] = sum(
                abs(idx.tenant_inserted.get(t, 0)
                    - idx.tenant_removed.get(t, 0) - census.get(t, 0))
                for t in names)
        else:
            report["tenant_drift"] = 0
        if any(report.values()):
            raise RuntimeError(f"paged cache integrity violated: {report} "
                               f"(tables={len(self._tables)}, "
                               f"cached={len(cached)}, "
                               f"free={len(free)}/{self.num_blocks})")
        return report

    # ------------------------------------------------------- device side
    @torch.no_grad()
    def write_prefill(self, seq_id, dense_cache, num_tokens: int,
                      batch_index: int = 0) -> None:
        """Scatter one sequence's dense prefill cache (the L-list of
        (k [B, H, S, D], v) from models.generation.prefill) into its
        allocated blocks, in place. Positions past num_tokens inside the
        last block are copied as the prefill left them (zero). The table
        must be private (dense admission never attaches shared
        blocks)."""
        ids = self._tables[seq_id]
        n_blocks, bs = len(ids), self.block_size
        if n_blocks == 0:
            return
        self.write_blocks(seq_id, 0)

        def blocks(dense):
            # [H, S, D] -> [S, H, D] -> [n_blocks, bs, H, D]
            blk = dense[batch_index].transpose(0, 1)[:n_blocks * bs]
            return blk.reshape(n_blocks, bs, self.num_heads, self.head_dim)

        self._put_f32(ids, [(blocks(kc), blocks(vc))
                            for kc, vc in dense_cache])

    @torch.no_grad()
    def stage_chunk(self, tables: List[List[int]]):
        """The pools one fused decode chunk reads and writes, for rows
        whose block tables are `tables`: (pools, remap). f32 mode: the
        pools themselves and remap None (tables name blocks directly).
        int8 mode: f32 staging pools holding the dequantized blocks the
        rows name, and remap, an int32 [num_blocks] array from block id
        to staging index for the chunk's tables. Only these blocks can
        be read or written by the chunk (its K/V writes land in the
        rows' own tables), so the copy is the chunk's working set, not
        a second pool."""
        if self._qpools is None:
            return self._pools, None
        ids = sorted({b for t in tables for b in t}) or [0]
        n = len(ids)
        if self._stage is None or self._stage[0][0].shape[0] < n:
            cap = min(-(-n // 32) * 32, self.num_blocks)
            shape = (cap, self.block_size, self.num_heads, self.head_dim)
            self._stage = None           # release before reallocating
            self._stage = tuple(
                (torch.empty(shape, dtype=torch.float32, device=self.device),
                 torch.empty(shape, dtype=torch.float32, device=self.device))
                for _ in range(self.num_layers))
        at = self._index(ids)
        pools = []
        for (bk, bv), (qk, qv), (sk, sv) in zip(self._stage, self._qpools,
                                                self._scales):
            for buf, q, s in ((bk, qk, sk), (bv, qv, sv)):
                view = buf[:n]
                view.copy_(q[at])
                view.mul_(s[at][:, None, :, None])
            pools.append((bk[:n], bv[:n]))
        remap = np.zeros(self.num_blocks, np.int32)
        remap[ids] = np.arange(n, dtype=np.int32)
        return tuple(pools), remap

    @torch.no_grad()
    def commit_chunk(self, pools, remap, written: List[int]) -> None:
        """After a chunk on `stage_chunk`'s pools: re-encode the blocks
        it wrote (`written`, block ids) into the int8 store with monotone
        scales. The blocks it only read keep their codes, which is what
        re-encoding them would give. f32 mode: nothing to do."""
        if self._qpools is None or not written:
            return
        ids = sorted(set(written))
        at = self._index(ids)
        local = torch.as_tensor(remap[ids], dtype=torch.long,
                                device=self.device)
        for (k, v), (qk, qv), (sk, sv) in zip(pools, self._qpools,
                                              self._scales):
            kv_quant.requantize_blocks_(qk, sk, at, k[local])
            kv_quant.requantize_blocks_(qv, sv, at, v[local])

    def prefix_stats(self) -> dict:
        """Prefix-cache telemetry snapshot."""
        idx = self.prefix_index
        if idx is None:
            return {"enabled": False, "cached_blocks": 0,
                    "shared_blocks": 0, "evictable_blocks": 0,
                    "hits": 0, "misses": 0, "evictions": 0,
                    "cow_forks": 0, "inserted_blocks": 0,
                    "cached_tokens_total": 0, "prompt_tokens_total": 0,
                    "cached_tokens_ratio": 0.0, "attached_blocks": 0,
                    "host_blocks": 0, "tier_demotions": 0,
                    "promote_hit": 0, "promote_timeout": 0,
                    "promote_integrity": 0, "promote_raced": 0,
                    "tenant_blocks": {}}
        out = {"enabled": True}
        out.update(idx.stats())
        out["tenant_blocks"] = idx.tenant_census()
        out["shared_blocks"] = sum(
            1 for rc in self._refcount.values() if rc >= 2)
        out["evictable_blocks"] = self.num_evictable()
        out["attached_blocks"] = self.blocks_attached
        out["tier_demotions"] = self.tier_demotions
        for k, v in self.tier_promotions.items():
            out[f"promote_{k}"] = v
        return out

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
            "blocks_attached": self.blocks_attached,
            "alloc_failures": self.alloc_failures,
            "high_water": self.high_water,
        }
