"""Host-RAM tier for demoted prefix-cache blocks.

Port of paddle_tpu/inference/serving/host_tier.py (pure host Python;
numpy payloads in both packages). `HostTierStore` is the spill target
behind `PrefixCacheIndex`: when the device pool runs dry,
`PagedKVCache._evict_cached` demotes the LRU trie leaf's KV payload
here (per-layer numpy copies of the block plus a sha256 digest taken at
spill time) and retags the node host-resident. A later match promotes
the payload back into a fresh device block after re-verifying the
digest; a mismatch (torn host RAM, an injected `corrupt_host_block`)
drops the entry and the request re-prefills.

The store knows nothing of tries, pools or requests: a bounded LRU dict
of opaque payloads keyed by monotonically minted host ids. Its lock is
a leaf: nothing is called out of the store while it is held.

Left out: the lock-order annotation (`analysis.holds_lock`), which the
port's analyzers do not read yet.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["HostTierStore"]


class HostTierStore:
    """Bounded host-RAM block store with LRU eviction.

    One entry per demoted block: ``{"payload": L-tuple of (k, v) numpy
    arrays [block_size, H, D], "digest": sha256 hex taken at spill
    time, "touch": LRU clock}``. Capacity is counted in blocks; `put`
    evicts the oldest entries to fit and returns their ids so the
    owning cache can unlink the orphaned trie nodes."""

    _GUARDED_BY = {
        "_entries": "_lock", "_clock": "_lock", "_next_id": "_lock",
        "puts": "_lock", "drops": "_lock",
        "capacity_evictions": "_lock", "poisoned": "_lock",
    }

    def __init__(self, capacity_blocks: int):
        if capacity_blocks <= 0:
            raise ValueError("host tier capacity must be positive, got "
                             f"{capacity_blocks}")
        self.capacity = int(capacity_blocks)
        self._lock = threading.RLock()
        self._entries: Dict[int, dict] = {}
        self._next_id = 0
        self._clock = 0
        self.puts = 0
        self.drops = 0
        self.capacity_evictions = 0
        self.poisoned = 0

    # ------------------------------------------------------------- core
    def put(self, payload, digest: str) -> Tuple[int, List[int]]:
        """Admit one block payload; returns ``(host_id, evicted_ids)``.
        ``evicted_ids`` are entries LRU-dropped to respect capacity —
        the caller must unlink their trie nodes."""
        with self._lock:
            evicted: List[int] = []
            while len(self._entries) >= self.capacity:
                victim = min(self._entries,
                             key=lambda h: self._entries[h]["touch"])
                del self._entries[victim]
                self.capacity_evictions += 1
                self.drops += 1
                evicted.append(victim)
            hid = self._next_id
            self._next_id += 1
            self._clock += 1
            self._entries[hid] = {"payload": payload, "digest": digest,
                                  "touch": self._clock}
            self.puts += 1
            return hid, evicted

    def get(self, hid: int) -> Optional[dict]:
        """The entry for ``hid`` (LRU-touched), or None if it was
        dropped — the caller treats that as a raced eviction."""
        with self._lock:
            entry = self._entries.get(hid)
            if entry is not None:
                self._clock += 1
                entry["touch"] = self._clock
            return entry

    def drop(self, hid: int) -> bool:
        with self._lock:
            if hid not in self._entries:
                return False
            del self._entries[hid]
            self.drops += 1
            return True

    def poison(self, hid: int) -> bool:
        """Drop a host copy whose content is no longer trusted (a
        scrub-taint raised while the blocks were host-resident): the
        entry must never be promoted, so it is removed immediately and
        counted separately from ordinary drops."""
        with self._lock:
            if hid not in self._entries:
                return False
            del self._entries[hid]
            self.drops += 1
            self.poisoned += 1
            return True

    # ------------------------------------------------------ maintenance
    def corrupt_oldest(self) -> bool:
        """Test support (``corrupt_host_block`` fault): flip one value
        in the LRU-oldest entry's layer-0 K payload WITHOUT updating
        its digest — models torn host RAM / a bad DMA, caught by the
        sha256 check on the next fill."""
        with self._lock:
            if not self._entries:
                return False
            hid = min(self._entries,
                      key=lambda h: self._entries[h]["touch"])
            k0 = self._entries[hid]["payload"][0][0]
            k0.flat[0] = k0.flat[0] + 1.0
            return True

    def ids(self) -> List[int]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.drops += n
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _resident_bytes_locked(self) -> int:
        total = 0
        for entry in self._entries.values():
            for k, v in entry["payload"]:
                total += k.nbytes + v.nbytes
        return total

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity_blocks": self.capacity,
                "resident_blocks": len(self._entries),
                "resident_bytes": self._resident_bytes_locked(),
                "puts": self.puts,
                "drops": self.drops,
                "capacity_evictions": self.capacity_evictions,
                "poisoned": self.poisoned,
            }
