"""Radix-trie prefix index over paged KV blocks (prefix caching).

Port of paddle_tpu/inference/serving/prefix_cache.py. The index is
pure host Python in both packages, so the port keeps the reference's
code: one node per cached FULL block, keyed by the tuple of block_size
token ids the block holds, child edges extending the prefix by one
block. Matching a prompt walks the trie greedily; divergence inside a
block surfaces as a partial match (node, m) that the cache materialises
as a copy-on-write fork. PagedKVCache owns the physical side
(refcounts, free list, forks, eviction, the host tier).

Invariants (audited by PagedKVCache.check_integrity):
- a physical block appears at most once in the trie;
- a node at depth d (root = 0) holds token positions [(d-1)*bs, d*bs);
- every trie block is off the free list (refcount-0 cached blocks are
  retained and evictable, not free);
- last_touch clocks are monotone root-ward, so LRU leaf eviction never
  strands a recently used descendant;
- along any root-to-leaf path the tiers read device* host* (a "host"
  node's payload lives in the cache's HostTierStore, `block == -1`).

Left out: nothing of the index. Each node carries the tenant whose
sequence wrote it; the per-tenant censuses feed the audit's
reconciliation and the engine's per-tenant gauges, and `among=` restricts
eviction to the tenants over their prefix share.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["PrefixCacheIndex", "PrefixNode"]


class PrefixNode:
    """One cached block: `key` is the tuple of block_size token ids the
    block holds, `block` the physical block id, `last_touch` the
    index's logical clock at the last match through this node. `tier`
    is "device" (owns `block`) or "host" (`block == -1`; `host_id`
    names the spilled payload in the cache's HostTierStore)."""

    __slots__ = ("key", "block", "parent", "children", "last_touch",
                 "tier", "host_id", "tenant")

    def __init__(self, key: Optional[tuple], block: int,
                 parent: Optional["PrefixNode"], touch: int = 0,
                 tenant: str = "default"):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[tuple, "PrefixNode"] = {}
        self.last_touch = touch
        self.tier = "device"
        self.host_id: Optional[int] = None
        # tenant whose sequence WROTE this block (first-wins, like the
        # block content itself) — the unit of share-weighted eviction
        self.tenant = tenant

    def __repr__(self):                      # debugging aid only
        return (f"PrefixNode(block={self.block}, tier={self.tier}, "
                f"children={len(self.children)})")


class PrefixCacheIndex:
    """Token-id radix trie mapping full-block prefixes to block ids.

    Thread contract: owned by a PagedKVCache and mutated only under its
    owning engine's lock (the cache itself has no lock — same contract
    as the block tables).
    """

    def __init__(self, block_size: int):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.root = PrefixNode(None, -1, None)
        self._by_block: Dict[int, PrefixNode] = {}
        self._by_host: Dict[int, PrefixNode] = {}
        self._clock = 0
        # ----------------------------------------- lifetime counters
        self.hits = 0                 # admissions with cached_len > 0
        self.misses = 0               # admissions matching nothing
        self.evictions = 0            # blocks reclaimed under pressure
        self.cow_forks = 0            # mid-block divergence forks
        self.inserted_blocks = 0      # trie insertions (first-wins)
        self.cached_tokens_total = 0  # prompt tokens served from cache
        self.prompt_tokens_total = 0  # prompt tokens seen at admission
        # per-tenant lifetime node counters: every insertion and every
        # unlink is attributed, so for each tenant
        #   tenant_inserted - tenant_removed == live census
        # (both tiers; demote/promote retag without creating/removing).
        # check_integrity pins this reconciliation under churn.
        self.tenant_inserted: Dict[str, int] = {}
        self.tenant_removed: Dict[str, int] = {}

    # -------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._by_block)

    def blocks(self):
        """View of every cached physical block id."""
        return self._by_block.keys()

    def node_of(self, block: int) -> Optional[PrefixNode]:
        return self._by_block.get(block)

    def node_of_host(self, host_id: int) -> Optional[PrefixNode]:
        return self._by_host.get(host_id)

    def host_ids(self):
        """View of every host-resident node's store id."""
        return self._by_host.keys()

    # ------------------------------------------------------- matching
    def match(self, tokens: List[int], touch: bool = True
              ) -> Tuple[List[PrefixNode],
                         Optional[Tuple[PrefixNode, int]]]:
        """Longest cached prefix of `tokens`: the list of full-block
        nodes matched in order, plus an optional partial match
        (child_node, m) when 1 <= m < block_size leading tokens of the
        NEXT block agree with a cached child — the copy-on-write
        candidate. `touch=False` is the scheduler's pricing probe (no
        LRU side effects); the real attach touches the matched path so
        eviction age reflects use.

        Device-resident only: the walk stops at a host-tier child and
        the partial scan skips host children (a COW donor must own a
        physical block). `match_tiered` sees the host run."""
        bs = self.block_size
        if touch:
            self._clock += 1
        node, path = self.root, []
        i = 0
        while i + bs <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None or child.tier != "device":
                break
            if touch:
                child.last_touch = self._clock
            path.append(child)
            node = child
            i += bs
        # mid-block divergence: the best partially-agreeing child
        rest = tokens[i:]
        best: Optional[Tuple[PrefixNode, int]] = None
        if rest:
            for key, child in node.children.items():
                if child.tier != "device":
                    continue
                m = 0
                for a, b in zip(rest, key):
                    if a != b:
                        break
                    m += 1
                if m >= 1 and (best is None or m > best[1]):
                    best = (child, m)
            if best is not None and touch:
                best[0].last_touch = self._clock
        return path, best

    def match_tiered(self, tokens: List[int]
                     ) -> Tuple[List[PrefixNode], List[PrefixNode]]:
        """Tier-aware probe, no LRU side effects: the device-resident
        full-block path plus the contiguous HOST-resident run extending
        it (the promotable suffix — tiers along a path are always
        device* host*). The scheduler prices a prompt from both halves;
        `PagedKVCache.ensure_promoted` fills the host run back in."""
        bs = self.block_size
        node, dev = self.root, []
        i = 0
        while i + bs <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None or child.tier != "device":
                break
            dev.append(child)
            node = child
            i += bs
        host: List[PrefixNode] = []
        while i + bs <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None or child.tier != "host":
                break
            host.append(child)
            node = child
            i += bs
        return dev, host

    # ------------------------------------------------------ insertion
    def insert(self, tokens: List[int], blocks: List[int],
               skip: Optional[Callable[[int], bool]] = None,
               tenant: str = "default") -> int:
        """Register `blocks` (block i holding tokens[i*bs:(i+1)*bs]) as
        cached prefixes. First-wins dedupe: where a node already exists
        the existing physical block is kept and `blocks[i]` stays a
        private duplicate (freed normally with its table). `skip(b)`
        vetoes individual blocks (tainted content must never be
        re-matched); a vetoed or already-indexed block STOPS the walk —
        a deeper insertion would orphan its children. Returns the
        number of newly indexed blocks.

        A HOST-tier child also stops the walk: indexing a device block
        beneath it would break the device*-host* path invariant, and
        the host copy already holds this content — the next match
        promotes it instead."""
        bs = self.block_size
        self._clock += 1
        node, added = self.root, 0
        for i, b in enumerate(blocks):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is not None:
                if child.tier != "device":
                    break
                child.last_touch = self._clock
                node = child
                continue
            if (skip is not None and skip(b)) or b in self._by_block:
                break
            child = PrefixNode(key, b, node, self._clock, tenant=tenant)
            node.children[key] = child
            self._by_block[b] = child
            added += 1
            node = child
        self.inserted_blocks += added
        if added:
            self.tenant_inserted[tenant] = \
                self.tenant_inserted.get(tenant, 0) + added
        return added

    # ------------------------------------------------ tier transitions
    def demote(self, node: PrefixNode, host_id: int) -> None:
        """Retag a device node host-resident: its payload now lives in
        the host store under `host_id` and the physical block is the
        caller's to free. Only frontier nodes (no device children) may
        demote — the path stays device* host*."""
        if node.tier != "device":
            raise ValueError(f"node for host id {node.host_id} is "
                             "already host-resident")
        if any(c.tier == "device" for c in node.children.values()):
            raise ValueError(f"cannot demote block {node.block}: it "
                             "still has device-resident children")
        del self._by_block[node.block]
        node.block = -1
        node.tier = "host"
        node.host_id = host_id
        self._by_host[host_id] = node

    def promote(self, node: PrefixNode, block: int) -> None:
        """Retag a host node device-resident in `block` (the caller
        filled it from the store payload). Fresh last_touch: a just-
        promoted prefix must not be the next demotion victim."""
        if node.tier != "host":
            raise ValueError(f"node for block {node.block} is already "
                             "device-resident")
        if node.parent is not None and node.parent.key is not None \
                and node.parent.tier != "device":
            raise ValueError("cannot promote below a host-resident "
                             "parent (promotion works root-ward)")
        del self._by_host[node.host_id]
        node.host_id = None
        node.tier = "device"
        node.block = block
        node.last_touch = self._clock
        self._by_block[block] = node

    # ------------------------------------------------------- eviction
    def _note_removed(self, node: PrefixNode) -> None:
        """Attribute one unlinked node to its tenant's removal counter
        (every removal path funnels through here so the per-tenant
        inserted/removed/census reconciliation stays exact)."""
        self.tenant_removed[node.tenant] = \
            self.tenant_removed.get(node.tenant, 0) + 1

    def remove(self, node: PrefixNode) -> None:
        """Unlink one LEAF node (raises on internal nodes — removing
        them would orphan the subtree; use remove_subtree)."""
        if node.children:
            raise ValueError(
                f"cannot remove internal prefix node for block "
                f"{node.block} ({len(node.children)} children)")
        del node.parent.children[node.key]
        if node.tier == "device":
            del self._by_block[node.block]
        else:
            del self._by_host[node.host_id]
        node.parent = None
        self._note_removed(node)

    def remove_subtree(self, node: PrefixNode) -> List[PrefixNode]:
        """Unlink `node` and its whole subtree (distrust on scrub,
        host-entry loss: the content must not be re-matched, and a
        removed parent would orphan its children anyway). Returns the
        removed nodes, `node` first — the cache reconciles each by
        tier (free/taint the device block, drop the host entry)."""
        del node.parent.children[node.key]
        node.parent = None
        removed: List[PrefixNode] = []
        stack = [node]
        while stack:
            n = stack.pop()
            removed.append(n)
            if n.tier == "device":
                del self._by_block[n.block]
            else:
                del self._by_host[n.host_id]
            self._note_removed(n)
            stack.extend(n.children.values())
            n.children.clear()
        return removed

    def pop_lru_leaf(self, evictable: Callable[[int], bool],
                     among: Optional[set] = None) -> Optional[PrefixNode]:
        """Remove and return the least-recently-touched leaf whose
        block satisfies `evictable` (the cache passes refcount == 0),
        or None. Clocks are monotone root-ward, so evicting the oldest
        leaf frees the coldest extremity of the trie first. `among`
        restricts candidates to the given TENANTS (share-weighted
        eviction: the cache first charges tenants over their share,
        then falls back to the global LRU sweep with among=None)."""
        best: Optional[PrefixNode] = None
        for node in self._by_block.values():
            if node.children or not evictable(node.block):
                continue
            if among is not None and node.tenant not in among:
                continue
            if best is None or node.last_touch < best.last_touch:
                best = node
        if best is not None:
            self.remove(best)
        return best

    def lru_demotable(self, evictable: Callable[[int], bool],
                      skip=frozenset(), pending=frozenset(),
                      among: Optional[set] = None
                      ) -> Optional[PrefixNode]:
        """The least-recently-touched node on the DEMOTION FRONTIER —
        a device node with no device-resident children whose block
        satisfies `evictable` — or None. Unlike pop_lru_leaf the node
        is NOT unlinked: the caller spills its payload and calls
        `demote`. `skip` excludes nodes on a promotion path in
        progress (demoting a node's parent mid-promotion would break
        the device*-host* invariant). `pending` holds nodes the caller
        has SELECTED but not yet spilled (batched demotion): they are
        not re-selected, and they count as demoted for their parent's
        frontier eligibility — the selection sequence matches the
        one-at-a-time loop exactly. `among` restricts candidates to the
        given tenants (share-weighted eviction, as pop_lru_leaf)."""
        best: Optional[PrefixNode] = None
        for node in self._by_block.values():
            if node in skip or node in pending:
                continue
            if among is not None and node.tenant not in among:
                continue
            if any(c.tier == "device" and c not in pending
                   for c in node.children.values()):
                continue
            if not evictable(node.block):
                continue
            if best is None or node.last_touch < best.last_touch:
                best = node
        return best

    def clear(self) -> List[int]:
        """Drop the entire index; returns every DEVICE block id it held
        (the cache reconciles them back to the free list / tables and
        clears its host store separately)."""
        blocks = list(self._by_block)
        for node in self._by_block.values():
            self._note_removed(node)
        for node in self._by_host.values():
            self._note_removed(node)
        self._by_block.clear()
        self._by_host.clear()
        self.root.children.clear()
        return blocks

    def tenant_census(self) -> Dict[str, int]:
        """Live trie nodes per tenant, BOTH tiers (demotion keeps the
        node) — the reconciliation counterpart of tenant_inserted/
        tenant_removed and the per-tenant block gauge source."""
        out: Dict[str, int] = {}
        for node in self._by_block.values():
            out[node.tenant] = out.get(node.tenant, 0) + 1
        for node in self._by_host.values():
            out[node.tenant] = out.get(node.tenant, 0) + 1
        return out

    def tenant_device_blocks(self) -> Dict[str, int]:
        """Device-resident blocks per tenant (the share the weighted
        eviction arbitrates — host payloads hold no HBM)."""
        out: Dict[str, int] = {}
        for node in self._by_block.values():
            out[node.tenant] = out.get(node.tenant, 0) + 1
        return out

    # --------------------------------------------------------- audits
    def audit(self) -> int:
        """Structural self-check, returns the number of violations:
        key widths, parent/child links, by-block/by-host map coverage,
        block uniqueness (one trie slot per physical block) and tier
        layering (no device node beneath a host node)."""
        bad = 0
        seen: Dict[int, int] = {}
        seen_host: Dict[int, int] = {}
        stack = [self.root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                if child.key != key or len(key) != self.block_size:
                    bad += 1
                if child.parent is not node:
                    bad += 1
                if child.tier == "device":
                    if self._by_block.get(child.block) is not child:
                        bad += 1
                    if child.host_id is not None:
                        bad += 1
                    if node.key is not None and node.tier != "device":
                        bad += 1    # device below host: unreachable
                    seen[child.block] = seen.get(child.block, 0) + 1
                else:
                    if self._by_host.get(child.host_id) is not child:
                        bad += 1
                    if child.block != -1:
                        bad += 1
                    seen_host[child.host_id] = \
                        seen_host.get(child.host_id, 0) + 1
                stack.append(child)
        bad += sum(c - 1 for c in seen.values() if c > 1)
        bad += len(set(self._by_block) - set(seen))
        bad += sum(c - 1 for c in seen_host.values() if c > 1)
        bad += len(set(self._by_host) - set(seen_host))
        return bad

    def stats(self) -> dict:
        total = self.prompt_tokens_total
        return {
            "cached_blocks": len(self._by_block),
            "host_blocks": len(self._by_host),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "cow_forks": self.cow_forks,
            "inserted_blocks": self.inserted_blocks,
            "cached_tokens_total": self.cached_tokens_total,
            "prompt_tokens_total": total,
            "cached_tokens_ratio":
                self.cached_tokens_total / total if total else 0.0,
        }
