"""Live KV-block migration between serving replicas.

Port of paddle_tpu/inference/serving/migration.py. Moves one in-flight
request (its KV blocks, token log, FCFS ticket and deadline clock) from
one replica's paged pool to another's without re-prefilling and without
perturbing its token stream. One primitive serves three callers:

- HANDOFF: prefill-tier replicas push every request that finishes
  prefill onto the decode tier (`ReplicaSet` roles, router step loop);
- REBALANCE: `ReplicaSet.rebalance()` moves the coldest decode requests
  off a pool running past a high watermark;
- DRAIN: `ReplicaSet.drain(index, recompute=False)` evacuates a
  replica's live work before a restart or deploy.

Transfer: the source pool gathers the request's blocks into a payload
(`PagedKVCache.export_blocks`, a device-to-device copy per layer pool
tensor; the source is untouched), the destination claims fresh blocks,
scatters the payload in (`import_blocks`), installs the table and
registers the written prefix in its own trie. Shared blocks are copied,
never stolen: the source trie keeps its entries and `check_integrity`
passes on both ends at every step.

Bitwise invariance: the fused chunk's draws are a pure function of
(seed, tokens generated), which the snapshot carries, K3's split plan
depends on the engine config only, and the decode GEMMs run at the
fixed max_num_seqs width, so a migrated request continues exactly as it
would have at its source.

The protocol is transactional, ordered so every failure leaves both
ends clean:

1. EXPORT from the source (a pure copy; aborting costs nothing);
2. ADMIT at the destination (fresh blocks, adopted straight into the
   running set). ``CacheExhausted`` here aborts the migration with no
   side effects and no trace events: the request keeps decoding at the
   source;
3. the mid-migration fault window (`kill_migration`): a source that
   dies here rolls the destination back (`abort_migrated`) and raises
   ``ReplicaCrashed``; the router's failover re-prefills the victim
   from its token log, so a half-migrated request is never half-served;
4. COMMIT: record ``migrate_out``, release the source copy (state
   MIGRATED, terminal for that engine, no finish event), record
   ``migrate_in``.

Thread contract: the coordinator runs in the router's locked step frame
and serialises migrations under its own lock (order router ->
migration -> replica -> engine -> scheduler). It holds ONE replica's
lock at a time, never source and destination together, so two
migrations in opposite directions cannot deadlock.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ... import obs
from .paged_cache import CacheExhausted
from .replica import EngineReplica, ReplicaCrashed

__all__ = ["BlockMigration", "MIGRATION_REASONS"]

MIGRATION_REASONS = ("handoff", "rebalance", "drain")


class BlockMigration:
    """Migration coordinator for one ReplicaSet (module docstring).
    Owns the migration counters and the obs families; one instance per
    router, driven from the router's locked step frame."""

    _GUARDED_BY = {
        "migrations": "_lock",
        "aborted": "_lock",
        "rolled_back": "_lock",
        "revision_refused": "_lock",
        "bytes_moved": "_lock",
        "prefix_fetches": "_lock",
        "prefix_aborted": "_lock",
        "prefix_bytes": "_lock",
    }

    def __init__(self, router_label: str):
        self.label = router_label
        self._lock = threading.RLock()
        self.migrations = 0               # committed
        self.aborted = 0                  # destination pool full
        self.rolled_back = 0              # source died mid-migration
        self.revision_refused = 0         # cross-(model,revision) blocked
        self.bytes_moved = 0
        self.prefix_fetches = 0           # committed peer prefix pulls
        self.prefix_aborted = 0           # dst full / digest mismatch
        self.prefix_bytes = 0
        self._c_migrations = obs.counter(
            "serving_migrations_total",
            "committed KV-block migrations by reason "
            "(handoff|rebalance|drain)", labels=("router", "reason"))
        self._h_seconds = obs.histogram(
            "serving_migration_seconds",
            "export -> committed wall time per migration",
            labels=("router",), unit="seconds").labels(
                router=router_label)
        self._h_bytes = obs.histogram(
            "serving_migration_bytes",
            "KV payload size per migration (all layers, k and v)",
            labels=("router",), unit="bytes").labels(
                router=router_label)
        self._c_peer_fetch = obs.counter(
            "serving_peer_fetches_total",
            "peer prefix pulls by outcome (hit|aborted); an abort "
            "leaves the destination pool untouched and the request "
            "re-prefills", labels=("router", "outcome"))
        self._c_rev_refused = obs.counter(
            "serving_revision_refusals_total",
            "KV transfers refused because source and destination serve "
            "different (model, revision) keys — stale KV never crosses "
            "a weight rollout (serving/deploy.py)", labels=("router",))

    def migrate(self, src: EngineReplica, dst: EngineReplica,
                request_id: str, reason: str, router_step: int = 0,
                faults=None) -> Optional[dict]:
        """Move one request src → dst (module-docstring protocol).
        Returns the committed migration's stats dict, or None when the
        destination pool could not hold it (clean abort — the request
        keeps running at the source). Raises ReplicaCrashed when the
        `kill_migration` fault fires in the commit window; the caller
        (router) fails the SOURCE replica over, and the destination has
        already been rolled back here."""
        if reason not in MIGRATION_REASONS:
            raise ValueError(
                f"migration reason {reason!r} not in "
                f"{MIGRATION_REASONS}")
        if src is dst:
            raise ValueError(
                f"cannot migrate {request_id!r} onto its own replica "
                f"{src.index}")
        with self._lock:
            return self._migrate_locked(src, dst, request_id, reason,
                                        router_step, faults)

    def _migrate_locked(self, src: EngineReplica, dst: EngineReplica,
                        request_id: str, reason: str,
                        router_step: int, faults) -> Optional[dict]:
        t0 = time.perf_counter()
        if src.revision_key() != dst.revision_key():
            # cross-revision refusal (serving/deploy.py): KV written by
            # one revision's weights must never serve another's
            # requests. Clean abort before any copy — the request keeps
            # running at the source; the router routes the drain/
            # rebalance to a same-revision destination instead.
            self.revision_refused += 1
            self._c_rev_refused.labels(router=self.label).inc()
            return None
        snap = src.export_request(request_id)
        try:
            dst_engine = dst.admit_migrated(snap)
        except CacheExhausted:
            # abort with no side effects and no trace events: export
            # was a pure copy, the destination rejected atomically
            self.aborted += 1
            return None
        if faults is not None \
                and faults.kill_migration(router_step, src.index):
            # source died between destination-admit and source-release:
            # roll the destination back and let the router's failover
            # re-prefill the victim from its authoritative token log
            dst.abort_migrated(request_id)
            self.rolled_back += 1
            raise ReplicaCrashed(
                f"replica {src.index} killed mid-migration of "
                f"{request_id!r} at router step {router_step}")
        prefilled = not snap["pf_target"] \
            or snap["prefill_pos"] >= snap["pf_target"]
        trace_id = snap["trace_id"] or request_id
        obs.reqtrace.record(
            "migrate_out", trace_id, request_id,
            replica=src.index, to_replica=dst.index, reason=reason,
            blocks=snap["blocks"], bytes=snap["bytes"],
            resume_pos=snap["num_tokens"], arrival=snap["arrival"])
        src.release_migrated(request_id)
        obs.reqtrace.record(
            "migrate_in", trace_id, request_id,
            replica=dst.index, from_replica=src.index, reason=reason,
            engine=dst_engine, blocks=snap["blocks"],
            bytes=snap["bytes"], resume_pos=snap["num_tokens"],
            arrival=snap["arrival"], prefilled=prefilled)
        dt = time.perf_counter() - t0
        self.migrations += 1
        self.bytes_moved += snap["bytes"]
        self._c_migrations.labels(router=self.label,
                                  reason=reason).inc()
        self._h_seconds.observe(dt)
        self._h_bytes.observe(snap["bytes"])
        return {"request_id": request_id, "src": src.index,
                "dst": dst.index, "reason": reason,
                "blocks": snap["blocks"], "bytes": snap["bytes"],
                "resume_pos": snap["num_tokens"], "seconds": dt}

    # --------------------------------------------------- peer prefix pull
    def fetch_prefix(self, src: EngineReplica, dst: EngineReplica,
                     request_id: str, trace_id: str, prompt_ids,
                     router_step: int = 0) -> Optional[dict]:
        """Transactional peer prefix pull (docs/serving.md "Hierarchical
        KV-cache tiering"): a replica missing a prompt's prefix copies
        the cached blocks from a peer that holds them instead of
        re-prefilling. Same shape and same atomic-abort semantics as
        `migrate`: the source export is a pure copy (host-resident
        blocks are integrity-checked against their spill digests during
        export), and the destination's `admit_prefix` re-verifies EVERY
        per-block digest before claiming a single block — a pool-full
        `CacheExhausted` or a digest-mismatch `ValueError` aborts with
        the destination untouched and the request degrades to ordinary
        re-prefill. Blocks are copied, never stolen: the source trie
        keeps its entry. Returns the committed pull's stats dict, or
        None on abort / nothing-to-pull."""
        if src is dst:
            raise ValueError(
                f"cannot pull prefix for {request_id!r} from its own "
                f"replica {src.index}")
        with self._lock:
            return self._fetch_prefix_locked(src, dst, request_id,
                                             trace_id, prompt_ids,
                                             router_step)

    def _fetch_prefix_locked(self, src: EngineReplica,
                             dst: EngineReplica, request_id: str,
                             trace_id: str, prompt_ids,
                             router_step: int) -> Optional[dict]:
        t0 = time.perf_counter()
        if src.revision_key() != dst.revision_key():
            # same refusal as _migrate_locked: a peer serving different
            # weights holds no prefix worth pulling — its KV is garbage
            # under this revision's parameters
            self.revision_refused += 1
            self._c_rev_refused.labels(router=self.label).inc()
            return None
        snap = src.export_prefix(prompt_ids)
        if snap is None:
            return None                   # peer held nothing after all
        tid = trace_id or request_id
        try:
            added = dst.admit_prefix(prompt_ids, snap["blocks"],
                                     model=snap.get("model"),
                                     revision=snap.get("revision"))
        except (CacheExhausted, ValueError):
            # atomic abort: admit_prefix verifies all digests BEFORE
            # claiming blocks and CacheExhausted claims nothing — the
            # destination pool is untouched either way, and the request
            # re-prefills its missing suffix like any cache miss
            self.prefix_aborted += 1
            self._c_peer_fetch.labels(router=self.label,
                                      outcome="aborted").inc()
            obs.reqtrace.record(
                "peer_fetch", tid, request_id, outcome="aborted",
                from_replica=src.index, to_replica=dst.index,
                blocks=len(snap["blocks"]), bytes=snap["bytes"],
                step=router_step)
            return None
        dt = time.perf_counter() - t0
        self.prefix_fetches += 1
        self.prefix_bytes += snap["bytes"]
        self._c_peer_fetch.labels(router=self.label,
                                  outcome="hit").inc()
        obs.reqtrace.record(
            "peer_fetch", tid, request_id, outcome="hit",
            from_replica=src.index, to_replica=dst.index, blocks=added,
            tokens=len(snap["tokens"]), bytes=snap["bytes"],
            step=router_step, seconds=round(dt, 6))
        return {"request_id": request_id, "src": src.index,
                "dst": dst.index, "blocks": added,
                "tokens": len(snap["tokens"]), "bytes": snap["bytes"],
                "seconds": dt}

    def stats(self) -> dict:
        with self._lock:
            return {"migrations": self.migrations,
                    "aborted": self.aborted,
                    "rolled_back": self.rolled_back,
                    "revision_refused": self.revision_refused,
                    "bytes_moved": self.bytes_moved,
                    "prefix_fetches": self.prefix_fetches,
                    "prefix_aborted": self.prefix_aborted,
                    "prefix_bytes": self.prefix_bytes}

    def seconds_quantile(self, q: float) -> float:
        """Migration latency quantile (export -> committed wall time)
        from this router's serving_migration_seconds series; NaN when
        no migration has committed yet."""
        return self._h_seconds.quantile(q)
