"""Per-request causal tracing: a bounded, process-wide event ring.

Port of paddle_tpu/obs/reqtrace.py (stdlib only, the same event catalog,
payload schema and checker). Every layer that touches a request appends
host-side events keyed by a stable *trace id* minted at admission
(``LLMEngine.add_request`` mints ``tr-<engine-label>-N``); the id
survives preemption and requeue, so one request is one causal timeline:
admission -> prefix match -> scheduling (price/budget) -> prefill chunks
-> decode chunks -> preempt/requeue -> terminal.

- Zero device syncs: every event records host values the caller already
  holds.
- One ring, one lock, bounded memory (``deque(maxlen=capacity)``); a
  disabled flag makes ``record`` a no-op.

On top of the ring sits the flight recorder: when armed, quarantine and
``check_integrity`` failures dump the relevant traces plus a registry
snapshot to a postmortem JSON artifact. The pure helpers at the bottom
(TTFT decomposition, per-tenant TTFT, the causality checker) work on
plain event dicts, the dump schema.

The catalog keeps the fleet's kinds (failover, migration, deploy) so
dumps stay schema-compatible with the reference; the port's single
engine does not emit them yet (the router, migration and deploy are a
later slice).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "EVENT_KINDS", "DEPLOY_KINDS", "TERMINAL_REASONS", "TraceEvent",
    "ReqTraceRing",
    "RING", "record", "events", "traces", "clear", "enable", "disable",
    "is_enabled", "arm", "disarm", "flight_dump", "maybe_flight",
    "dump_payload", "bind_tenant", "group_traces", "ttft_components",
    "ttft_decomposition", "ttft_by_tenant", "trace_tenants",
    "check_causality",
]

# Catalog of event kinds; ``record`` rejects anything else so the dump
# schema stays closed and the postmortem tool can rely on it.
EVENT_KINDS = (
    "admitted",       # router admission: replica chosen, policy, score
    "engine_admit",   # engine add_request: arrival ticket, readmit, resume
    "prefix_match",   # prefix-cache hit: cached tokens, COW fork
    "scheduled",      # waiting -> running: mode, price charged, budget
    "prefill",        # dense prefill done (tokens fed)
    "prefill_chunk",  # chunked-prefill progress (fed, pos, target)
    "first_token",    # first emitted token (TTFT latch)
    "decode_chunk",   # fused-chunk boundary: tokens emitted, finish latch
    "preempt",        # preempted back to waiting (FCFS ticket preserved)
    "requeue",        # recovery requeue after a discarded chunk
    "quarantine",     # engine/replica quarantined (reason)
    "failover",       # replica died holding the request (old replica)
    "readmit",        # re-admitted on a survivor (new replica, resume len)
    "migrate_out",    # KV blocks left this replica (dst, blocks, bytes)
    "migrate_in",     # KV blocks landed here (src, resume position)
    "demote",         # prefix blocks spilled device -> host tier
    "promote",        # host-resident prefix filled back to device
    "promote_abort",  # promotion degraded (timeout|integrity|raced)
    "peer_fetch",     # prefix blocks pulled from a peer replica
    "rejected",       # admission refused: quota | deadline (terminal
                      # for the refused attempt; a router retry may
                      # still admit the trace elsewhere)
    "finish",         # terminal: stop|length|cancelled|timeout|shed|error
    # -- deploy control plane (serving/deploy.py): these live on their
    #    own per-deploy timeline (trace_id "deploy-<model>-N"), not on
    #    request traces, and are exempt from the request invariants
    "deploy_start",   # rollout began: model, from/to revision, replicas
    "replica_swap",   # one slot swapped to the new revision (post-probe)
    "canary",         # parity gate verdict on one slot: pass|fail
    "rollback",       # deploy rolled back: reason, slots restored
    "deploy_commit",  # rollout committed: new revision serving
)
_KIND_SET = frozenset(EVENT_KINDS)

# control-plane kinds: a trace made ONLY of these is a deploy timeline,
# checked by its own terminal rule (commit XOR rollback) instead of the
# per-request invariants
DEPLOY_KINDS = frozenset((
    "deploy_start", "replica_swap", "canary", "rollback",
    "deploy_commit"))

TERMINAL_REASONS = ("stop", "length", "cancelled", "timeout", "shed",
                    "error")

DEFAULT_CAPACITY = 65536


class TraceEvent:
    """One host-side event. ``ts`` is ``time.perf_counter()`` at record
    time; ``seq`` is a ring-wide monotone counter that gives a total
    order even when perf_counter ties."""

    __slots__ = ("seq", "ts", "trace_id", "request_id", "kind", "attrs")

    def __init__(self, seq: int, ts: float, trace_id: str,
                 request_id: Optional[str], kind: str,
                 attrs: Optional[Dict[str, Any]]):
        self.seq = seq
        self.ts = ts
        self.trace_id = trace_id
        self.request_id = request_id
        self.kind = kind
        self.attrs = attrs

    def as_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "ts": self.ts, "trace_id": self.trace_id,
                "request_id": self.request_id, "kind": self.kind,
                "attrs": dict(self.attrs) if self.attrs else {}}

    def __repr__(self):                      # debugging aid only
        return (f"TraceEvent({self.seq}, {self.kind}, {self.trace_id}, "
                f"{self.attrs})")


class ReqTraceRing:
    """Thread-safe bounded ring of :class:`TraceEvent` plus the armed
    flight recorder. All mutable state is guarded by one lock."""

    _GUARDED_BY = {
        "_events": "_lock",
        "_seq": "_lock",
        "_flight_dir": "_lock",
        "_flight_limit": "_lock",
        "_flight_count": "_lock",
        "_dumps": "_lock",
        "_tenants": "_lock",
    }

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.enabled = True          # plain flag: racy reads are benign
        self._lock = threading.RLock()
        self._events: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._flight_dir: Optional[str] = None
        self._flight_limit = 0
        self._flight_count = 0
        self._dumps: List[str] = []
        # trace_id -> tenant: bound once at admission so EVERY event on
        # the timeline auto-carries the tag without threading a tenant
        # kwarg through ~30 record sites. Insertion-ordered dict, capped
        # at 2x ring capacity (oldest bindings dropped with their
        # long-rotated-out events).
        self._tenants: Dict[str, str] = {}

    # ------------------------------------------------------------------
    # recording / reading
    # ------------------------------------------------------------------
    def record(self, kind: str, trace_id: str,
               request_id: Optional[str] = None, **attrs) -> None:
        if not self.enabled:
            return
        if kind not in _KIND_SET:
            raise ValueError(f"unknown reqtrace event kind: {kind!r}")
        ts = time.perf_counter()
        with self._lock:
            # auto-attach the bound tenant tag (explicit kwarg wins)
            if "tenant" not in attrs:
                t = self._tenants.get(str(trace_id))
                if t is not None:
                    attrs["tenant"] = t
            self._seq += 1
            self._events.append(TraceEvent(
                self._seq, ts, str(trace_id), request_id, kind,
                attrs or None))

    def bind_tenant(self, trace_id: str, tenant: str) -> None:
        """Bind a tenant to a trace id: every later event on the trace
        auto-carries ``tenant`` in its attrs (multi-tenant stacks bind
        at admission; single-tenant stacks never call this and their
        events stay untagged, byte-identical to the pre-tenancy dump
        schema)."""
        if tenant is None:
            return
        with self._lock:
            self._tenants[str(trace_id)] = str(tenant)
            cap = 2 * self.capacity
            while len(self._tenants) > cap:
                self._tenants.pop(next(iter(self._tenants)))

    def events(self, trace_id: Optional[str] = None,
               prefix: Optional[str] = None) -> List[TraceEvent]:
        """Snapshot of events in seq order, optionally filtered to one
        trace id or a trace-id prefix (e.g. one engine's traces)."""
        with self._lock:
            evts = list(self._events)
        if trace_id is not None:
            evts = [e for e in evts if e.trace_id == trace_id]
        if prefix is not None:
            evts = [e for e in evts if e.trace_id.startswith(prefix)]
        return evts

    def traces(self, prefix: Optional[str] = None
               ) -> Dict[str, List[TraceEvent]]:
        """trace_id → ordered events."""
        out: Dict[str, List[TraceEvent]] = {}
        for e in self.events(prefix=prefix):
            out.setdefault(e.trace_id, []).append(e)
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tenants.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # ------------------------------------------------------------------
    # flight recorder
    # ------------------------------------------------------------------
    def arm(self, directory: str, max_dumps: int = 4) -> None:
        """Arm automatic postmortem dumps (quarantine / failover /
        integrity failures call :meth:`maybe_flight`). ``max_dumps``
        bounds artifact noise on chaos runs where faults are expected."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._flight_dir = directory
            self._flight_limit = int(max_dumps)
            self._flight_count = 0

    def disarm(self) -> None:
        with self._lock:
            self._flight_dir = None

    def is_armed(self) -> bool:
        with self._lock:
            return self._flight_dir is not None

    def dumps(self) -> List[str]:
        """Paths of every flight artifact written so far."""
        with self._lock:
            return list(self._dumps)

    def dump_payload(self, reason: str,
                     trace_ids: Optional[Iterable[str]] = None,
                     complete: bool = True,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """Build the postmortem JSON payload: relevant traces plus a
        metric-registry snapshot. ``complete=False`` marks an in-flight
        dump (taken mid-run, e.g. at quarantine time) so the causality
        checker tolerates traces without a terminal event."""
        wanted = set(trace_ids) if trace_ids is not None else None
        evts = [e.as_dict() for e in self.events()
                if wanted is None or e.trace_id in wanted]
        try:  # lazy import: avoids a package-init ordering cycle
            from .export import snapshot as _registry_snapshot
            registry = _registry_snapshot()
        except Exception:  # the registry must not block a dump
            registry = {}
        payload = {
            "version": 1,
            "reason": reason,
            "wall_time": time.time(),
            "complete": bool(complete),
            "trace_ids": sorted({e["trace_id"] for e in evts}),
            "events": evts,
            "registry": registry,
        }
        if extra:
            payload["extra"] = extra
        return payload

    def flight_dump(self, reason: str,
                    trace_ids: Optional[Iterable[str]] = None,
                    path: Optional[str] = None,
                    complete: bool = True,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Optional[str]:
        """Write a postmortem artifact. With an explicit ``path`` the
        dump always happens; otherwise it requires an armed recorder
        (and respects its dump budget). Returns the path, or None."""
        if path is None:
            with self._lock:
                if self._flight_dir is None:
                    return None
                if self._flight_count >= self._flight_limit:
                    return None
                self._flight_count += 1
                n = self._flight_count
                safe = "".join(c if c.isalnum() else "-" for c in reason)
                path = os.path.join(self._flight_dir,
                                    f"flightrec-{n:02d}-{safe}.json")
        payload = self.dump_payload(reason, trace_ids=trace_ids,
                                    complete=complete, extra=extra)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True, default=str)
        os.replace(tmp, path)
        with self._lock:
            self._dumps.append(path)
        return path

    def maybe_flight(self, reason: str,
                     trace_ids: Optional[Iterable[str]] = None,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Optional[str]:
        """Auto-trigger hook used by the serving stack: dumps only when
        armed, never raises into the caller's failure path."""
        try:
            return self.flight_dump(reason, trace_ids=trace_ids,
                                    complete=False, extra=extra)
        except Exception:  # the recorder must not crash its caller
            return None


# Process-wide ring, mirroring REGISTRY / the trace span log.
RING = ReqTraceRing()


def record(kind: str, trace_id: str, request_id: Optional[str] = None,
           **attrs) -> None:
    RING.record(kind, trace_id, request_id=request_id, **attrs)


def bind_tenant(trace_id: str, tenant: str) -> None:
    RING.bind_tenant(trace_id, tenant)


def events(trace_id: Optional[str] = None,
           prefix: Optional[str] = None) -> List[TraceEvent]:
    return RING.events(trace_id=trace_id, prefix=prefix)


def traces(prefix: Optional[str] = None) -> Dict[str, List[TraceEvent]]:
    return RING.traces(prefix=prefix)


def clear() -> None:
    RING.clear()


def enable() -> None:
    RING.enabled = True


def disable() -> None:
    RING.enabled = False


def is_enabled() -> bool:
    return RING.enabled


def arm(directory: str, max_dumps: int = 4) -> None:
    RING.arm(directory, max_dumps=max_dumps)


def disarm() -> None:
    RING.disarm()


def flight_dump(reason: str, trace_ids: Optional[Iterable[str]] = None,
                path: Optional[str] = None, complete: bool = True,
                extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    return RING.flight_dump(reason, trace_ids=trace_ids, path=path,
                            complete=complete, extra=extra)


def maybe_flight(reason: str, trace_ids: Optional[Iterable[str]] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    return RING.maybe_flight(reason, trace_ids=trace_ids, extra=extra)


def dump_payload(reason: str, trace_ids: Optional[Iterable[str]] = None,
                 complete: bool = True) -> Dict[str, Any]:
    return RING.dump_payload(reason, trace_ids=trace_ids,
                             complete=complete)


# ----------------------------------------------------------------------
# Pure helpers over *plain event dicts* (the dump schema): the
# timeline / TTFT / causality logic, usable on the live ring's events
# (``[e.as_dict() for e in events()]``) and on a dump read back from
# disk alike.
# ----------------------------------------------------------------------
def group_traces(event_dicts: Iterable[Dict[str, Any]]
                 ) -> Dict[str, List[Dict[str, Any]]]:
    """trace_id → events sorted by seq."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for e in event_dicts:
        out.setdefault(e["trace_id"], []).append(e)
    for evts in out.values():
        evts.sort(key=lambda e: e["seq"])
    return out


def _prefill_done_ts(evts: List[Dict[str, Any]]) -> Optional[float]:
    for e in evts:
        if e["kind"] == "prefill":
            return e["ts"]
        if e["kind"] == "prefill_chunk":
            a = e.get("attrs") or {}
            if a.get("pos", 0) >= a.get("target", float("inf")):
                return e["ts"]
    return None


def ttft_components(evts: List[Dict[str, Any]]
                    ) -> Optional[Dict[str, float]]:
    """TTFT decomposition for one trace: queue (engine admit → first
    schedule), admission (router admit → engine admit), prefill
    (schedule → prefill complete), first-decode-gap (prefill complete →
    first token). Returns None for traces that never emitted."""
    t_router = t_admit = t_sched = t_first = None
    for e in evts:
        k = e["kind"]
        if k == "admitted" and t_router is None:
            t_router = e["ts"]
        elif k == "engine_admit" and t_admit is None:
            t_admit = e["ts"]
        elif k == "scheduled" and t_sched is None:
            t_sched = e["ts"]
        elif k == "first_token" and t_first is None:
            t_first = e["ts"]
    if t_admit is None or t_sched is None or t_first is None:
        return None
    t_pf = _prefill_done_ts(evts)
    if t_pf is None or t_pf > t_first:
        t_pf = t_first
    return {
        "admission_s": max(0.0, t_admit - t_router) if t_router else 0.0,
        "queue_s": max(0.0, t_sched - t_admit),
        "prefill_s": max(0.0, t_pf - t_sched),
        "first_gap_s": max(0.0, t_first - t_pf),
        "ttft_s": max(0.0, t_first - (t_router or t_admit)),
    }


def ttft_decomposition(event_dicts: Iterable[Dict[str, Any]]
                       ) -> Dict[str, float]:
    """Median per-component decomposition across every trace that
    emitted at least one token."""
    comps = [c for c in (ttft_components(evts)
                         for evts in group_traces(event_dicts).values())
             if c is not None]
    if not comps:
        return {}

    def med(key: str) -> float:
        vals = sorted(c[key] for c in comps)
        return vals[len(vals) // 2]

    return {"n": float(len(comps)),
            "admission_s": med("admission_s"), "queue_s": med("queue_s"),
            "prefill_s": med("prefill_s"),
            "first_gap_s": med("first_gap_s"), "ttft_s": med("ttft_s")}


def trace_tenants(event_dicts: Iterable[Dict[str, Any]]
                  ) -> Dict[str, Optional[str]]:
    """trace_id → tenant tag (first ``tenant`` attr seen on the trace;
    None for untagged single-tenant traces)."""
    out: Dict[str, Optional[str]] = {}
    for e in event_dicts:
        tid = e["trace_id"]
        if out.get(tid) is None:
            out.setdefault(tid, None)
            t = (e.get("attrs") or {}).get("tenant")
            if t is not None:
                out[tid] = t
    return out


def ttft_by_tenant(event_dicts: Iterable[Dict[str, Any]]
                   ) -> Dict[str, Dict[str, float]]:
    """Per-tenant median TTFT decomposition (the fairness debugger):
    traces are bucketed by their tenant tag (untagged → "default") and
    each bucket gets its own :func:`ttft_decomposition` aggregate."""
    events = list(event_dicts)
    tenant_of = trace_tenants(events)
    buckets: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        t = tenant_of.get(e["trace_id"]) or "default"
        buckets.setdefault(t, []).append(e)
    out: Dict[str, Dict[str, float]] = {}
    for t, evts in sorted(buckets.items()):
        decomp = ttft_decomposition(evts)
        if decomp:
            out[t] = decomp
    return out


def check_causality(dump: Dict[str, Any]) -> List[str]:
    """Machine-check the causal invariants over a dump. Returns a list
    of violation strings (empty == pass).

    1. no token emission before (re-)prefill completes;
    2. requeue preserves the FCFS arrival ticket, per-engine admission
       stays FCFS among simultaneously-waiting requests OF THE SAME
       TENANT (events carry tenant tags on multi-tenant stacks; WFQ
       may legally reorder across tenants, never within one — untagged
       single-tenant dumps collapse to the historical per-engine
       check), and failover re-admission batches stay arrival-ordered;
    3. exactly one terminal event per trace (at most one for in-flight
       dumps marked ``complete: false``);
    4. every failover hop references a real predecessor: a ``readmit``
       must follow a ``failover`` in its trace and name the replica it
       came from;
    5. every migration hop likewise: a ``migrate_in`` must follow a
       ``migrate_out`` in its trace and name the replica the blocks
       came from, and no decode emission may land between the two (the
       request has no engine while its KV is in flight);
    6. tiering: no token emission while a request's matched blocks are
       still host-resident — a ``prefix_match`` reporting
       ``host_tokens > 0`` must be resolved by a ``promote`` or
       ``promote_abort`` before any ``first_token``/``decode_chunk``
       (re-admission resets the latch: the new admission re-probes);
    7. every ``promote_abort`` is followed by re-prefill progress
       (``prefill``/``prefill_chunk``) or a terminal — a degraded
       promotion must never leave the request wedged;
    8. revision pinning (serving/deploy.py): no token is emitted — and
       no terminal recorded — by a revision other than the one the
       request was last admitted under. ``admitted`` carries the
       resolved ``revision`` tag on multi-model stacks and the engine
       stamps its own serving revision on ``first_token`` /
       ``decode_chunk`` / ``finish``; a mismatch means stale routing
       served a request across a weight rollout. A failover
       re-admission records a fresh ``admitted`` (re-prefill from the
       token log is revision-legal; migrated KV is not), which re-pins
       the trace. Untagged (single-model) dumps are vacuously clean.

    Deploy control-plane traces (every event in ``DEPLOY_KINDS``) skip
    the request invariants; instead a complete dump requires each
    started deploy to end in exactly one of ``deploy_commit`` /
    ``rollback``.
    """
    complete = bool(dump.get("complete", True))
    violations: List[str] = []
    by_trace = group_traces(dump.get("events", []))

    # FCFS simulation keyed by (engine, tenant): WFQ reorders ACROSS
    # tenants legally, so each tenant's queue is checked independently.
    # Untagged (pre-tenancy / single-tenant) dumps have tenant None
    # everywhere, collapsing to the historical per-engine global check.
    waiting: Dict[Any, Dict[str, float]] = {}
    engine_of: Dict[str, str] = {}
    tenant_of: Dict[str, Optional[str]] = {}
    all_events = sorted((e for e in dump.get("events", [])),
                        key=lambda e: e["seq"])
    readmit_batches: Dict[Any, List[Dict[str, Any]]] = {}

    for e in all_events:
        tid, kind = e["trace_id"], e["kind"]
        a = e.get("attrs") or {}
        if "tenant" in a and tenant_of.get(tid) is None:
            tenant_of[tid] = a["tenant"]
        if kind == "engine_admit":
            eng = a.get("engine", "?")
            engine_of[tid] = eng
            if "arrival" in a:
                key = (eng, tenant_of.get(tid))
                waiting.setdefault(key, {})[tid] = a["arrival"]
        elif kind in ("preempt", "requeue"):
            eng = engine_of.get(tid)
            if eng is not None and "arrival" in a:
                key = (eng, tenant_of.get(tid))
                waiting.setdefault(key, {})[tid] = a["arrival"]
        elif kind == "scheduled":
            eng = engine_of.get(tid)
            if eng is not None:
                key = (eng, tenant_of.get(tid))
                mine = waiting.get(key, {}).pop(tid, None)
                if mine is not None:
                    ahead = [(w, arr) for w, arr
                             in waiting.get(key, {}).items()
                             if arr < mine]
                    if ahead:
                        w, arr = min(ahead, key=lambda p: p[1])
                        tenant = tenant_of.get(tid)
                        scope = f"tenant {tenant!r} on {eng}" \
                            if tenant is not None else f"{eng}"
                        violations.append(
                            f"{tid}: scheduled (ticket {mine}) while "
                            f"{w} (ticket {arr}) was still waiting on "
                            f"{scope} — FCFS order broken")
        elif kind in ("finish", "failover", "migrate_out", "rejected"):
            # migrate_out leaves the per-engine FCFS simulation the same
            # way failover does: the request is gone from this engine
            # (a drained WAITING request re-enters it via the
            # engine_admit its re-dispatch emits on the new engine)
            eng = engine_of.get(tid)
            if eng is not None:
                waiting.get((eng, tenant_of.get(tid)), {}).pop(tid, None)
        elif kind == "migrate_in" and "engine" in a:
            # adopted straight into RUNNING: re-home the trace without a
            # waiting entry — migrated requests never queue again
            engine_of[tid] = a["engine"]
        if kind == "readmit" and "batch" in a:
            readmit_batches.setdefault(a["batch"], []).append(e)

    for batch, evts in readmit_batches.items():
        arrivals = [(e.get("attrs") or {}).get("arrival") for e in evts]
        arrivals = [x for x in arrivals if x is not None]
        if arrivals != sorted(arrivals):
            violations.append(
                f"readmit batch {batch}: re-admission order "
                f"{arrivals} is not arrival-ordered")

    for tid, evts in sorted(by_trace.items()):
        if all(e["kind"] in DEPLOY_KINDS for e in evts):
            # control-plane timeline: its terminal rule is commit XOR
            # rollback, and the request invariants don't apply
            started = sum(1 for e in evts
                          if e["kind"] == "deploy_start")
            ended = sum(1 for e in evts
                        if e["kind"] in ("deploy_commit", "rollback"))
            if started and complete and ended != 1:
                violations.append(
                    f"{tid}: deploy ended {ended} times (expected "
                    f"exactly one deploy_commit or rollback)")
            continue
        prefilled = False
        finishes = 0
        rejected = False
        last_failover_replica = None
        pending_migration = None
        ticket = None
        host_pending = False    # matched blocks still host-resident
        abort_open = False      # promote_abort awaiting re-prefill
        admitted_rev = None     # latest admitted revision (invariant 8)
        for e in evts:
            kind = e["kind"]
            a = e.get("attrs") or {}
            if kind == "admitted" and a.get("revision") is not None:
                admitted_rev = a["revision"]
            elif kind in ("first_token", "decode_chunk", "finish") \
                    and a.get("revision") is not None \
                    and admitted_rev is not None \
                    and a["revision"] != admitted_rev:
                violations.append(
                    f"{tid}: {kind} from revision {a['revision']!r} "
                    f"for a request admitted under revision "
                    f"{admitted_rev!r} — revision pinning broken")
            if "arrival" in a:
                if ticket is None:
                    ticket = a["arrival"]
                elif a["arrival"] != ticket:
                    violations.append(
                        f"{tid}: arrival ticket changed "
                        f"{ticket} -> {a['arrival']} at {kind} "
                        f"(requeue must preserve the FCFS ticket)")
                    ticket = a["arrival"]
            if kind in ("engine_admit", "preempt", "requeue"):
                prefilled = False
                host_pending = False    # re-admission re-probes tiers
            elif kind == "prefix_match":
                if a.get("host_tokens", 0) > 0:
                    host_pending = True
            elif kind in ("promote", "promote_abort"):
                host_pending = False
                if kind == "promote_abort":
                    abort_open = True
            elif kind == "prefill":
                prefilled = True
                abort_open = False
            elif kind == "prefill_chunk":
                abort_open = False
                if a.get("pos", 0) >= a.get("target", float("inf")):
                    prefilled = True
            elif kind in ("first_token", "decode_chunk"):
                if not prefilled:
                    violations.append(
                        f"{tid}: {kind} before prefill completed")
                if host_pending:
                    violations.append(
                        f"{tid}: {kind} while matched blocks were still "
                        f"host-resident (no promote/promote_abort since "
                        f"the tiered prefix_match)")
            elif kind == "failover":
                last_failover_replica = a.get("replica")
            elif kind == "migrate_out":
                # KV in flight: no engine may emit for this request
                # until migrate_in re-homes it (or engine_admit, for a
                # drained WAITING request that re-dispatches normally)
                prefilled = False
                pending_migration = a.get("replica")
            elif kind == "migrate_in":
                if pending_migration is None:
                    violations.append(
                        f"{tid}: migrate_in without a preceding "
                        f"migrate_out")
                elif a.get("from_replica") != pending_migration:
                    violations.append(
                        f"{tid}: migrate_in claims source replica "
                        f"{a.get('from_replica')} but the migrate_out "
                        f"was on replica {pending_migration}")
                pending_migration = None
                host_pending = False    # the payload moved device-side
                # the event says whether the payload already covers the
                # whole prompt; a mid-prefill migration stays unprefilled
                # until destination prefill_chunk events catch up
                prefilled = bool(a.get("prefilled", True))
            elif kind == "readmit":
                if last_failover_replica is None:
                    violations.append(
                        f"{tid}: readmit without a preceding failover")
                elif a.get("from_replica") != last_failover_replica:
                    violations.append(
                        f"{tid}: readmit claims predecessor replica "
                        f"{a.get('from_replica')} but the failover was "
                        f"on replica {last_failover_replica}")
            elif kind == "rejected":
                # terminal for the refused ATTEMPT: a router retry may
                # still admit the trace elsewhere, so this only waives
                # the finish requirement when nothing else happened
                rejected = True
            elif kind == "finish":
                finishes += 1
                abort_open = False      # terminal resolves the abort
                if a.get("reason") not in TERMINAL_REASONS:
                    violations.append(
                        f"{tid}: finish with unknown reason "
                        f"{a.get('reason')!r}")
        if abort_open and complete:
            violations.append(
                f"{tid}: promote_abort never followed by re-prefill or "
                f"a terminal — request wedged by a degraded promotion")
        if finishes > 1:
            violations.append(
                f"{tid}: {finishes} terminal events (expected exactly "
                f"one)")
        elif finishes == 0 and complete and not rejected:
            violations.append(
                f"{tid}: no terminal event in a complete dump")
    return violations
