"""Continuous-batching scheduler: FCFS admission, decode interleaving,
preemption under block-pool pressure.

Port of paddle_tpu/inference/serving/scheduler.py. Per engine step:

1. DECODE: every RUNNING sequence reserves the slots for its next decode
   chunk (cache.reserve_slots, up to decode_chunk_size tokens), earliest
   arrival first. If the pool is exhausted, the LATEST-arrived running
   sequence is preempted: its blocks are freed (its written KV stays
   matchable in the prefix trie) and it re-queues in arrival order with
   prompt := prompt + generated-so-far (recompute preemption), so an
   earlier request is never starved by a later one.
2. ADMIT: waiting requests are admitted in arrival order while the
   running set is under max_num_seqs, the per-step prefill token budget
   holds (the head of line may overflow an untouched budget), the pool
   can hold them, and post-admission occupancy stays under
   `cache_high_watermark` (evictable cached blocks count as headroom).
   With the prefix cache a request is probed first: a host-resident run
   behind its device match is promoted now, a cached prefix admits it
   CHUNKED whatever its length (the chunked path writes only the
   uncached suffix, so shared blocks are never written), and it is
   priced at its uncached suffix. Prompts longer than
   prefill_chunk_threshold are admitted chunked too. Admission never
   preempts. With a prefill cost model (analysis/jaxplan) the budget
   and the prices are its modelled FLOPs instead of token counts.

Multi-tenant admission (`SchedulerConfig.tenants`, a
tenancy.TenantRegistry): the admission head is chosen by start-time
weighted fair queuing over per-tenant virtual finish times, each
request priced at the cost model's price of its FULL effective prompt
over its tenant's weight, FCFS within a tenant, ties broken on the
arrival ticket. With no registry, or a single tenant waiting, the head
is the queue's head, exactly the FCFS path. A registry also arms the
deadline early reject (a request that cannot start before its deadline
at the measured step rate is refused at the door) and tags each
sequence's tenant into the cache for share-weighted prefix eviction.

Robustness: the waiting queue may be bounded (max_waiting; policy
'reject' raises EngineOverloaded, 'shed_oldest' evicts the oldest);
queued requests expire (`expire_waiting`) once their queue_ttl_s or
deadline_s elapses, and running requests past deadline_s are reported by
`overdue_running` for the engine to abort at the step boundary; every
requeue goes through `_requeue`, an arrival-ordered insert.

Every admission, prefix match, promotion, demotion, preemption and
requeue is recorded in the request-trace ring (obs/reqtrace.py) under
the request's trace id, from host values the scheduler already holds.

The fleet (router.py, migration.py) moves requests between schedulers:
`readmit` inserts a failed-over request at its original arrival
position, `adopt_running` installs a migrated one (its blocks already
imported) straight into the running set, `release_running` and
`remove_waiting` detach a request that now lives elsewhere (state
MIGRATED, terminal for this scheduler), and `abort_adopted` rolls back
an adoption whose migration failed.

The scheduler only does host-side accounting; the engine owns the
device work and calls the scheduler under its own lock. The scheduler's
own lock (taken by `schedule` and the fleet's entry points, lock order
engine -> scheduler) keeps the reference's lock order.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ...obs import reqtrace
from .paged_cache import CacheExhausted, PagedKVCache

__all__ = ["EngineOverloaded", "SamplingParams", "Request", "RequestState",
           "Scheduler", "SchedulerConfig", "ScheduledBatch",
           "record_promotion_events"]

ADMISSION_POLICIES = ("reject", "shed_oldest")


def record_promotion_events(tid: str, request_id: str,
                            promo: Optional[dict]) -> None:
    """Translate one `PagedKVCache.ensure_promoted` result into trace
    events (the engine's enqueue-time prefetch and the scheduler's
    admission-time retry share it). A partial promotion records both a
    `promote` (the blocks that landed) and a `promote_abort` (what
    stopped the run); `promo is None` means the host run vanished
    between probe and promotion."""
    if promo is None:
        reqtrace.record("promote_abort", tid, request_id,
                        outcome="raced", promoted=0)
        return
    if promo["promoted_blocks"]:
        reqtrace.record("promote", tid, request_id,
                        blocks=promo["promoted_blocks"],
                        tokens=promo["promoted_tokens"],
                        seconds=round(promo["seconds"], 6))
    if promo["outcomes"] and promo["outcomes"][-1] != "hit":
        reqtrace.record("promote_abort", tid, request_id,
                        outcome=promo["outcomes"][-1],
                        promoted=promo["promoted_blocks"])


class EngineOverloaded(RuntimeError):
    """Admission refused: the bounded waiting queue is full (policy
    'reject'). `retry_after_s` is a back-off hint when the raiser has
    one."""

    def __init__(self, request_id, depth: int, limit: int,
                 retry_after_s: Optional[float] = None):
        self.request_id = request_id
        self.depth = depth
        self.limit = limit
        self.retry_after_s = retry_after_s
        hint = "" if retry_after_s is None \
            else f"; retry after ~{retry_after_s:.2f}s"
        super().__init__(
            f"engine overloaded: request {request_id!r} rejected, waiting "
            f"queue at {depth}/{limit} (admission_policy='reject'; use "
            f"'shed_oldest' to evict instead){hint}")


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode knobs. temperature <= 0 is greedy; top_k = 0
    and top_p >= 1 disable those filters; seed keys both the host-side
    first-token draw and the in-chunk draws. deadline_s bounds the whole
    request (queue + decode) from arrival, queue_ttl_s only its wait in
    the queue; either ends it with finish_reason 'timeout'. tenant names
    the tenant whose share the request spends, resolved against the
    engine's TenantRegistry (ignored without one). model picks the
    model pool of a ReplicaSet built over a ModelRegistry (deploy.py);
    a single engine ignores it."""
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    deadline_s: Optional[float] = None
    queue_ttl_s: Optional[float] = None
    tenant: str = "default"
    model: str = "default"


class RequestState:
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED_STOPPED = "finished_stopped"    # sampled eos
    FINISHED_LENGTH = "finished_length"      # hit max_tokens
    FINISHED_TIMEOUT = "finished_timeout"    # deadline_s / queue_ttl_s hit
    FINISHED_SHED = "finished_shed"          # evicted by admission control
    FINISHED_ERROR = "finished_error"        # quarantined by the watchdog
    CANCELLED = "cancelled"
    MIGRATED = "migrated"                    # handed off to another engine

    # terminal for THIS engine: a MIGRATED request lives on at its
    # destination (the router's record follows it there)
    FINISHED = (FINISHED_STOPPED, FINISHED_LENGTH, FINISHED_TIMEOUT,
                FINISHED_SHED, FINISHED_ERROR, CANCELLED, MIGRATED)


_arrival_counter = itertools.count()


@dataclass
class Request:
    request_id: str
    prompt_ids: np.ndarray                   # int32 [T], never mutated
    params: SamplingParams
    output_ids: List[int] = field(default_factory=list)
    state: str = RequestState.WAITING
    arrival: int = field(default_factory=lambda: next(_arrival_counter))
    num_preemptions: int = 0
    slot: Optional[tuple] = None             # (block, offset, pos)
    arrival_time: float = 0.0
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # chunked prefill: pf_target is len(all_token_ids()) at admission,
    # prefill_pos advances per clean chunk (it starts at the cached
    # prefix length); the row is mid-prefill while prefill_pos <
    # pf_target. Both reset on every requeue.
    pf_target: int = 0
    prefill_pos: int = 0
    # request-trace id, minted at admission; survives preemption and
    # requeue
    trace_id: Optional[str] = None

    @property
    def tid(self) -> str:
        """Trace id for request-trace events (request_id for a bare
        Request built directly)."""
        return self.trace_id or self.request_id

    def all_token_ids(self) -> np.ndarray:
        """prompt + generated: the effective prompt after preemption."""
        if not self.output_ids:
            return self.prompt_ids
        return np.concatenate(
            [self.prompt_ids, np.asarray(self.output_ids, np.int32)])

    @property
    def last_token(self) -> int:
        return int(self.output_ids[-1]) if self.output_ids \
            else int(self.prompt_ids[-1])

    @property
    def finished(self) -> bool:
        return self.state in RequestState.FINISHED


@dataclass
class SchedulerConfig:
    """The reference's fields in its order."""
    max_num_seqs: int = 8                    # decode batch ceiling
    max_prefill_tokens: int = 2048           # per-step admission budget
    # an object with .cost(num_tokens) and .budget(max_prefill_tokens)
    # (analysis/jaxplan.PrefillCostModel): admissions are charged its
    # modelled FLOPs against budget(max_prefill_tokens); None keeps the
    # flat token count
    prefill_cost_model: Optional[object] = None
    decode_chunk_size: int = 1               # slots reserved per decode
    max_waiting: Optional[int] = None        # waiting-queue bound (None=inf)
    admission_policy: str = "reject"         # 'reject' | 'shed_oldest'
    # pause admission once post-admission occupancy would exceed this
    # fraction of the pool while sequences are running; 1.0 disables it
    cache_high_watermark: float = 1.0
    # prompts STRICTLY longer than this are admitted chunked; None
    # disables chunking
    prefill_chunk_threshold: Optional[int] = None
    # a tenancy.TenantRegistry: WFQ admission, the deadline early reject
    # and share-weighted prefix eviction; None keeps FCFS
    tenants: Optional[object] = None


@dataclass
class ScheduledBatch:
    prefill: List[Request] = field(default_factory=list)
    decode: List[Request] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)


class Scheduler:
    """FCFS / WFQ scheduler (module docstring). Not thread-safe on its
    own: LLMEngine calls it only under the engine lock (the tenant
    registry's lock is taken under it)."""

    def __init__(self, config: SchedulerConfig, cache: PagedKVCache):
        if config.admission_policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission_policy must be one of {ADMISSION_POLICIES}, "
                f"got {config.admission_policy!r}")
        if not 0.0 < config.cache_high_watermark <= 1.0:
            raise ValueError(
                f"cache_high_watermark must be in (0, 1], got "
                f"{config.cache_high_watermark}")
        self.config = config
        self.cache = cache
        self.waiting: deque = deque()
        self.running: List[Request] = []
        self.num_preemptions = 0
        self.watermark_holds = 0             # admissions paused by the mark
        # WFQ state (inert without a registry): _vtime is the system
        # virtual clock (the last admission's virtual start), _vfinish[t]
        # tenant t's last virtual finish; weights are the registry's WFQ
        # weights, re-read when its version moves
        self.tenants = config.tenants
        self._vtime = 0.0
        self._vfinish: dict = {}
        self._wfq_weights: dict = {}
        self._weights_version = -1
        # EWMA of engine step seconds (note_step_seconds), the service
        # rate of the deadline early reject; 0.0 until the first step
        self._step_ewma = 0.0
        self.deadline_rejects = 0
        self._lock = threading.RLock()

    # ------------------------------------------------------------- intake
    def add(self, req: Request) -> List[Request]:
        """Queue a request; returns the waiting requests shed to make
        room. Raises ValueError for a request the pool can never hold and
        EngineOverloaded when the bounded queue is full under 'reject'."""
        worst = len(req.prompt_ids) + req.params.max_tokens
        if self.cache.blocks_needed(worst) > self.cache.num_blocks:
            raise ValueError(
                f"request {req.request_id!r} needs "
                f"{self.cache.blocks_needed(worst)} blocks at its longest"
                f" ({worst} tokens) but the pool only has "
                f"{self.cache.num_blocks}; grow num_blocks or shrink the"
                f" request")
        # a request that cannot meet its deadline is refused before it
        # could shed viable queued work to make room for itself
        self._deadline_early_reject(req)
        shed: List[Request] = []
        limit = self.config.max_waiting
        if limit is not None:
            if self.config.admission_policy == "reject":
                if len(self.waiting) >= limit:
                    raise EngineOverloaded(req.request_id,
                                           len(self.waiting), limit)
            else:
                while len(self.waiting) >= limit:
                    victim = self.waiting.popleft()
                    victim.state = RequestState.FINISHED_SHED
                    shed.append(victim)
        req.state = RequestState.WAITING
        self.waiting.append(req)
        self._note_tenant(req)
        return shed

    def _check_fits(self, req: Request) -> None:
        worst = len(req.prompt_ids) + req.params.max_tokens
        if self.cache.blocks_needed(worst) > self.cache.num_blocks:
            raise ValueError(
                f"request {req.request_id!r} needs "
                f"{self.cache.blocks_needed(worst)} blocks at its longest"
                f" ({worst} tokens) but the pool only has "
                f"{self.cache.num_blocks}")

    def readmit(self, req: Request) -> None:
        """Failover re-admission: insert a request recovered from a
        failed replica at its ORIGINAL arrival position (the arrival-
        ordered requeue of preemption, across engines). Bypasses
        max_waiting: the bound is backpressure against new arrivals, and
        bouncing recovered in-flight work would lose it."""
        self._check_fits(req)
        with self._lock:
            self._requeue(req)
            self._note_tenant(req)

    # ----------------------------------------------------- block migration
    def adopt_running(self, req: Request) -> None:
        """Migration admission: install an in-flight request straight
        into the running set. Its KV blocks were imported already
        (PagedKVCache.import_blocks), so nothing re-prefills: the next
        schedule() reserves its decode chunk. Bypasses max_waiting, as
        readmit does."""
        self._check_fits(req)
        if not self.cache.has_seq(req.request_id):
            raise ValueError(
                f"adopt_running: seq {req.request_id!r} has no imported "
                f"cache state; import_blocks must run first")
        with self._lock:
            req.slot = None
            req.state = RequestState.RUNNING
            self.running.append(req)
            self._note_tenant(req)

    def release_running(self, req: Request) -> None:
        """Migration release (source side): detach a RUNNING request whose
        payload the destination committed. Its blocks are freed through
        the completion path (the written prefix registers, so the source
        trie keeps its entries and shared blocks drop one reference). No
        terminal output: the request lives on elsewhere."""
        with self._lock:
            self.running.remove(req)
            self.cache.free(req.request_id,
                            cache_tokens=self._cache_tokens(req))
            req.slot = None
            req.state = RequestState.MIGRATED

    def remove_waiting(self, request_id: str) -> Optional[Request]:
        """Pull a WAITING request out of the queue without a terminal
        state (drain evacuation: queued work has no KV, so the router
        re-dispatches it from its token log). Returns it, or None when it
        is not waiting."""
        with self._lock:
            for req in list(self.waiting):
                if req.request_id == request_id:
                    self.waiting.remove(req)
                    req.state = RequestState.MIGRATED
                    return req
            return None

    def abort_adopted(self, req: Request) -> None:
        """Roll back an adopt_running whose migration failed before the
        source released: drop the request and free its imported blocks
        without registering a prefix (it never decoded here)."""
        with self._lock:
            if req in self.running:
                self.running.remove(req)
            if self.cache.has_seq(req.request_id):
                self.cache.free(req.request_id)
            req.slot = None
            req.state = RequestState.MIGRATED

    def running_requests(self) -> List[Request]:
        """Snapshot of the running set (the migration coordinator scans
        it at step boundaries)."""
        with self._lock:
            return list(self.running)

    def shed_oldest(self) -> Optional[Request]:
        """Evict the oldest waiting request; returns it with state
        FINISHED_SHED, or None when nothing waits."""
        if not self.waiting:
            return None
        victim = self.waiting.popleft()
        victim.state = RequestState.FINISHED_SHED
        return victim

    def oldest_waiting_arrival(self) -> Optional[int]:
        """Arrival ticket of the head of the waiting line (None when
        empty)."""
        return self.waiting[0].arrival if self.waiting else None

    def backlog(self) -> dict:
        """Load snapshot: `waiting` (queue depth), `block_demand` (the
        worst-case blocks still needed to finish every queued and
        admitted request) and `prefill_cost` (the queued re-prefills,
        priced by the cost model when configured, flat tokens
        otherwise)."""
        cost_model = self.config.prefill_cost_model
        demand = 0
        cost = 0.0
        for req in self.waiting:
            tokens = len(req.prompt_ids) + len(req.output_ids)
            remaining = max(0, req.params.max_tokens - len(req.output_ids))
            demand += self.cache.blocks_needed(tokens + remaining)
            cost += cost_model.cost(tokens) if cost_model else tokens
        for req in self.running:
            tokens = len(req.prompt_ids) + len(req.output_ids)
            remaining = max(0, req.params.max_tokens - len(req.output_ids))
            held = len(self.cache.block_table(req.request_id)) \
                if self.cache.has_seq(req.request_id) else 0
            demand += max(
                0, self.cache.blocks_needed(tokens + remaining) - held)
        return {"waiting": len(self.waiting), "block_demand": demand,
                "prefill_cost": cost}

    def cancel(self, request_id: str) -> bool:
        for req in list(self.waiting):
            if req.request_id == request_id:
                self.waiting.remove(req)
                req.state = RequestState.CANCELLED
                return True
        for req in self.running:
            if req.request_id == request_id:
                self.running.remove(req)
                self.cache.free(request_id,
                                cache_tokens=self._cache_tokens(req))
                req.state = RequestState.CANCELLED
                return True
        return False

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running)

    def num_waiting(self) -> int:
        return len(self.waiting)

    def num_running(self) -> int:
        return len(self.running)

    # ----------------------------------------------------- expiry / abort
    def expire_waiting(self, now: float) -> List[Request]:
        """Remove waiting requests whose queue_ttl_s or deadline_s has
        elapsed (both from arrival_time); returns them FINISHED_TIMEOUT
        for the engine to report."""
        expired = []
        for req in list(self.waiting):
            p = req.params
            age = now - req.arrival_time
            if (p.queue_ttl_s is not None and age > p.queue_ttl_s) \
                    or (p.deadline_s is not None and age > p.deadline_s):
                self.waiting.remove(req)
                req.state = RequestState.FINISHED_TIMEOUT
                expired.append(req)
        return expired

    def overdue_running(self, now: float) -> List[Request]:
        """Running requests past their deadline_s (the engine aborts
        them at the step boundary)."""
        return [r for r in self.running
                if r.params.deadline_s is not None
                and (now - r.arrival_time) > r.params.deadline_s]

    # ---------------------------------------------------------- requeue
    def _cache_tokens(self, req: Request):
        """Tokens whose KV the sequence has WRITTEN, which a release may
        index into the prefix trie: mid-prefill the committed
        prefill_pos; after prefill everything but the last sampled token
        (emitted, never fed back). None when the prefix cache is off."""
        if self.cache.prefix_index is None:
            return None
        toks = req.all_token_ids()
        if req.pf_target and req.prefill_pos < req.pf_target:
            valid = req.prefill_pos
        else:
            valid = len(req.prompt_ids) + max(0, len(req.output_ids) - 1)
        return toks[:valid]

    def _requeue(self, req: Request) -> None:
        """Arrival-ordered insert into the waiting queue, so a bumped
        request keeps its original FCFS priority. Chunked-prefill
        progress is cache state and resets: re-admission re-prefills from
        the token log."""
        req.slot = None
        req.state = RequestState.WAITING
        req.pf_target = 0
        req.prefill_pos = 0
        for i, w in enumerate(self.waiting):
            if w.arrival > req.arrival:
                self.waiting.insert(i, req)
                return
        self.waiting.append(req)

    def _preempt(self, victim: Request, batch: ScheduledBatch) -> None:
        """Recompute preemption: drop the cache (its written KV stays
        matchable), requeue in arrival order with the generated tokens
        folded into the prompt."""
        self.running.remove(victim)
        if victim in batch.decode:
            batch.decode.remove(victim)
        self.cache.free(victim.request_id,
                        cache_tokens=self._cache_tokens(victim))
        victim.num_preemptions += 1
        self.num_preemptions += 1
        self._requeue(victim)
        batch.preempted.append(victim)
        reqtrace.record("preempt", victim.tid, victim.request_id,
                        arrival=victim.arrival,
                        num_preemptions=victim.num_preemptions,
                        tokens_kept=len(victim.output_ids))

    def requeue_for_recovery(self, req: Request) -> None:
        """Crash-recovery rebuild of a surviving RUNNING request: scrub
        and free its blocks (a poisoned chunk may have written NaN into
        them) and requeue it for re-prefill from its token log."""
        self.running.remove(req)
        self.cache.free(req.request_id, scrub=True)
        self._requeue(req)
        reqtrace.record("requeue", req.tid, req.request_id,
                        reason="recovery", arrival=req.arrival,
                        tokens_kept=len(req.output_ids))

    # ------------------------------------------------- multi-tenant WFQ
    def note_step_seconds(self, dt: float) -> None:
        """Engine step-time feed for the deadline early reject's service
        rate (EWMA weighted toward recent steps)."""
        self._step_ewma = dt if self._step_ewma == 0.0 \
            else 0.8 * self._step_ewma + 0.2 * dt

    def waiting_by_tenant(self) -> dict:
        """Queue depth per tenant."""
        out: dict = {}
        for req in self.waiting:
            t = req.params.tenant
            out[t] = out.get(t, 0) + 1
        return out

    def _note_tenant(self, req: Request) -> None:
        """Tenant bookkeeping on intake (inert without a registry):
        refresh the weight snapshots and tag the sequence's tenant into
        the cache, which stamps it on the trie nodes it registers."""
        if self.tenants is None:
            return
        self._refresh_weights()
        self.cache.note_seq_tenant(req.request_id, req.params.tenant)

    def _refresh_weights(self) -> None:
        """Re-read the registry's WFQ weights and prefix shares (into
        the cache's weighted eviction) when its version moved."""
        reg = self.tenants
        if reg is None or reg.version == self._weights_version:
            return
        self._wfq_weights = reg.wfq_weights()
        self._weights_version = reg.version
        self.cache.set_tenant_weights(reg.prefix_shares())

    def _full_price(self, req: Request) -> float:
        """WFQ price: the cost model's price of the FULL effective prompt
        (flat tokens without a model), not the per-step admission price
        that sees only the first chunk or the uncached suffix: fairness
        is about the total work a request commands."""
        n = len(req.prompt_ids) + len(req.output_ids)
        cost_model = self.config.prefill_cost_model
        return float(cost_model.cost(n)) if cost_model else float(n)

    def _deadline_early_reject(self, req: Request) -> None:
        """Can this request's prefill even start before its deadline
        (its own deadline_s, else its tenant's deadline_slo_s) at the
        measured step rate? The estimate is optimistic (the queue ahead
        at full budget throughput, no decode time), so a refusal is
        certain; raises EngineOverloaded with a retry_after_s sized to
        the excess. Abstains without a registry or a measured rate."""
        if self.tenants is None or self._step_ewma <= 0.0:
            return
        deadline = req.params.deadline_s
        if deadline is None:
            deadline = self.tenants.resolve(req.params.tenant).deadline_slo_s
        if deadline is None:
            return
        cost_model = self.config.prefill_cost_model
        budget = cost_model.budget(self.config.max_prefill_tokens) \
            if cost_model else float(self.config.max_prefill_tokens)
        ahead = sum(self._full_price(w) for w in self.waiting)
        own = self._full_price(req)
        steps = max(1.0, (ahead + own) / max(budget, 1.0))
        est = steps * self._step_ewma
        if est <= deadline:
            return
        self.deadline_rejects += 1
        retry = round(est - deadline + self._step_ewma, 3)
        reqtrace.record("rejected", req.tid, req.request_id,
                        reason="deadline", deadline_s=deadline,
                        estimate_s=round(est, 3),
                        tenant=req.params.tenant)
        raise EngineOverloaded(req.request_id, len(self.waiting),
                               self.config.max_waiting or 0,
                               retry_after_s=retry)

    def _select_waiting(self) -> Request:
        """WFQ head: each tenant's first waiting request (FCFS within a
        tenant), ranked by virtual finish max(vtime, vfinish[tenant]) +
        price / weight, ties on the arrival ticket. With one tenant
        waiting this is self.waiting[0], the FCFS head."""
        heads: dict = {}
        for req in self.waiting:
            t = req.params.tenant
            if t not in heads:
                heads[t] = req
        if len(heads) <= 1:
            return self.waiting[0]
        self._refresh_weights()
        best = None
        best_key = None
        for t, req in heads.items():
            w = max(self._wfq_weights.get(t, 1.0), 1e-9)
            start = max(self._vtime, self._vfinish.get(t, 0.0))
            key = (start + self._full_price(req) / w, req.arrival)
            if best is None or key < best_key:
                best, best_key = req, key
        return best

    def _dequeue(self, req: Request) -> None:
        """Remove the admitted request from the queue (the WFQ head need
        not be the deque's head) and advance the virtual clock: the
        tenant's vfinish absorbs its full price over its weight, and
        vtime moves to the admission's virtual start, so an idle tenant
        re-enters at the current clock."""
        if self.waiting and self.waiting[0] is req:
            self.waiting.popleft()
        else:
            self.waiting.remove(req)
        if self.tenants is None:
            return
        self._refresh_weights()
        t = req.params.tenant
        w = max(self._wfq_weights.get(t, 1.0), 1e-9)
        start = max(self._vtime, self._vfinish.get(t, 0.0))
        self._vfinish[t] = start + self._full_price(req) / w
        self._vtime = start

    # ---------------------------------------------------------- schedule
    def schedule(self) -> ScheduledBatch:
        with self._lock:
            return self._schedule_locked()

    def _schedule_locked(self) -> ScheduledBatch:
        batch = ScheduledBatch()
        # 1. decode slots, earliest arrival first; preempt from the back.
        # Each sequence reserves its whole next chunk (capped by its
        # remaining budget) so the fused scan never allocates mid-chunk.
        chunk = max(1, self.config.decode_chunk_size)
        for req in sorted(self.running, key=lambda r: r.arrival):
            if req not in self.running:      # preempted below, this step
                continue
            remaining = req.params.max_tokens - len(req.output_ids)
            if req.prefill_pos < req.pf_target:
                pf_rem = req.pf_target - req.prefill_pos
                n = min(chunk, pf_rem + max(0, remaining))
            else:
                n = min(chunk, remaining)
            n = max(1, n)
            while True:
                try:
                    req.slot = self.cache.reserve_slots(req.request_id, n)
                    batch.decode.append(req)
                    break
                except CacheExhausted:
                    victim = max(self.running, key=lambda r: r.arrival)
                    self._preempt(victim, batch)
                    if victim is req:
                        break                # preempted itself; move on
        # 2. admission (FCFS, or WFQ across tenants) under the seq
        # count, the prefill budget (the cost model's FLOPs, else tokens)
        # and the occupancy watermark
        cost_model = self.config.prefill_cost_model
        budget = cost_model.budget(self.config.max_prefill_tokens) \
            if cost_model else self.config.max_prefill_tokens
        mark = self.config.cache_high_watermark
        thr = self.config.prefill_chunk_threshold
        admitted = 0
        while self.waiting and len(self.running) < self.config.max_num_seqs:
            req = self.waiting[0] if self.tenants is None \
                else self._select_waiting()
            tokens = req.all_token_ids()
            cached_probe = self.cache.match_len(tokens)
            # a host-resident run behind the device match is promoted
            # now (the retry of the engine's enqueue-time prefetch), and
            # the request is re-probed at what actually landed
            host_probe = self.cache.host_match_len(tokens)
            if host_probe:
                reqtrace.record(
                    "prefix_match", req.tid, req.request_id,
                    cached_tokens=cached_probe, host_tokens=host_probe,
                    probe=cached_probe)
                promo = self.cache.ensure_promoted(tokens)
                record_promotion_events(req.tid, req.request_id, promo)
                cached_probe = self.cache.match_len(tokens)
            uncached = len(tokens) - cached_probe
            chunked = (thr is not None and len(tokens) > thr) \
                or cached_probe > 0 or host_probe > 0
            eff = min(chunk, uncached) if chunked else len(tokens)
            price = cost_model.cost(eff) if cost_model else eff
            if price > budget and admitted:
                break                        # budget spent; next step
            needed = self.cache.blocks_needed(eff)
            used = self.cache.num_used() - self.cache.num_evictable()
            if (used + needed) > mark * self.cache.num_blocks \
                    and self.running:
                # above the watermark with live decodes: hold admission
                # so their growth cannot hit CacheExhausted
                self.watermark_holds += 1
                break
            if chunked:
                remaining = max(0, req.params.max_tokens
                                - len(req.output_ids))
                d0 = self.cache.tier_demotions
                try:
                    got = self.cache.allocate_with_prefix(req.request_id,
                                                          tokens)
                    req.slot = self.cache.reserve_slots(
                        req.request_id,
                        min(chunk, (len(tokens) - got) + remaining))
                except CacheExhausted:
                    if self.cache.has_seq(req.request_id):
                        self.cache.free(req.request_id)
                    break                    # never preempt to admit
                dd = self.cache.tier_demotions - d0
                if dd:
                    reqtrace.record("demote", req.tid, req.request_id,
                                    blocks=dd)
                req.pf_target = len(tokens)
                req.prefill_pos = got
                self._dequeue(req)
                req.state = RequestState.RUNNING
                self.running.append(req)
                # rides THIS step's fused decode dispatch
                batch.decode.append(req)
                if got:
                    bs = self.cache.block_size
                    reqtrace.record(
                        "prefix_match", req.tid, req.request_id,
                        cached_tokens=got, blocks=-(-got // bs),
                        cow_fork=bool(got % bs), probe=cached_probe)
                reqtrace.record(
                    "scheduled", req.tid, req.request_id, mode="chunked",
                    price=float(price), budget=float(budget),
                    arrival=req.arrival, cached=got,
                    target=req.pf_target)
            else:
                d0 = self.cache.tier_demotions
                try:
                    self.cache.allocate(req.request_id, len(tokens))
                except CacheExhausted:
                    break                    # never preempt to admit
                dd = self.cache.tier_demotions - d0
                if dd:
                    reqtrace.record("demote", req.tid, req.request_id,
                                    blocks=dd)
                self.cache.note_prefix_miss(len(tokens))
                self._dequeue(req)
                req.state = RequestState.RUNNING
                self.running.append(req)
                batch.prefill.append(req)
                reqtrace.record(
                    "scheduled", req.tid, req.request_id, mode="dense",
                    price=float(price), budget=float(budget),
                    arrival=req.arrival, tokens=len(tokens))
            admitted += 1
            budget -= price
        return batch

    # ------------------------------------------------------------ results
    def finish(self, req: Request, state: str, scrub: bool = False) -> None:
        """Completion path: release blocks (zeroed first when `scrub`,
        else indexing the written prefix), detach from running."""
        self.running.remove(req)
        self.cache.free(
            req.request_id, scrub=scrub,
            cache_tokens=None if scrub else self._cache_tokens(req))
        req.slot = None
        req.state = state
