"""Continuous-batching scheduler: FCFS admission, decode interleaving,
preemption under block-pool pressure.

Port of paddle_tpu/inference/serving/scheduler.py (the single-tenant
FCFS core). Per engine step:

1. DECODE: every RUNNING sequence reserves the slots for its next decode
   chunk (cache.reserve_slots, up to decode_chunk_size tokens), earliest
   arrival first. If the pool is exhausted, the LATEST-arrived running
   sequence is preempted: its blocks are freed and it re-queues in
   arrival order with prompt := prompt + generated-so-far (recompute
   preemption), so an earlier request is never starved by a later one.
2. ADMIT: waiting requests are admitted in arrival order while the
   running set is under max_num_seqs and the per-step prefill token
   budget holds (the head of line may overflow an untouched budget, so a
   long prompt is never starved). Prompts longer than
   prefill_chunk_threshold are admitted CHUNKED: they join the running
   set with an empty table and feed decode_chunk_size prompt tokens per
   step through the fused decode chunk. Admission never preempts.

The waiting queue may be bounded (max_waiting): a full queue rejects new
arrivals with EngineOverloaded (policy 'reject') or evicts its oldest
request (policy 'shed_oldest').

Not ported yet: tenancy/WFQ, deadlines and queue TTLs, migration
(adopt/release), the prefix cache probes and prefill cost models.

The scheduler only does host-side accounting; the engine owns the
device work and serialises every call into the scheduler under its own
lock.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ...core.unported import require_defaults
from .paged_cache import CacheExhausted, PagedKVCache

__all__ = ["EngineOverloaded", "SamplingParams", "Request", "RequestState",
           "Scheduler", "SchedulerConfig", "ScheduledBatch"]

ADMISSION_POLICIES = ("reject", "shed_oldest")


class EngineOverloaded(RuntimeError):
    """Admission refused: the bounded waiting queue is full (policy
    'reject')."""

    def __init__(self, request_id, depth: int, limit: int):
        self.request_id = request_id
        self.depth = depth
        self.limit = limit
        super().__init__(
            f"engine overloaded: request {request_id!r} rejected, waiting "
            f"queue at {depth}/{limit} (admission_policy='reject'; use "
            f"'shed_oldest' to evict instead)")


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode knobs. temperature <= 0 is greedy; top_k = 0
    and top_p >= 1 disable those filters; seed keys both the host-side
    first-token draw and the in-chunk draws."""
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0


class RequestState:
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED_STOPPED = "finished_stopped"    # sampled eos
    FINISHED_LENGTH = "finished_length"      # hit max_tokens
    FINISHED_SHED = "finished_shed"          # evicted by admission control
    FINISHED_ERROR = "finished_error"        # quarantined (non-finite)
    CANCELLED = "cancelled"

    FINISHED = (FINISHED_STOPPED, FINISHED_LENGTH, FINISHED_SHED,
                FINISHED_ERROR, CANCELLED)


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
    # prefill_pos advances per clean chunk; the row is mid-prefill while
    # prefill_pos < pf_target. Both reset on every requeue.
    pf_target: int = 0
    prefill_pos: int = 0

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
    """The reference's fields in its order; prefill_cost_model,
    cache_high_watermark and tenants are not ported yet (the Scheduler
    accepts only their defaults)."""
    max_num_seqs: int = 8                    # decode batch ceiling
    max_prefill_tokens: int = 2048           # per-step admission budget
    prefill_cost_model: Optional[object] = None
    decode_chunk_size: int = 1               # slots reserved per decode
    max_waiting: Optional[int] = None        # waiting-queue bound (None=inf)
    admission_policy: str = "reject"         # 'reject' | 'shed_oldest'
    cache_high_watermark: float = 1.0
    # prompts STRICTLY longer than this are admitted chunked; None
    # disables chunking
    prefill_chunk_threshold: Optional[int] = None
    tenants: Optional[object] = None


@dataclass
class ScheduledBatch:
    prefill: List[Request] = field(default_factory=list)
    decode: List[Request] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)


class Scheduler:
    """FCFS scheduler (module docstring). Not thread-safe on its own:
    LLMEngine calls it only under the engine lock."""

    def __init__(self, config: SchedulerConfig, cache: PagedKVCache):
        require_defaults(
            "SchedulerConfig",
            prefill_cost_model=(config.prefill_cost_model, None),
            cache_high_watermark=(config.cache_high_watermark, 1.0),
            tenants=(config.tenants, None))
        if config.admission_policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission_policy must be one of {ADMISSION_POLICIES}, "
                f"got {config.admission_policy!r}")
        self.config = config
        self.cache = cache
        self.waiting: deque = deque()
        self.running: List[Request] = []
        self.num_preemptions = 0

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
        return shed

    def cancel(self, request_id: str) -> bool:
        for req in list(self.waiting):
            if req.request_id == request_id:
                self.waiting.remove(req)
                req.state = RequestState.CANCELLED
                return True
        for req in self.running:
            if req.request_id == request_id:
                self.running.remove(req)
                self.cache.free(request_id)
                req.state = RequestState.CANCELLED
                return True
        return False

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running)

    def num_waiting(self) -> int:
        return len(self.waiting)

    def num_running(self) -> int:
        return len(self.running)

    # ---------------------------------------------------------- requeue
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
        """Recompute preemption: drop the cache, requeue in arrival order
        with the generated tokens folded into the prompt."""
        self.running.remove(victim)
        if victim in batch.decode:
            batch.decode.remove(victim)
        self.cache.free(victim.request_id)
        victim.num_preemptions += 1
        self.num_preemptions += 1
        self._requeue(victim)
        batch.preempted.append(victim)

    def requeue_for_recovery(self, req: Request) -> None:
        """Crash-recovery rebuild of a surviving RUNNING request: scrub
        and free its blocks (a poisoned chunk may have written NaN into
        them) and requeue it for re-prefill from its token log."""
        self.running.remove(req)
        self.cache.free(req.request_id, scrub=True)
        self._requeue(req)

    # ---------------------------------------------------------- schedule
    def schedule(self) -> ScheduledBatch:
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
        # 2. FCFS admission under the seq count and prefill token budget
        budget = self.config.max_prefill_tokens
        thr = self.config.prefill_chunk_threshold
        admitted = 0
        while self.waiting and len(self.running) < self.config.max_num_seqs:
            req = self.waiting[0]
            tokens = req.all_token_ids()
            chunked = thr is not None and len(tokens) > thr
            # a chunked admission is priced (and block-checked) per chunk
            eff = min(chunk, len(tokens)) if chunked else len(tokens)
            if eff > budget and admitted:
                break                        # budget spent; next step
            if chunked:
                remaining = max(0, req.params.max_tokens
                                - len(req.output_ids))
                try:
                    self.cache.allocate(req.request_id, 0)
                    req.slot = self.cache.reserve_slots(
                        req.request_id, min(chunk, len(tokens) + remaining))
                except CacheExhausted:
                    if self.cache.has_seq(req.request_id):
                        self.cache.free(req.request_id)
                    break                    # never preempt to admit
                req.pf_target = len(tokens)
                req.prefill_pos = 0
                # rides THIS step's fused decode dispatch
                batch.decode.append(req)
            else:
                try:
                    self.cache.allocate(req.request_id, len(tokens))
                except CacheExhausted:
                    break                    # never preempt to admit
                batch.prefill.append(req)
            self.waiting.popleft()
            req.state = RequestState.RUNNING
            self.running.append(req)
            admitted += 1
            budget -= eff
        return batch

    # ------------------------------------------------------------ results
    def finish(self, req: Request, state: str, scrub: bool = False) -> None:
        """Completion path: release blocks (zeroed first when `scrub`),
        detach from running."""
        self.running.remove(req)
        self.cache.free(req.request_id, scrub=scrub)
        req.slot = None
        req.state = state
