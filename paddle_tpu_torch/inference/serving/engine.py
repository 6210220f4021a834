"""LLMEngine: continuous-batching serving loop over the paged KV cache.

Port of paddle_tpu/inference/serving/engine.py (the serving core).
Requests stream in (add_request); each step() schedules (FCFS with
recompute preemption, scheduler.py), prefills newly admitted requests
and decodes every running sequence, and streams the new tokens back.

Device work per step:
- prefill: models.generation.prefill (the same function the dense
  generate() uses), scattered into the sequence's blocks
  (PagedKVCache.write_prefill); one upload, one fetch of [V] logits.
- decode: serving.attention.fused_decode_chunk, decode_chunk_size tokens
  for every running sequence on the device, padded to the fixed
  max_num_seqs width under kernel="ragged" (dead rows cost the kernel
  no work) or to a power-of-two bucket under kernel="bucketed". One
  packed int32 upload and one [k+2, N] fetch per chunk. Before the
  chunk every row's write range is checked to lie in blocks that only
  it holds (PagedKVCache.write_blocks): with the prefix cache, rows
  share the blocks of a common prefix, and K3 reads them through every
  sharer's table. With int8 KV blocks the chunk runs on f32 staging
  pools of its working set (PagedKVCache.stage_chunk / commit_chunk).

The first token of a request is sampled on the host from the prefill
logits with the request's np.random.RandomState, exactly as the JAX
engine does; later tokens are sampled in the chunk (attention.py says
how its draws differ from JAX's). Greedy output token-matches
models.generation.generate.

Prefix cache and host tier (EngineConfig.enable_prefix_cache,
host_tier_blocks, promote_timeout_s): admitted prompts attach their
cached prefix and prefill only the suffix; prefill progress and
finished work register their full blocks in the trie; with a host tier
the host-resident prefix of a new request is promoted at enqueue
(`_prefetch_promote`) and again at admission.

Hardened step: every step first expires overdue requests (deadline_s /
queue_ttl_s -> 'timeout'), then runs prefill and decode under the
non-finite guard and a step watchdog (step_timeout_s, read after each
phase's fetch, which has already waited for the device). A poisoned or
wedged step quarantines the offending request ('error', blocks
scrubbed and freed) and requeues the other running requests for
re-prefill from their token logs, which replays their streams
unchanged. Fault injection (`faults=`, or the PADDLE_TPU_SERVE_FAULTS
environment variable) drives these paths deterministically.

Left out (later slices): the obs registry and request tracing
(EngineStats here is a set of plain counters under the reference's
names; obs_label takes only its default), the flight recorder, the
elastic heartbeat, tenancy, prefill cost models, migration and peer
prefix fetch, the (model, revision) KV key, and ServingPredictor.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.anomaly import any_not_finite_host
from ...core.place import DeviceLike, resolve_device
from ...core.unported import require_defaults
from ...models import generation as gen
from ...testing.faults import ServingFaultInjector
from .attention import KERNELS, PACK_COLS, fused_decode_chunk, pack_f32
from .paged_cache import PagedKVCache
from .scheduler import (EngineOverloaded, Request, RequestState,
                        SamplingParams, Scheduler, SchedulerConfig)

__all__ = ["EngineConfig", "EngineStats", "LLMEngine", "RequestOutput"]


@dataclass
class EngineConfig:
    """The reference's fields in its order. Not ported yet, so LLMEngine
    accepts only their defaults: prefill_cost_model, the obs label,
    tenants, and the (model, revision) key of exported KV."""
    block_size: int = 16
    num_blocks: int = 256
    max_num_seqs: int = 8
    max_prefill_tokens: int = 2048
    prefill_cost_model: Optional[object] = None
    # tokens decoded per fused device chunk: one host sync per k tokens
    decode_chunk_size: int = 8
    # "ragged" (K3 kernel over the fixed max_num_seqs width) or
    # "bucketed" (gather + dense attention over power-of-two buckets)
    kernel: str = "ragged"
    # prompts STRICTLY longer than this are prefilled chunked inside the
    # fused decode chunk; None disables chunking
    prefill_chunk_threshold: Optional[int] = None
    # radix-trie prefix cache with refcounted, copy-on-write blocks
    enable_prefix_cache: bool = False
    # > 0: a host-RAM tier of that many blocks behind the prefix cache
    host_tier_blocks: int = 0
    # wall-clock budget of one promotion run (None: unbounded)
    promote_timeout_s: Optional[float] = None
    # "int8": pools stored as int8 codes + per-(block, head) scales
    kv_cache_dtype: str = "float32"
    max_waiting: Optional[int] = None    # bounded waiting queue (None=inf)
    admission_policy: str = "reject"     # 'reject' | 'shed_oldest'
    cache_high_watermark: float = 1.0    # pause admission above
    step_timeout_s: Optional[float] = None  # watchdog budget per step
    obs_label: Optional[str] = None
    tenants: Optional[object] = None
    model: str = "default"
    revision: str = "r0"


@dataclass
class RequestOutput:
    """One streamed step result for one request. finish_reason: 'stop' |
    'length' | 'cancelled' | 'timeout' | 'shed' | 'error'; abnormal
    terminals carry new_token=None."""
    request_id: str
    new_token: Optional[int]
    token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None


class EngineStats:
    """Plain engine counters under the reference's names. time_* are
    host wall seconds around each phase; every phase ends in a
    device->host fetch, so they include the device time. host_syncs
    counts those fetches per phase. The prefix-cache and tier readings
    (`record_prefix`, `prefix_counter`, `tier_demotions`,
    `promotion_counter`, `promote_quantile`) mirror the cache's
    lifetime counters once per step."""

    _EVENTS = ("steps", "generated_tokens", "prefill_tokens", "preemptions",
               "completed", "cancelled", "expired", "timeouts", "shed",
               "errors", "recoveries", "rebuilt", "watchdog_trips",
               "rejected")

    def __init__(self):
        for name in self._EVENTS:
            setattr(self, name, 0)
        self.time_schedule = 0.0
        self.time_prefill = 0.0
        self.time_decode = 0.0
        self.ttft_sum = 0.0
        self.latency_sum = 0.0
        self.host_syncs = {"prefill": 0, "decode": 0}
        self._ttft: List[float] = []
        self._promote: List[float] = []
        self._prefix = {"hits": 0, "misses": 0, "evictions": 0}
        self._promotions = {"hit": 0, "timeout": 0, "integrity": 0,
                            "raced": 0}
        self._demotions = 0
        self.prefix_cached_tokens_ratio = 0.0
        self.prefix_blocks = {"cached": 0, "shared": 0, "host": 0}

    def observe_ttft(self, dt: float) -> None:
        self._ttft.append(dt)

    def ttft_quantile(self, q: float) -> float:
        """TTFT quantile over every request's first token (numpy linear
        interpolation; NaN with no samples)."""
        return float(np.quantile(self._ttft, q)) if self._ttft \
            else float("nan")

    def observe_promote(self, dt: float) -> None:
        self._promote.append(dt)

    def promote_quantile(self, q: float) -> float:
        """Quantile of the promotion runs' wall seconds (NaN with
        none)."""
        return float(np.quantile(self._promote, q)) if self._promote \
            else float("nan")

    def record_prefix(self, ps: dict) -> None:
        """Publish one PagedKVCache.prefix_stats snapshot."""
        for k in self._prefix:
            self._prefix[k] = ps[k]
        for o in self._promotions:
            self._promotions[o] = ps[f"promote_{o}"]
        self._demotions = ps["tier_demotions"]
        self.prefix_cached_tokens_ratio = ps["cached_tokens_ratio"]
        self.prefix_blocks = {"cached": ps["cached_blocks"],
                              "shared": ps["shared_blocks"],
                              "host": ps["host_blocks"]}

    def prefix_counter(self, kind: str) -> int:
        """Published counter ('hits' | 'misses' | 'evictions')."""
        return int(self._prefix[kind])

    def tier_demotions(self) -> int:
        return int(self._demotions)

    def promotion_counter(self, outcome: str) -> int:
        """Published promotion count for one outcome ('hit' | 'timeout'
        | 'integrity' | 'raced')."""
        return int(self._promotions[outcome])

    def as_dict(self) -> dict:
        d = {k: v for k, v in vars(self).items()
             if not k.startswith("_") and k not in ("host_syncs",
                                                    "prefix_blocks")}
        d["host_syncs_prefill"] = self.host_syncs["prefill"]
        d["host_syncs_decode"] = self.host_syncs["decode"]
        done = max(self.completed, 1)
        d["avg_ttft_s"] = self.ttft_sum / done
        d["avg_request_latency_s"] = self.latency_sum / done
        busy = self.time_prefill + self.time_decode
        d["decode_tokens_per_sec"] = (
            self.generated_tokens / busy if busy > 0 else 0.0)
        d["host_syncs_per_token"] = (
            self.host_syncs["decode"] / self.generated_tokens
            if self.generated_tokens else 0.0)
        return d


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class LLMEngine:
    """Continuous-batching engine over (params, geom) on one device.
    add_request/cancel may be called from other threads: every public
    entry point takes the engine lock, and step() holds it for one
    iteration."""

    def __init__(self, params: Dict[str, torch.Tensor], geom,
                 config: Optional[EngineConfig] = None, faults=None, *,
                 device: DeviceLike = None):
        config = config or EngineConfig()
        L, H, D, S = geom
        if S % config.block_size != 0:
            raise ValueError(f"block_size {config.block_size} must divide "
                             f"max_seq_len {S}")
        if config.decode_chunk_size < 1:
            raise ValueError(f"decode_chunk_size must be >= 1, got "
                             f"{config.decode_chunk_size}")
        if config.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{config.kernel!r}")
        require_defaults(
            "EngineConfig",
            prefill_cost_model=(config.prefill_cost_model, None),
            obs_label=(config.obs_label, None),
            tenants=(config.tenants, None),
            model=(config.model, "default"),
            revision=(config.revision, "r0"))
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.geom = geom
        self.config = config
        self.max_blocks_per_seq = S // config.block_size
        self.cache = PagedKVCache(
            L, H, D, config.num_blocks, config.block_size,
            dtype=self.params["wte.weight"].dtype,
            enable_prefix_cache=config.enable_prefix_cache,
            host_tier_blocks=config.host_tier_blocks,
            promote_timeout_s=config.promote_timeout_s,
            kv_cache_dtype=config.kv_cache_dtype, device=self.device)
        self.scheduler = Scheduler(
            SchedulerConfig(
                max_num_seqs=config.max_num_seqs,
                max_prefill_tokens=config.max_prefill_tokens,
                decode_chunk_size=config.decode_chunk_size,
                max_waiting=config.max_waiting,
                admission_policy=config.admission_policy,
                cache_high_watermark=config.cache_high_watermark,
                prefill_chunk_threshold=config.prefill_chunk_threshold),
            self.cache)
        self._lock = threading.RLock()
        self.stats = EngineStats()
        self._requests: Dict[str, Request] = {}
        self._rngs: Dict[str, np.random.RandomState] = {}
        self._next_id = 0
        self._pending_outputs: List[RequestOutput] = []
        self._step_start = 0.0
        # inert without a spec (the environment's, when none is given)
        self.faults = ServingFaultInjector() if faults is None else faults
        self.cache.arm_tier_faults(self.faults, 0)

    @classmethod
    def from_model(cls, model, config: Optional[EngineConfig] = None,
                   faults=None, *, device: DeviceLike = None):
        """Engine over a port GPT's live parameters, on `device` (the
        default: CUDA)."""
        return cls(gen.extract_params(model), model.cfg.geom, config,
                   faults, device=device)

    # ------------------------------------------------------------ intake
    def add_request(self, prompt_ids, sampling: SamplingParams = None,
                    request_id: str = None) -> str:
        """Queue one request. Raises ValueError for an empty or oversized
        request and EngineOverloaded when the bounded waiting queue is
        full under admission_policy='reject'; under 'shed_oldest' the
        oldest waiting request is evicted instead (its terminal output
        streams from the next step()). With a host tier the request's
        host-resident prefix is promoted now, while it waits."""
        sampling = sampling or SamplingParams()
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        S = self.geom[3]
        if ids.size + sampling.max_tokens > S:
            raise ValueError(
                f"prompt {ids.size} + max_tokens {sampling.max_tokens} "
                f"exceeds max_seq_len {S}")
        with self._lock:
            if request_id is None:
                request_id = f"req-{self._next_id}"
                self._next_id += 1
            if request_id in self._requests:
                raise ValueError(f"duplicate request_id {request_id!r}")
            req = Request(request_id=request_id, prompt_ids=ids,
                          params=sampling, arrival_time=time.perf_counter())
            try:
                shed = self.scheduler.add(req)
            except EngineOverloaded:
                self.stats.rejected += 1
                raise
            for victim in shed:
                victim.finish_time = time.perf_counter()
                self.stats.shed += 1
                self._pending_outputs.append(RequestOutput(
                    victim.request_id, None, list(victim.output_ids),
                    True, "shed"))
            self._requests[request_id] = req
            self._rngs[request_id] = np.random.RandomState(
                sampling.seed & 0x7FFFFFFF)
            if self.cache.host_tier is not None:
                self._prefetch_promote(req)
            return request_id

    def _prefetch_promote(self, req: Request) -> Optional[dict]:
        """Enqueue-time host->device promotion of the request's
        host-resident prefix (the scheduler's admission probe retries
        whatever this leaves). Returns ensure_promoted's result, or None
        when nothing host-resident matches. Never raises."""
        tokens = req.all_token_ids()
        if not self.cache.host_match_len(tokens):
            return None
        return self.cache.ensure_promoted(tokens)

    def cancel(self, request_id: str) -> bool:
        with self._lock:
            ok = self.scheduler.cancel(request_id)
            if ok:
                self.stats.cancelled += 1
                req = self._requests[request_id]
                req.finish_time = time.perf_counter()
                self._pending_outputs.append(RequestOutput(
                    request_id, None, list(req.output_ids), True,
                    "cancelled"))
            return ok

    def has_unfinished(self) -> bool:
        with self._lock:
            return self.scheduler.has_unfinished()

    def get_request(self, request_id: str) -> Request:
        with self._lock:
            return self._requests[request_id]

    def shed_oldest_waiting(self) -> Optional[str]:
        """Evict this engine's oldest waiting request; its terminal
        'shed' output streams from the next step(). Returns its id, or
        None when nothing waits."""
        with self._lock:
            victim = self.scheduler.shed_oldest()
            if victim is None:
                return None
            victim.finish_time = time.perf_counter()
            self.stats.shed += 1
            self._pending_outputs.append(RequestOutput(
                victim.request_id, None, list(victim.output_ids), True,
                "shed"))
            return victim.request_id

    def oldest_waiting_arrival(self) -> Optional[int]:
        with self._lock:
            return self.scheduler.oldest_waiting_arrival()

    # ---------------------------------------------------------- sampling
    def _sample(self, req: Request, logits: np.ndarray) -> int:
        """Host-side first-token sampling (the JAX engine's, unchanged)."""
        p = req.params
        if p.temperature <= 0.0:
            return int(np.argmax(logits))
        lg = logits.astype(np.float64) / p.temperature
        if p.top_k:
            kth = np.sort(lg)[-p.top_k]
            lg = np.where(lg < kth, -np.inf, lg)
        if 0.0 < p.top_p < 1.0:
            srt = np.sort(lg)[::-1]
            probs = np.exp(srt - srt.max())
            probs /= probs.sum()
            excl = np.cumsum(probs) - probs
            kth = srt[int((excl < p.top_p).sum()) - 1]
            lg = np.where(lg < kth, -np.inf, lg)
        probs = np.exp(lg - lg.max())
        probs /= probs.sum()
        return int(self._rngs[req.request_id].choice(len(probs), p=probs))

    def _emit(self, req: Request, tok: int, outs: List[RequestOutput]):
        """Record one sampled token, handle completion, stream it out."""
        now = time.perf_counter()
        if req.first_token_time is None:
            req.first_token_time = now
            self.stats.observe_ttft(now - req.arrival_time)
        req.last_token_time = now
        req.output_ids.append(tok)
        self.stats.generated_tokens += 1
        finished, reason = False, None
        if req.params.eos_token_id is not None \
                and tok == req.params.eos_token_id:
            finished, reason = True, "stop"
            state = RequestState.FINISHED_STOPPED
        elif len(req.output_ids) >= req.params.max_tokens:
            finished, reason = True, "length"
            state = RequestState.FINISHED_LENGTH
        if finished:
            self.scheduler.finish(req, state)
            req.finish_time = now
            self.stats.completed += 1
            self.stats.ttft_sum += req.first_token_time - req.arrival_time
            self.stats.latency_sum += now - req.arrival_time
        outs.append(RequestOutput(req.request_id, tok,
                                  list(req.output_ids), finished, reason))

    # --------------------------------------------- robustness primitives
    def _finish_abnormal(self, req: Request, state: str, reason: str,
                         outs: List[RequestOutput], scrub: bool = False):
        """Terminal path for timeout/shed/error: detach (freeing blocks
        iff running), stamp, stream the terminal RequestOutput."""
        if req.state == RequestState.RUNNING:
            self.scheduler.finish(req, state, scrub=scrub)
        else:
            req.state = state
        req.finish_time = time.perf_counter()
        outs.append(RequestOutput(req.request_id, None,
                                  list(req.output_ids), True, reason))

    def _expire_and_abort(self, outs: List[RequestOutput]) -> None:
        """Step-boundary deadline enforcement: expire queued requests
        past queue_ttl_s/deadline_s, abort running ones past
        deadline_s."""
        now = time.perf_counter()
        for req in self.scheduler.expire_waiting(now):
            self.stats.expired += 1
            req.finish_time = now
            outs.append(RequestOutput(req.request_id, None,
                                      list(req.output_ids), True,
                                      "timeout"))
        for req in self.scheduler.overdue_running(now):
            self.stats.timeouts += 1
            self._finish_abnormal(req, RequestState.FINISHED_TIMEOUT,
                                  "timeout", outs)

    def _wedged(self) -> bool:
        """Watchdog check at phase boundaries: has this step overrun
        step_timeout_s? Read after a phase's fetch, so the device work of
        the phase is inside the reading."""
        t = self.config.step_timeout_s
        return t is not None and \
            (time.perf_counter() - self._step_start) > t

    def _quarantine(self, req: Request, outs: List[RequestOutput]) -> None:
        """One poisoned or wedged request costs one request: 'error'
        terminal, blocks scrubbed (NaN survives the attention mask) and
        freed."""
        self.stats.errors += 1
        self._finish_abnormal(req, RequestState.FINISHED_ERROR, "error",
                              outs, scrub=True)

    def _recover(self, decode: List[Request], offenders: List[Request],
                 outs: List[RequestOutput]) -> None:
        """A chunk that went bad emitted nothing: quarantine the
        offenders and requeue every survivor (scrub-freed) for re-prefill
        from its token log. Sampling depends only on request progress,
        so the survivors' replayed streams are unchanged."""
        self.stats.recoveries += 1
        for req in offenders:
            self._quarantine(req, outs)
        for req in decode:
            if req not in offenders:
                self.scheduler.requeue_for_recovery(req)
                self.stats.rebuilt += 1

    # -------------------------------------------------------------- step
    def step(self) -> List[RequestOutput]:
        """One engine iteration: expire overdue requests, schedule,
        prefill admitted requests, decode every running sequence for one
        chunk, stream the tokens, under the non-finite guard and the
        watchdog."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> List[RequestOutput]:
        outs: List[RequestOutput] = list(self._pending_outputs)
        self._pending_outputs.clear()
        self.stats.steps += 1
        step_no = self.stats.steps
        self._step_start = time.perf_counter()
        self.faults.corrupt_cache(step_no, self.cache)
        self.faults.corrupt_host_block(step_no, self.cache)
        self.cache.arm_tier_faults(self.faults, step_no)
        self._expire_and_abort(outs)
        t0 = time.perf_counter()
        batch = self.scheduler.schedule()
        self.stats.preemptions += len(batch.preempted)
        self.stats.time_schedule += time.perf_counter() - t0

        for req in batch.prefill:
            t0 = time.perf_counter()
            tokens = req.all_token_ids()
            try:
                logits = self._prefill(req, tokens)
            except Exception:                # the reference's quarantine
                self._quarantine(req, outs)
                continue
            self.stats.prefill_tokens += int(tokens.size)
            self.stats.time_prefill += time.perf_counter() - t0
            logits = self.faults.poison_logits(step_no, logits)
            if any_not_finite_host(logits):
                self._quarantine(req, outs)
                continue
            self._emit(req, self._sample(req, logits), outs)
            if not req.finished and self._wedged():
                self.stats.watchdog_trips += 1
                self._quarantine(req, outs)

        # requests finished at prefill released their blocks before the
        # decode chunk packs its tables
        decode = [r for r in batch.decode if not r.finished]
        if decode:
            # where each row writes: blocks only that row holds, or the
            # step stops here (never inside the chunk's quarantine path)
            writes = [self.cache.write_blocks(r.request_id, r.slot[2])
                      for r in decode]
            t0 = time.perf_counter()
            k = self.config.decode_chunk_size
            self.faults.stall(step_no)
            try:
                toks, bad = self._decode_chunk(decode, k, writes)
            except Exception:                # the reference's recovery
                toks = None
                self._recover(decode, [decode[0]], outs)
            self.stats.time_decode += time.perf_counter() - t0
            if toks is not None:
                bad = self.faults.poison_chunk(step_no, bad)
                if bad.any():
                    self._recover(decode,
                                  [r for i, r in enumerate(decode) if bad[i]],
                                  outs)
                elif self._wedged():
                    # a wedged batched chunk cannot be attributed: the
                    # head is quarantined, the rest rebuilt
                    self.stats.watchdog_trips += 1
                    self._recover(decode, [decode[0]], outs)
                else:
                    # step-major drain: row j of toks is trip j, -1 marks
                    # a frozen row; _emit re-derives eos/max_tokens
                    for j in range(toks.shape[0]):
                        for i, req in enumerate(decode):
                            t = int(toks[j, i])
                            if t >= 0 and not req.finished:
                                self._emit(req, t, outs)
        if self.cache.prefix_index is not None:
            self.stats.record_prefix(self.cache.prefix_stats())
            for dt in self.cache.drain_promote_seconds():
                self.stats.observe_promote(dt)
        return outs

    def _prefill(self, req: Request, tokens: np.ndarray) -> np.ndarray:
        """Dense prefill scattered into the sequence's blocks; returns the
        last-position logits on the host (the phase's one fetch). The
        prompt's full blocks are indexed at once, so template siblings
        queued behind it already hit."""
        logits, dense_cache = gen.prefill(
            self.params, torch.as_tensor(tokens[None], device=self.device),
            self.geom)
        self.cache.write_prefill(req.request_id, dense_cache, tokens.size)
        if self.cache.prefix_index is not None:
            self.cache.register_prefix(req.request_id, tokens)
        out = logits[0].cpu().numpy()
        self.stats.host_syncs["prefill"] += 1
        return out

    def _decode_chunk(self, reqs: List[Request], k: int,
                      writes: List[List[int]]):
        """Fused k-token decode for all running sequences, padded to the
        fixed max_num_seqs width ("ragged") or the power-of-two bucket
        ("bucketed"). Mid-prefill rows get their next min(k, remaining
        prompt) tokens in the feed columns and advance prefill_pos (and
        index their newly full blocks) iff the chunk came back clean.
        `writes` are the blocks each row writes (PagedKVCache.
        write_blocks), re-encoded after the chunk in int8 mode. Returns
        (tokens [k, len(reqs)] with -1 on frozen rows, bad [len(reqs)]
        bool)."""
        ragged = self.config.kernel == "ragged"
        n = self.config.max_num_seqs if ragged \
            else _bucket(len(reqs), self.config.max_num_seqs)
        mb = self.max_blocks_per_seq
        tables = [self.cache.block_table(r.request_id) for r in reqs]
        pools, remap = self.cache.stage_chunk(tables)
        packed = np.zeros((n, PACK_COLS + k + mb), np.int32)
        fed = []
        for i, req in enumerate(reqs):
            p = req.params
            packed[i, 0] = req.last_token
            packed[i, 1] = req.slot[2]       # first reserved position
            packed[i, 2] = 1
            packed[i, 3] = len(req.output_ids)
            packed[i, 4] = p.max_tokens
            packed[i, 5] = -1 if p.eos_token_id is None \
                else int(p.eos_token_id)
            packed[i, 6] = pack_f32(p.temperature)
            packed[i, 7] = int(p.top_k)
            packed[i, 8] = pack_f32(p.top_p)
            packed[i, 9] = p.seed & 0x7FFFFFFF
            if req.prefill_pos < req.pf_target:
                pf_rem = req.pf_target - req.prefill_pos
                f = min(k, pf_rem)
                packed[i, 10] = f
                packed[i, 11] = 1 if pf_rem > k else 0
                prompt = req.all_token_ids()
                packed[i, PACK_COLS:PACK_COLS + f] = \
                    prompt[req.prefill_pos:req.prefill_pos + f]
                fed.append((req, f))
            table = tables[i] if remap is None else remap[tables[i]]
            packed[i, PACK_COLS + k:PACK_COLS + k + len(table)] = table
        out, _ = fused_decode_chunk(
            self.params, pools, torch.from_numpy(packed).to(self.device),
            self.geom, k, self.config.kernel)
        self.cache.commit_chunk(pools, remap,
                                [b for w in writes for b in w])
        fetched = out.cpu().numpy()          # the chunk's one host sync
        self.stats.host_syncs["decode"] += 1
        live = len(reqs)
        bad = fetched[k + 1, :live].astype(bool)
        if not bad.any():
            for req, f in fed:
                req.prefill_pos += f
                if self.cache.prefix_index is not None:
                    self.cache.register_prefix(
                        req.request_id,
                        req.all_token_ids()[:req.prefill_pos])
        return fetched[:k, :live], bad

    # ------------------------------------------------------- convenience
    def run(self, max_steps: int = None) -> Dict[str, np.ndarray]:
        """Drive every queued request to completion; returns
        {request_id: np.ndarray of generated token ids} (cancelled
        requests excluded)."""
        steps = 0
        while self.has_unfinished():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps")
        with self._lock:
            return {rid: np.asarray(r.output_ids, np.int64)
                    for rid, r in self._requests.items()
                    if r.state != RequestState.CANCELLED}
