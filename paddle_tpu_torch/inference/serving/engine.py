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
  packed int32 upload and one [k+2, N] fetch per chunk.

The first token of a request is sampled on the host from the prefill
logits with the request's np.random.RandomState, exactly as the JAX
engine does; later tokens are sampled in the chunk (attention.py says
how its draws differ from JAX's). Greedy output token-matches
models.generation.generate.

A chunk that flags a non-finite row is discarded whole: the offenders
are quarantined ('error', blocks scrubbed and freed) and the surviving
rows are requeued for re-prefill from their token logs, which replays
their streams unchanged.

Not ported yet (a later slice): the obs registry and request tracing,
the watchdog and fault injection, deadlines, tenancy, the prefix cache
and host tier, migration and ServingPredictor. EngineStats here is a
set of plain counters.
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
from ...models import generation as gen
from .attention import KERNELS, PACK_COLS, fused_decode_chunk, pack_f32
from .paged_cache import PagedKVCache
from .scheduler import (Request, RequestState, SamplingParams, Scheduler,
                        SchedulerConfig)

__all__ = ["EngineConfig", "EngineStats", "LLMEngine", "RequestOutput"]


@dataclass
class EngineConfig:
    block_size: int = 16
    num_blocks: int = 256
    max_num_seqs: int = 8
    max_prefill_tokens: int = 2048
    # tokens decoded per fused device chunk: one host sync per k tokens
    decode_chunk_size: int = 8
    # "ragged" (K3 kernel over the fixed max_num_seqs width) or
    # "bucketed" (gather + dense attention over power-of-two buckets)
    kernel: str = "ragged"
    # prompts STRICTLY longer than this are prefilled chunked inside the
    # fused decode chunk; None disables chunking
    prefill_chunk_threshold: Optional[int] = None
    max_waiting: Optional[int] = None    # bounded waiting queue (None=inf)
    admission_policy: str = "reject"     # 'reject' | 'shed_oldest'
    # not ported yet: any value but the default raises
    prefill_cost_model: Optional[object] = None
    enable_prefix_cache: bool = False
    host_tier_blocks: int = 0
    kv_cache_dtype: str = "float32"


@dataclass
class RequestOutput:
    """One streamed step result for one request. finish_reason: 'stop' |
    'length' | 'cancelled' | 'shed' | 'error'; abnormal terminals carry
    new_token=None."""
    request_id: str
    new_token: Optional[int]
    token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None


class EngineStats:
    """Plain engine counters. time_* are host wall seconds around each
    phase; every phase ends in a device->host fetch, so they include the
    device time. host_syncs counts those fetches per phase."""

    def __init__(self):
        self.steps = 0
        self.generated_tokens = 0
        self.prefill_tokens = 0
        self.preemptions = 0
        self.completed = 0
        self.cancelled = 0
        self.shed = 0
        self.errors = 0
        self.recoveries = 0
        self.rebuilt = 0
        self.time_schedule = 0.0
        self.time_prefill = 0.0
        self.time_decode = 0.0
        self.ttft_sum = 0.0
        self.latency_sum = 0.0
        self.host_syncs = {"prefill": 0, "decode": 0}

    def as_dict(self) -> dict:
        d = {k: v for k, v in vars(self).items() if k != "host_syncs"}
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
                 config: Optional[EngineConfig] = None,
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
        if config.prefill_cost_model is not None:
            raise NotImplementedError("prefill_cost_model: later slice")
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.geom = geom
        self.config = config
        self.max_blocks_per_seq = S // config.block_size
        self.cache = PagedKVCache(
            L, H, D, config.num_blocks, config.block_size,
            dtype=self.params["wte.weight"].dtype, device=self.device,
            enable_prefix_cache=config.enable_prefix_cache,
            host_tier_blocks=config.host_tier_blocks,
            kv_cache_dtype=config.kv_cache_dtype)
        self.scheduler = Scheduler(
            SchedulerConfig(
                max_num_seqs=config.max_num_seqs,
                max_prefill_tokens=config.max_prefill_tokens,
                decode_chunk_size=config.decode_chunk_size,
                max_waiting=config.max_waiting,
                admission_policy=config.admission_policy,
                prefill_chunk_threshold=config.prefill_chunk_threshold),
            self.cache)
        self._lock = threading.RLock()
        self.stats = EngineStats()
        self._requests: Dict[str, Request] = {}
        self._rngs: Dict[str, np.random.RandomState] = {}
        self._next_id = 0
        self._pending_outputs: List[RequestOutput] = []

    @classmethod
    def from_model(cls, model, config: Optional[EngineConfig] = None,
                   device: DeviceLike = None):
        """Engine over a port GPT's live parameters, on `device` (the
        default: CUDA)."""
        return cls(gen.extract_params(model), model.cfg.geom, config,
                   device=device)

    # ------------------------------------------------------------ intake
    def add_request(self, prompt_ids, sampling: SamplingParams = None,
                    request_id: str = None) -> str:
        """Queue one request. Raises ValueError for an empty or oversized
        request and EngineOverloaded when the bounded waiting queue is
        full under admission_policy='reject'; under 'shed_oldest' the
        oldest waiting request is evicted instead (its terminal output
        streams from the next step())."""
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
            for victim in self.scheduler.add(req):
                victim.finish_time = time.perf_counter()
                self.stats.shed += 1
                self._pending_outputs.append(RequestOutput(
                    victim.request_id, None, list(victim.output_ids),
                    True, "shed"))
            self._requests[request_id] = req
            self._rngs[request_id] = np.random.RandomState(
                sampling.seed & 0x7FFFFFFF)
            return request_id

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

    # --------------------------------------------------------- recovery
    def _quarantine(self, req: Request, outs: List[RequestOutput]):
        """One poisoned request costs one request: 'error' terminal,
        blocks scrubbed (NaN survives the attention mask) and freed."""
        self.stats.errors += 1
        self.scheduler.finish(req, RequestState.FINISHED_ERROR, scrub=True)
        req.finish_time = time.perf_counter()
        outs.append(RequestOutput(req.request_id, None,
                                  list(req.output_ids), True, "error"))

    def _recover(self, decode: List[Request], offenders: List[Request],
                 outs: List[RequestOutput]):
        """A chunk with a non-finite row emitted nothing: quarantine the
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
        """One engine iteration: schedule, prefill admitted requests,
        decode every running sequence for one chunk, stream the tokens."""
        with self._lock:
            outs: List[RequestOutput] = list(self._pending_outputs)
            self._pending_outputs.clear()
            self.stats.steps += 1
            t0 = time.perf_counter()
            batch = self.scheduler.schedule()
            self.stats.preemptions += len(batch.preempted)
            self.stats.time_schedule += time.perf_counter() - t0

            for req in batch.prefill:
                t0 = time.perf_counter()
                tokens = req.all_token_ids()
                logits = self._prefill(req, tokens)
                self.stats.prefill_tokens += int(tokens.size)
                self.stats.time_prefill += time.perf_counter() - t0
                if any_not_finite_host(logits):
                    self._quarantine(req, outs)
                    continue
                self._emit(req, self._sample(req, logits), outs)

            # requests finished at prefill released their blocks before
            # the decode chunk packs its tables
            decode = [r for r in batch.decode if not r.finished]
            if decode:
                t0 = time.perf_counter()
                toks, bad = self._decode_chunk(decode,
                                               self.config.decode_chunk_size)
                self.stats.time_decode += time.perf_counter() - t0
                if bad.any():
                    self._recover(decode,
                                  [r for i, r in enumerate(decode) if bad[i]],
                                  outs)
                else:
                    # step-major drain: row j of toks is trip j, -1 marks
                    # a frozen row; _emit re-derives eos/max_tokens on host
                    for j in range(toks.shape[0]):
                        for i, req in enumerate(decode):
                            t = int(toks[j, i])
                            if t >= 0 and not req.finished:
                                self._emit(req, t, outs)
            return outs

    def _prefill(self, req: Request, tokens: np.ndarray) -> np.ndarray:
        """Dense prefill scattered into the sequence's blocks; returns the
        last-position logits on the host (the phase's one fetch)."""
        logits, dense_cache = gen.prefill(
            self.params, torch.as_tensor(tokens[None], device=self.device),
            self.geom)
        self.cache.write_prefill(req.request_id, dense_cache, tokens.size)
        out = logits[0].cpu().numpy()
        self.stats.host_syncs["prefill"] += 1
        return out

    def _decode_chunk(self, reqs: List[Request], k: int):
        """Fused k-token decode for all running sequences, padded to the
        fixed max_num_seqs width ("ragged") or the power-of-two bucket
        ("bucketed"). Mid-prefill rows get their next min(k, remaining
        prompt) tokens in the feed columns and advance prefill_pos iff
        the chunk came back clean. Returns (tokens [k, len(reqs)] with -1
        on frozen rows, bad [len(reqs)] bool)."""
        ragged = self.config.kernel == "ragged"
        n = self.config.max_num_seqs if ragged \
            else _bucket(len(reqs), self.config.max_num_seqs)
        mb = self.max_blocks_per_seq
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
            table = self.cache.block_table(req.request_id)
            packed[i, PACK_COLS + k:PACK_COLS + k + len(table)] = table
        out, _ = fused_decode_chunk(
            self.params, self.cache.pools,
            torch.from_numpy(packed).to(self.device), self.geom, k,
            self.config.kernel)
        fetched = out.cpu().numpy()          # the chunk's one host sync
        self.stats.host_syncs["decode"] += 1
        live = len(reqs)
        bad = fetched[k + 1, :live].astype(bool)
        if not bad.any():
            for req, f in fed:
                req.prefill_pos += f
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
