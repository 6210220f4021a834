"""LLMEngine: continuous-batching serving loop over the paged KV cache.

Port of paddle_tpu/inference/serving/engine.py (the single engine).
Requests stream in (add_request); each step() schedules (FCFS, or WFQ
across tenants, with recompute preemption: scheduler.py), prefills newly
admitted requests and decodes every running sequence, and streams the
new tokens back.

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

Tenants (EngineConfig.tenants, a tenancy.TenantRegistry): add_request
resolves the request's tenant, charges its sliding-window quota for
prompt + max_tokens (TenantQuotaExceeded when spent; refunded when the
scheduler refuses the request), and binds the tenant to the request's
trace. Admission is WFQ priced by the prefill cost model
(EngineConfig.prefill_cost_model: a PrefillCostModel, or "auto" for the
committed plan's, analysis/jaxplan.py), and prefix eviction is
share-weighted.

Hardened step: every step first expires overdue requests (deadline_s /
queue_ttl_s -> 'timeout'), then runs prefill and decode under the
non-finite guard and a step watchdog (step_timeout_s, read after each
phase's fetch, which has already waited for the device). A poisoned or
wedged step quarantines the offending request ('error', blocks
scrubbed and freed) and requeues the other running requests for
re-prefill from their token logs, which replays their streams
unchanged. Fault injection (`faults=`, or the PADDLE_TPU_SERVE_FAULTS
environment variable) drives these paths deterministically.

Telemetry: EngineStats is a view over the obs metrics registry under a
unique `engine` label (EngineConfig.obs_label is its prefix); every
request carries a trace id (`tr-<label>-N`) and every lifecycle event is
recorded in the request-trace ring (obs/reqtrace.py); each phase runs
under an obs.trace span. All of it records host values the step already
holds: the telemetry adds no device->host synchronisation (a decode
chunk is still one fetch). A quarantine queues a flight-recorder dump,
written after the engine lock is released.

Fleet surface (router.py, replica.py, migration.py): add_request's
arrival_time / arrival / resume_tokens / readmit / trace_id carry a
failed-over request's original arrival, FCFS ticket, streamed tokens and
trace onto a survivor; `load_info` is the router's balance snapshot;
`export_request` / `admit_migrated` / `release_migrated` /
`abort_migrated` move a running request's KV and token log between
engines, `release_waiting` hands queued work back to the router, and
`prefix_probe` / `export_prefix` / `admit_prefix` serve peer prefix
fetch. EngineConfig.model and revision key the engine's weights: every
exported payload carries the key, the admit paths refuse another key,
and an engine with a non-default key stamps it on its first_token,
decode_chunk and terminal events (obs/reqtrace.py invariant 8).

`step()` and `ServingPredictor.run` beat the elastic heartbeat
(distributed/elastic.py; a no-op unless supervised), as in the JAX
package. Left out (a later slice): the lock witness.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ... import obs
from ...core.anomaly import any_not_finite_host
from ...core.place import DeviceLike, resolve_device
from ...distributed.elastic import heartbeat
from ...models import generation as gen
from ...obs.trace import Span
from ...testing.faults import ServingFaultInjector
from .attention import KERNELS, PACK_COLS, fused_decode_chunk, pack_f32
from .paged_cache import CacheExhausted, PagedKVCache
from .scheduler import (EngineOverloaded, Request, RequestState,
                        SamplingParams, Scheduler, SchedulerConfig,
                        record_promotion_events)

__all__ = ["EngineConfig", "EngineStats", "LLMEngine", "RequestOutput",
           "ServingPredictor"]


@dataclass
class EngineConfig:
    """The reference's fields in its order."""
    block_size: int = 16
    num_blocks: int = 256
    max_num_seqs: int = 8
    max_prefill_tokens: int = 2048
    # a PrefillCostModel pricing each admission by its modelled prefill
    # FLOPs; "auto" reads the committed plan's (jaxplan.json; flat if
    # none); None keeps the flat token budget
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
    # prefix of this engine's `engine` label in the obs registry; the
    # label is always made unique per instance (prefix-N)
    obs_label: Optional[str] = None
    # a tenancy.TenantRegistry, shared by reference: WFQ admission,
    # quotas, the deadline early reject, share-weighted eviction
    tenants: Optional[object] = None
    # (model, revision) key of the weights the engine serves (the fleet's
    # ModelRegistry stamps it): exported KV carries it and the admit
    # paths refuse a payload keyed otherwise
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


# int event counters (serving_events_total{engine,event}); the field
# name is the event label
_STAT_EVENTS = ("steps", "prefill_tokens", "generated_tokens",
                "preemptions", "completed", "cancelled", "expired",
                "timeouts", "shed", "errors", "recoveries", "rebuilt",
                "watchdog_trips", "rejected")
# float phase-time accumulators (serving_phase_seconds_total{engine,phase})
_STAT_PHASES = {"time_schedule": "schedule", "time_prefill": "prefill",
                "time_decode": "decode"}
# per-request wall-time sums over completed requests
_STAT_REQ_SUMS = {"ttft_sum": "ttft", "latency_sum": "latency"}

_ENGINE_IDS = itertools.count()


class EngineStats:
    """Engine statistics as a view over the obs registry, under the
    reference's family names and labels: `stats.completed += 1`
    increments serving_events_total{engine=<label>, event="completed"}.
    Each instance gets a unique `engine` label (the caller's label, or
    "engine", is its prefix), so two engines never merge their series.
    time_* are host wall seconds around each phase; every phase ends in
    a device->host fetch, so they include the device time. The view
    also holds the latency histograms (TTFT, inter-token gap, request
    latency, step and chunk time), the per-step gauges, the host-sync
    counters and the prefix-cache and tier families, recorded through
    the helpers below. The engine mutates it only under its lock."""

    def __init__(self, label: str = None):
        if label is None:
            label = "engine"
        self.label = f"{label}-{next(_ENGINE_IDS)}"
        lbl = dict(engine=self.label)
        ev = obs.counter("serving_events_total",
                         "engine lifecycle/robustness event counts",
                         labels=("engine", "event"))
        self._events = {f: ev.labels(event=f, **lbl) for f in _STAT_EVENTS}
        ph = obs.counter("serving_phase_seconds_total",
                         "host wall time accumulated per engine phase",
                         labels=("engine", "phase"), unit="seconds")
        self._phases = {f: ph.labels(phase=p, **lbl)
                        for f, p in _STAT_PHASES.items()}
        rs = obs.counter("serving_request_seconds_total",
                         "per-request wall-time sums over completed "
                         "requests (kind=ttft|latency)",
                         labels=("engine", "kind"), unit="seconds")
        self._req_sums = {f: rs.labels(kind=k, **lbl)
                          for f, k in _STAT_REQ_SUMS.items()}
        self._ttft = obs.histogram(
            "serving_ttft_seconds",
            "time to first token, observed once per request",
            labels=("engine",), unit="seconds").labels(**lbl)
        self._token_gap = obs.histogram(
            "serving_token_gap_seconds",
            "inter-token latency (gap between consecutive emitted "
            "tokens of one request)",
            labels=("engine",), unit="seconds").labels(**lbl)
        self._latency = obs.histogram(
            "serving_request_latency_seconds",
            "request wall time arrival→finish, observed at completion",
            labels=("engine",), unit="seconds").labels(**lbl)
        self._step = obs.histogram(
            "serving_step_seconds", "engine step() wall time",
            labels=("engine",), unit="seconds").labels(**lbl)
        self._decode_chunk = obs.histogram(
            "serving_decode_chunk_seconds",
            "fused k-token decode chunk wall time (the device scan plus "
            "its single host fetch)",
            labels=("engine",), unit="seconds").labels(**lbl)
        sy = obs.counter(
            "serving_host_syncs_total",
            "device->host synchronizations: one per prefill logits "
            "fetch, one per fused decode chunk fetch",
            labels=("engine", "phase"))
        self._syncs = {p: sy.labels(phase=p, **lbl)
                       for p in ("prefill", "decode")}
        self._g_syncs_per_token = obs.gauge(
            "serving_host_syncs_per_token",
            "decode host syncs / generated tokens — the steady-state "
            "per-token host round-trip cost the fused chunk amortizes "
            "to ~1/k",
            labels=("engine",)).labels(**lbl)
        g_run = obs.gauge("serving_running", "running sequences",
                          labels=("engine",))
        g_wait = obs.gauge("serving_waiting", "waiting-queue depth",
                           labels=("engine",))
        g_blk = obs.gauge("serving_cache_blocks",
                          "paged-cache block pool occupancy",
                          labels=("engine", "state"), unit="blocks")
        g_spend = obs.gauge("serving_prefill_spend_tokens",
                            "prompt tokens admitted to prefill this step "
                            "(per-step spend against max_prefill_tokens)",
                            labels=("engine",), unit="tokens")
        self._c_prefill_chunks = obs.counter(
            "serving_prefill_chunks_total",
            "prompt chunks consumed inside the fused decode scan — one "
            "per mid-prefill row per chunk dispatch (chunked prefill)",
            labels=("engine",)).labels(**lbl)
        self._g_padding_waste = obs.gauge(
            "serving_padding_waste_ratio",
            "dead (padded) rows / batch width of the last decode "
            "dispatch: (bucket - live)/bucket under the bucketed "
            "fallback; 0 under the ragged kernel, whose per-row length "
            "gating makes dead rows cost zero kernel work",
            labels=("engine",)).labels(**lbl)
        self._g_running = g_run.labels(**lbl)
        self._g_waiting = g_wait.labels(**lbl)
        self._g_blocks_used = g_blk.labels(state="used", **lbl)
        self._g_blocks_free = g_blk.labels(state="free", **lbl)
        self._g_prefill_spend = g_spend.labels(**lbl)
        self._prefix_counters = {
            "hits": obs.counter(
                "serving_prefix_cache_hits_total",
                "admissions that attached at least one cached prefix "
                "token", labels=("engine",)).labels(**lbl),
            "misses": obs.counter(
                "serving_prefix_cache_misses_total",
                "admissions that matched nothing in the prefix trie",
                labels=("engine",)).labels(**lbl),
            "evictions": obs.counter(
                "serving_prefix_cache_evictions_total",
                "unreferenced cached blocks reclaimed under pool "
                "pressure (LRU leaf first)",
                labels=("engine",)).labels(**lbl),
        }
        self._g_prefix_ratio = obs.gauge(
            "serving_prefix_cached_tokens_ratio",
            "prompt tokens served from cache / prompt tokens admitted "
            "(lifetime, per engine)",
            labels=("engine",)).labels(**lbl)
        g_pfx = obs.gauge(
            "serving_prefix_cache_blocks",
            "prefix-cache block census: kind=cached (trie-indexed) | "
            "shared (refcount >= 2); tenant='*' is the all-tenants "
            "total, per-tenant children carry kind=cached only "
            "(cardinality bounded by the TenantRegistry)",
            labels=("engine", "kind", "tenant"), unit="blocks")
        self._f_prefix_blocks = g_pfx
        self._g_prefix_cached = g_pfx.labels(kind="cached", tenant="*",
                                             **lbl)
        self._g_prefix_shared = g_pfx.labels(kind="shared", tenant="*",
                                             **lbl)
        self._g_prefix_tenant: Dict[str, object] = {}
        g_tier = obs.gauge(
            "serving_prefix_tier_blocks",
            "prefix-cache residency per tier: device (trie-indexed HBM "
            "blocks) | host (demoted host-RAM payloads)",
            labels=("engine", "tier"), unit="blocks")
        self._g_tier_device = g_tier.labels(tier="device", **lbl)
        self._g_tier_host = g_tier.labels(tier="host", **lbl)
        self._c_demotions = obs.counter(
            "serving_tier_demotions_total",
            "device->host spills (demote-instead-of-free evictions)",
            labels=("engine",)).labels(**lbl)
        pr = obs.counter(
            "serving_tier_promotions_total",
            "host->device promotion attempts by outcome: hit (filled, "
            "digest verified) | timeout (killed/over budget/pool hot — "
            "entry stays resident) | integrity (sha256 mismatch, "
            "dropped) | raced (store evicted first, dropped)",
            labels=("engine", "outcome"))
        self._promotions = {o: pr.labels(outcome=o, **lbl)
                            for o in ("hit", "timeout",
                                      "integrity", "raced")}
        self._promote_hist = obs.histogram(
            "serving_tier_promote_seconds",
            "wall time of one host->device promotion run (all blocks "
            "promoted for one request probe)",
            labels=("engine",), unit="seconds").labels(**lbl)

    # -------------------------------------------------- record helpers
    def observe_ttft(self, dt: float) -> None:
        self._ttft.observe(dt)

    def observe_token_gap(self, dt: float) -> None:
        self._token_gap.observe(dt)

    def observe_latency(self, dt: float) -> None:
        self._latency.observe(dt)

    def observe_step(self, dt: float) -> None:
        self._step.observe(dt)

    def set_step_gauges(self, running: int, waiting: int,
                        blocks_used: int, blocks_free: int) -> None:
        self._g_running.set(running)
        self._g_waiting.set(waiting)
        self._g_blocks_used.set(blocks_used)
        self._g_blocks_free.set(blocks_free)

    def set_prefill_spend(self, tokens: int) -> None:
        self._g_prefill_spend.set(tokens)

    def observe_decode_chunk(self, dt: float) -> None:
        self._decode_chunk.observe(dt)

    def inc_prefill_chunks(self, n: int = 1) -> None:
        self._c_prefill_chunks.inc(n)

    def prefill_chunks(self) -> int:
        return int(self._c_prefill_chunks.value)

    def set_padding_waste(self, v: float) -> None:
        self._g_padding_waste.set(v)

    def padding_waste(self) -> float:
        return self._g_padding_waste.value

    def inc_host_sync(self, phase: str) -> None:
        self._syncs[phase].inc()

    def host_syncs(self, phase: str) -> int:
        """Exact device->host sync count of one phase ("prefill" or
        "decode"), as the reference reads it. Decode syncs equal the
        number of chunks."""
        return int(self._syncs[phase].value)

    def set_syncs_per_token(self, v: float) -> None:
        self._g_syncs_per_token.set(v)

    def host_syncs_per_token(self) -> float:
        return self._g_syncs_per_token.value

    def record_prefix(self, ps: dict) -> None:
        """Publish one PagedKVCache.prefix_stats snapshot: counters
        advance by their delta (lifetime-monotone on the cache side),
        gauges overwrite. Per-tenant block gauges are created on first
        sight and never retired (a tenant at zero blocks reports 0)."""
        for k, child in self._prefix_counters.items():
            delta = ps[k] - child.value
            if delta > 0:
                child.inc(delta)
        self._g_prefix_ratio.set(ps["cached_tokens_ratio"])
        self._g_prefix_cached.set(ps["cached_blocks"])
        self._g_prefix_shared.set(ps["shared_blocks"])
        tb = ps.get("tenant_blocks") or {}
        for t in tb:
            if t not in self._g_prefix_tenant:
                self._g_prefix_tenant[t] = self._f_prefix_blocks.labels(
                    kind="cached", tenant=t, engine=self.label)
        for t, child in self._g_prefix_tenant.items():
            child.set(tb.get(t, 0))
        delta = ps["tier_demotions"] - self._c_demotions.value
        if delta > 0:
            self._c_demotions.inc(delta)
        for o, child in self._promotions.items():
            delta = ps[f"promote_{o}"] - child.value
            if delta > 0:
                child.inc(delta)
        self._g_tier_device.set(ps["cached_blocks"])
        self._g_tier_host.set(ps["host_blocks"])

    def prefix_counter(self, kind: str) -> int:
        """Published counter ('hits' | 'misses' | 'evictions')."""
        return int(self._prefix_counters[kind].value)

    def prefix_tenant_blocks(self, tenant: str) -> int:
        """Published per-tenant cached-block gauge."""
        child = self._g_prefix_tenant.get(tenant)
        return int(child.value) if child is not None else 0

    def observe_promote(self, dt: float) -> None:
        self._promote_hist.observe(dt)

    def promote_quantile(self, q: float) -> float:
        """Quantile of the promotion runs' wall seconds (NaN with
        none)."""
        return self._promote_hist.quantile(q)

    def tier_demotions(self) -> int:
        return int(self._c_demotions.value)

    def promotion_counter(self, outcome: str) -> int:
        """Published promotion count for one outcome ('hit' | 'timeout'
        | 'integrity' | 'raced')."""
        return int(self._promotions[outcome].value)

    def ttft_quantile(self, q: float) -> float:
        """TTFT quantile over every request's first token (numpy linear
        interpolation; NaN with no samples)."""
        return self._ttft.quantile(q)

    def token_gap_quantile(self, q: float) -> float:
        """Inter-token-gap quantile."""
        return self._token_gap.quantile(q)

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in _STAT_EVENTS}
        for f in _STAT_PHASES:
            d[f] = getattr(self, f)
        for f in _STAT_REQ_SUMS:
            d[f] = getattr(self, f)
        done = max(self.completed, 1)
        d["avg_ttft_s"] = self.ttft_sum / done
        d["avg_request_latency_s"] = self.latency_sum / done
        busy = self.time_prefill + self.time_decode
        d["decode_tokens_per_sec"] = (
            self.generated_tokens / busy if busy > 0 else 0.0)
        d["host_syncs_per_token"] = (
            self.host_syncs("decode") / self.generated_tokens
            if self.generated_tokens else 0.0)
        return d


def _stats_property(table: str, f: str, as_int: bool):
    """Accessor pair over one registry child: reads return its value,
    writes inc() the delta, so `stats.x += 1` works against a counter
    (which refuses to go down)."""

    def _get(self):
        v = getattr(self, table)[f].value
        return int(v) if as_int else v

    def _set(self, new):
        child = getattr(self, table)[f]
        delta = new - child.value
        if delta:
            child.inc(delta)

    return property(_get, _set)


for _f in _STAT_EVENTS:
    setattr(EngineStats, _f, _stats_property("_events", _f, as_int=True))
for _f in _STAT_PHASES:
    setattr(EngineStats, _f, _stats_property("_phases", _f, as_int=False))
for _f in _STAT_REQ_SUMS:
    setattr(EngineStats, _f, _stats_property("_req_sums", _f,
                                             as_int=False))
del _f


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class LLMEngine:
    """Continuous-batching engine over (params, geom) on one device.
    add_request/cancel may be called from other threads: every public
    entry point takes the engine lock, and step() holds it for one
    iteration. Lock order: engine -> tenant registry; the request-trace
    ring and the metrics registry take their own locks last."""

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
        cost_model = config.prefill_cost_model
        if cost_model == "auto":
            # the committed plan's pricing; flat without a plan file
            from ...analysis import jaxplan
            cost_model = jaxplan.default_admission_model()
        self.scheduler = Scheduler(
            SchedulerConfig(
                max_num_seqs=config.max_num_seqs,
                max_prefill_tokens=config.max_prefill_tokens,
                decode_chunk_size=config.decode_chunk_size,
                max_waiting=config.max_waiting,
                admission_policy=config.admission_policy,
                cache_high_watermark=config.cache_high_watermark,
                prefill_cost_model=cost_model,
                prefill_chunk_threshold=config.prefill_chunk_threshold,
                tenants=config.tenants),
            self.cache)
        self._lock = threading.RLock()
        self.stats = EngineStats(config.obs_label)
        # (model, revision) event tag: default-keyed engines stay untagged
        self._rev_tag: Dict[str, str] = {}
        if (config.model, config.revision) != ("default", "r0"):
            self._rev_tag = {"model": config.model,
                             "revision": config.revision}
        self._requests: Dict[str, Request] = {}
        self._rngs: Dict[str, np.random.RandomState] = {}
        self._next_id = 0
        self._next_trace = 0
        self._pending_outputs: List[RequestOutput] = []
        self._flights: List[tuple] = []      # deferred flight dumps
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
                    request_id: str = None, arrival_time: float = None,
                    arrival: int = None, resume_tokens=None,
                    readmit: bool = False, trace_id: str = None) -> str:
        """Queue one request. Raises ValueError for an empty or oversized
        request (or an unknown tenant), TenantQuotaExceeded when its
        tenant's quota window is spent, and EngineOverloaded when the
        bounded waiting queue is full under admission_policy='reject' or
        the request cannot meet its deadline; under 'shed_oldest' the
        oldest waiting request is evicted instead (its terminal output
        streams from the next step()). With a host tier its
        host-resident prefix is promoted now, while it waits.

        The failover surface (router.py): `arrival_time` / `arrival`
        carry the request's original wall-clock arrival and FCFS ticket
        (deadlines keep counting from the original arrival, and a requeue
        keeps its place in line); `resume_tokens` seeds the output log
        with the tokens already streamed, so the re-prefill continues the
        same stream; `readmit=True` inserts arrival-ordered, bypasses
        max_waiting and charges no quota; `trace_id` keeps the router's
        trace id across the hop (a standalone engine mints
        `tr-<engine label>-N`)."""
        sampling = sampling or SamplingParams()
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        S = self.geom[3]
        if ids.size + sampling.max_tokens > S:
            raise ValueError(
                f"prompt {ids.size} + max_tokens {sampling.max_tokens} "
                f"exceeds max_seq_len {S}")
        tenants = self.config.tenants
        if tenants is not None:
            # an unknown tenant is a caller bug, refused before any
            # engine state is touched
            tenants.resolve(sampling.tenant)
        with self._lock:
            if request_id is None:
                request_id = f"req-{self._next_id}"
                self._next_id += 1
            old = self._requests.get(request_id)
            if old is not None and old.state != RequestState.MIGRATED:
                # a migrated-out record does not block re-admission: a
                # request may come back to an engine it once left
                raise ValueError(f"duplicate request_id {request_id!r}")
            now = time.perf_counter()
            req = Request(request_id=request_id, prompt_ids=ids,
                          params=sampling,
                          arrival_time=now if arrival_time is None
                          else arrival_time)
            if arrival is not None:
                req.arrival = arrival
            if trace_id is None:
                trace_id = f"tr-{self.stats.label}-{self._next_trace}"
                self._next_trace += 1
            req.trace_id = trace_id
            if tenants is not None:
                # every later event of this trace carries the tenant
                obs.reqtrace.bind_tenant(req.tid, sampling.tenant)
            if resume_tokens is not None and len(resume_tokens):
                req.output_ids = [int(t) for t in resume_tokens]
                # TTFT was observed where the first token was emitted;
                # this engine records only token gaps, from now
                req.first_token_time = req.arrival_time
                req.last_token_time = now
            charged = 0
            if tenants is not None and not readmit:
                # the sliding-window quota, charged for the worst case
                # (prompt + max_tokens) before the scheduler sees it; a
                # readmission never charges twice
                try:
                    tenants.charge(sampling.tenant,
                                   ids.size + sampling.max_tokens,
                                   model=self.config.model)
                except EngineOverloaded as e:
                    self.stats.rejected += 1
                    obs.reqtrace.record(
                        "rejected", req.tid, request_id, reason="quota",
                        tenant=sampling.tenant, spent=e.depth,
                        quota=e.limit, retry_after_s=e.retry_after_s)
                    e.request_id = request_id
                    raise
                charged = ids.size + sampling.max_tokens
            try:
                if readmit:
                    self.scheduler.readmit(req)
                    shed = []
                else:
                    shed = self.scheduler.add(req)
            except EngineOverloaded:
                if charged:
                    tenants.refund(sampling.tenant, charged,
                                   model=self.config.model)
                self.stats.rejected += 1
                raise
            except ValueError:
                if charged:
                    tenants.refund(sampling.tenant, charged,
                                   model=self.config.model)
                raise
            for victim in shed:
                victim.finish_time = time.perf_counter()
                self.stats.shed += 1
                self._pending_outputs.append(RequestOutput(
                    victim.request_id, None, list(victim.output_ids),
                    True, "shed"))
                obs.reqtrace.record("finish", victim.tid,
                                    victim.request_id, reason="shed",
                                    **self._rev_tag)
            self._requests[request_id] = req
            self._rngs[request_id] = np.random.RandomState(
                sampling.seed & 0x7FFFFFFF)
            obs.reqtrace.record(
                "engine_admit", req.tid, request_id,
                engine=self.stats.label, arrival=req.arrival,
                readmit=bool(readmit), resume=len(req.output_ids),
                waiting=self.scheduler.num_waiting(), **self._rev_tag)
            if self.cache.host_tier is not None:
                self._prefetch_promote(req)
            return request_id

    def _prefetch_promote(self, req: Request) -> None:
        """Enqueue-time host->device promotion of the request's
        host-resident prefix (the scheduler's admission probe retries
        whatever this leaves). Never raises: ensure_promoted degrades
        every failure to re-prefill of the missing suffix."""
        tokens = req.all_token_ids()
        host = self.cache.host_match_len(tokens)
        if not host:
            return
        cached = self.cache.match_len(tokens)
        obs.reqtrace.record("prefix_match", req.tid, req.request_id,
                            cached_tokens=cached, host_tokens=host,
                            probe=cached)
        with Span("serving.promote", cat="promote") as ev:
            promo = self.cache.ensure_promoted(tokens)
            ev.args = {"request_id": req.request_id,
                       "host_tokens": host,
                       "promoted": 0 if promo is None
                       else promo["promoted_blocks"],
                       "outcomes": [] if promo is None
                       else promo["outcomes"]}
        record_promotion_events(req.tid, req.request_id, promo)

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
                obs.reqtrace.record("finish", req.tid, request_id,
                                    reason="cancelled")
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
            obs.reqtrace.record("finish", victim.tid, victim.request_id,
                                reason="shed")
            return victim.request_id

    def oldest_waiting_arrival(self) -> Optional[int]:
        with self._lock:
            return self.scheduler.oldest_waiting_arrival()

    def waiting_by_tenant(self) -> dict:
        """Per-tenant queue depth."""
        with self._lock:
            return self.scheduler.waiting_by_tenant()

    def load_info(self) -> dict:
        """Host-side load snapshot the ReplicaSet balances on: waiting,
        block_demand and prefill_cost (Scheduler.backlog), free_blocks
        and running. free_blocks minus block_demand is the effective
        headroom."""
        with self._lock:
            info = self.scheduler.backlog()
            info["free_blocks"] = self.cache.num_free()
            info["running"] = self.scheduler.num_running()
            return info

    # ------------------------------------------- block migration surface
    # (migration.py) All of it runs at step boundaries, through the owning
    # replica's lock, where every reserved cache slot holds written KV.

    def migratable_requests(self, decode_only: bool = True) -> List[str]:
        """Request ids safe to export at this step boundary: RUNNING and
        unfinished. `decode_only=True` (handoff, rebalance) keeps only
        requests past prefill; `decode_only=False` (drain) also takes
        mid-prefill rows, whose committed prefix migrates and finishes
        prefilling at the destination."""
        with self._lock:
            out = []
            for req in self.scheduler.running_requests():
                if req.finished:
                    continue
                if decode_only and req.pf_target \
                        and req.prefill_pos < req.pf_target:
                    continue
                out.append(req.request_id)
            return out

    def export_request(self, request_id: str) -> dict:
        """Snapshot one RUNNING request for migration: its record
        (prompt, params, token log, FCFS ticket, deadline clock, prefill
        progress, trace id), its (model, revision) key and its KV payload
        (PagedKVCache.export_blocks, a copy: a failed migration just
        keeps running here). Sampling needs no extra state: the chunk's
        draws are a function of (seed, tokens generated), which the
        snapshot carries."""
        with self._lock:
            req = self._requests[request_id]
            if req.state != RequestState.RUNNING:
                raise ValueError(
                    f"export_request: {request_id!r} is {req.state}, "
                    f"not running")
            payload, num_tokens = self.cache.export_blocks(request_id)
            if req.pf_target and req.prefill_pos < req.pf_target:
                valid = req.prefill_pos
            else:
                valid = len(req.prompt_ids) \
                    + max(0, len(req.output_ids) - 1)
            if num_tokens != valid:
                raise ValueError(
                    f"export_request: {request_id!r} cache length "
                    f"{num_tokens} != written KV {valid}: not at a clean "
                    f"step boundary")
            return {
                "request_id": request_id,
                "model": self.config.model,
                "revision": self.config.revision,
                "prompt_ids": np.array(req.prompt_ids, np.int32),
                "params": req.params,
                "arrival": req.arrival,
                "arrival_time": req.arrival_time,
                "first_token_time": req.first_token_time,
                "last_token_time": req.last_token_time,
                "output_ids": list(req.output_ids),
                "pf_target": req.pf_target,
                "prefill_pos": req.prefill_pos,
                "trace_id": req.trace_id,
                "payload": payload,
                "num_tokens": num_tokens,
                "blocks": len(self.cache.block_table(request_id)),
                "bytes": self.cache.payload_bytes(payload),
            }

    def admit_migrated(self, snap: dict) -> str:
        """Destination half of a migration: import the payload into fresh
        private blocks, register its written prefix in this engine's trie
        and adopt the request straight into the running set (no
        re-prefill; FCFS ticket and deadline clock kept). Raises
        ValueError for a payload keyed to other weights and
        CacheExhausted, with no side effects, when the pool or the
        sequence slots cannot hold it. Returns this engine's obs
        label."""
        rid = snap["request_id"]
        key = (snap.get("model", self.config.model),
               snap.get("revision", self.config.revision))
        if key != (self.config.model, self.config.revision):
            raise ValueError(
                f"admit_migrated: {rid!r} payload is keyed {key} but this "
                f"engine serves {(self.config.model, self.config.revision)}"
                f": cross-revision KV refused")
        with self._lock:
            old = self._requests.get(rid)
            if old is not None and not old.finished:
                raise ValueError(f"admit_migrated: {rid!r} already live "
                                 f"here")
            req = Request(request_id=rid, prompt_ids=snap["prompt_ids"],
                          params=snap["params"],
                          arrival_time=snap["arrival_time"])
            req.arrival = snap["arrival"]
            req.trace_id = snap["trace_id"]
            req.output_ids = list(snap["output_ids"])
            req.pf_target = snap["pf_target"]
            req.prefill_pos = snap["prefill_pos"]
            req.first_token_time = snap["first_token_time"]
            req.last_token_time = snap["last_token_time"]
            worst = len(req.prompt_ids) + req.params.max_tokens
            if self.cache.blocks_needed(worst) > self.cache.num_blocks:
                raise ValueError(
                    f"admit_migrated: {rid!r} can never fit this pool "
                    f"({self.cache.blocks_needed(worst)} blocks at its "
                    f"longest vs {self.cache.num_blocks} total)")
            # the decode packing is max_num_seqs rows: sequence slots
            # exhaust with the same clean-abort signal as blocks
            live = sum(1 for r in self.scheduler.running if not r.finished)
            if live >= self.config.max_num_seqs:
                raise CacheExhausted(rid, 1, 0, self.config.max_num_seqs,
                                     what="sequence slot")
            self.cache.import_blocks(rid, snap["payload"],
                                     snap["num_tokens"])
            self.scheduler.adopt_running(req)
            if self.cache.prefix_index is not None and snap["num_tokens"]:
                self.cache.register_prefix(
                    rid, req.all_token_ids()[:snap["num_tokens"]])
            self._requests[rid] = req
            self._rngs[rid] = np.random.RandomState(
                req.params.seed & 0x7FFFFFFF)
            return self.stats.label

    def release_migrated(self, request_id: str) -> None:
        """Source half, after the destination committed: detach the
        request (MIGRATED, terminal here, no finish output) and free its
        blocks through the completion path."""
        with self._lock:
            req = self._requests[request_id]
            if req.state != RequestState.RUNNING:
                raise ValueError(
                    f"release_migrated: {request_id!r} is {req.state}, "
                    f"not running")
            self.scheduler.release_running(req)
            self._rngs.pop(request_id, None)

    def abort_migrated(self, request_id: str) -> None:
        """Destination rollback of a migration that failed after
        admit_migrated: drop the adopted request and free its imported
        blocks."""
        with self._lock:
            req = self._requests.pop(request_id, None)
            self._rngs.pop(request_id, None)
            if req is not None and req.state == RequestState.RUNNING:
                self.scheduler.abort_adopted(req)

    def release_waiting(self, request_id: str) -> Optional[Request]:
        """Drain evacuation of queued work: pull a waiting request out
        without a terminal output (the router re-dispatches it from its
        token log). Returns it, or None when it is not waiting."""
        with self._lock:
            req = self.scheduler.remove_waiting(request_id)
            if req is not None:
                self._rngs.pop(request_id, None)
            return req

    # --------------------------------------------------- peer prefix fetch
    def prefix_probe(self, prompt_ids) -> int:
        """Leading tokens of `prompt_ids` this engine could serve from its
        prefix cache, both tiers (device match + promotable host run)."""
        with self._lock:
            toks = np.asarray(prompt_ids, np.int32).reshape(-1)
            return self.cache.match_len(toks) \
                + self.cache.host_match_len(toks)

    def export_prefix(self, prompt_ids) -> Optional[dict]:
        """Donor half of a peer prefix fetch: the longest cached
        full-block prefix of `prompt_ids` (both tiers, digests included),
        keyed by this engine's (model, revision). None when nothing
        matches."""
        with self._lock:
            snap = self.cache.export_prefix(
                np.asarray(prompt_ids, np.int32).reshape(-1))
            if snap is not None:
                snap["model"] = self.config.model
                snap["revision"] = self.config.revision
            return snap

    def admit_prefix(self, prompt_ids, blocks, model: str = None,
                     revision: str = None) -> int:
        """Receiver half: verify and install a peer's prefix snapshot as
        cached (evictable) blocks. ValueError on a digest mismatch or a
        payload keyed to other weights, CacheExhausted when the pool
        cannot hold it; nothing is mutated in either case."""
        key = (self.config.model if model is None else model,
               self.config.revision if revision is None else revision)
        if key != (self.config.model, self.config.revision):
            raise ValueError(
                f"admit_prefix: payload keyed {key} but this engine "
                f"serves {(self.config.model, self.config.revision)}: "
                f"cross-revision prefix refused")
        with self._lock:
            return self.cache.admit_prefix(
                np.asarray(prompt_ids, np.int32).reshape(-1), blocks)

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
        """Record one sampled token, handle completion, stream it out.
        TTFT is observed here, once per request."""
        now = time.perf_counter()
        if req.first_token_time is None:
            req.first_token_time = now
            self.stats.observe_ttft(now - req.arrival_time)
            obs.reqtrace.record("first_token", req.tid, req.request_id,
                                ttft_s=now - req.arrival_time,
                                **self._rev_tag)
        else:
            self.stats.observe_token_gap(now - req.last_token_time)
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
            self.stats.observe_latency(now - req.arrival_time)
            obs.reqtrace.record("finish", req.tid, req.request_id,
                                reason=reason, tokens=len(req.output_ids),
                                **self._rev_tag)
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
        obs.reqtrace.record("finish", req.tid, req.request_id,
                            reason=reason, tokens=len(req.output_ids),
                            **self._rev_tag)

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
            obs.reqtrace.record("finish", req.tid, req.request_id,
                                reason="timeout", **self._rev_tag)
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

    def _quarantine(self, req: Request, outs: List[RequestOutput],
                    why: str) -> None:
        """One poisoned or wedged request costs one request: 'error'
        terminal, blocks scrubbed (NaN survives the attention mask) and
        freed. The flight-recorder dump of its timeline is queued and
        written after step() releases the lock."""
        self.stats.errors += 1
        obs.reqtrace.record("quarantine", req.tid, req.request_id,
                            why=why, engine=self.stats.label)
        self._finish_abnormal(req, RequestState.FINISHED_ERROR, "error",
                              outs, scrub=True)
        self._flights.append((
            "quarantine", [req.tid],
            {"why": why, "engine": self.stats.label,
             "request_id": req.request_id}))

    def _recover(self, decode: List[Request], offenders: List[Request],
                 outs: List[RequestOutput], why: str) -> None:
        """A chunk that went bad emitted nothing: quarantine the
        offenders and requeue every survivor (scrub-freed) for re-prefill
        from its token log. Sampling depends only on request progress,
        so the survivors' replayed streams are unchanged."""
        self.stats.recoveries += 1
        for req in offenders:
            self._quarantine(req, outs, why)
        for req in decode:
            if req not in offenders:
                self.scheduler.requeue_for_recovery(req)
                self.stats.rebuilt += 1

    # -------------------------------------------------------------- step
    def step(self) -> List[RequestOutput]:
        """One engine iteration: expire overdue requests, schedule,
        prefill admitted requests, decode every running sequence for one
        chunk, stream the tokens, under the non-finite guard and the
        watchdog. Flight dumps a quarantine queued are written after the
        lock is released, so a slow disk never stalls intake."""
        heartbeat()  # no-op when unsupervised
        with self._lock:
            outs = self._step_locked()
            flights, self._flights = self._flights, []
        for reason, ids, extra in flights:
            obs.reqtrace.maybe_flight(reason, ids, extra=extra)
        return outs

    def _step_locked(self) -> List[RequestOutput]:
        outs: List[RequestOutput] = list(self._pending_outputs)
        self._pending_outputs.clear()
        self.stats.steps += 1
        step_no = self.stats.steps
        self._step_start = time.perf_counter()
        with Span("serving.engine_step", cat="serving") as step_ev:
            self.faults.corrupt_cache(step_no, self.cache)
            self.faults.corrupt_host_block(step_no, self.cache)
            self.cache.arm_tier_faults(self.faults, step_no)
            self._expire_and_abort(outs)
            t0 = time.perf_counter()
            with Span("serving.schedule", cat="schedule") as ev:
                batch = self.scheduler.schedule()
                ev.args = {"prefill": len(batch.prefill),
                           "decode": len(batch.decode),
                           "preempted": len(batch.preempted),
                           "waiting": self.scheduler.num_waiting(),
                           "free_blocks": self.cache.num_free()}
            self.stats.preemptions += len(batch.preempted)
            self.stats.time_schedule += time.perf_counter() - t0

            prefill_spend = 0
            for req in batch.prefill:
                t0 = time.perf_counter()
                tokens = req.all_token_ids()
                with Span("serving.prefill", cat="prefill") as ev:
                    ev.args = {"request_id": req.request_id,
                               "tokens": int(tokens.size)}
                    try:
                        logits = self._prefill(req, tokens)
                    except Exception as e:   # the reference's quarantine
                        self._quarantine(req, outs, f"prefill raised: {e}")
                        continue
                self.stats.prefill_tokens += int(tokens.size)
                prefill_spend += int(tokens.size)
                self.stats.time_prefill += time.perf_counter() - t0
                logits = self.faults.poison_logits(step_no, logits)
                if any_not_finite_host(logits):
                    self._quarantine(req, outs,
                                     "non-finite prefill logits")
                    continue
                obs.reqtrace.record("prefill", req.tid, req.request_id,
                                    tokens=int(tokens.size))
                self._emit(req, self._sample(req, logits), outs)
                if not req.finished and self._wedged():
                    self.stats.watchdog_trips += 1
                    self._quarantine(req, outs, "wedged prefill")

            # requests finished at prefill released their blocks before
            # the decode chunk packs its tables
            decode = [r for r in batch.decode if not r.finished]
            if decode:
                # where each row writes: blocks only that row holds, or
                # the step stops here (never inside the quarantine path)
                writes = [self.cache.write_blocks(r.request_id, r.slot[2])
                          for r in decode]
                t0 = time.perf_counter()
                k = self.config.decode_chunk_size
                with Span("serving.decode", cat="decode") as ev:
                    ev.args = {"num_seqs": len(decode), "chunk": k}
                    self.faults.stall(step_no)
                    try:
                        toks, bad = self._decode_chunk(decode, k, writes)
                    except Exception as e:   # the reference's recovery
                        toks = None
                        self._recover(decode, [decode[0]], outs,
                                      f"decode raised: {e}")
                dt = time.perf_counter() - t0
                self.stats.time_decode += dt
                self.stats.observe_decode_chunk(dt)
                if toks is not None:
                    bad = self.faults.poison_chunk(step_no, bad)
                    if bad.any():
                        self._recover(
                            decode,
                            [r for i, r in enumerate(decode) if bad[i]],
                            outs, "non-finite decode logits in chunk")
                    elif self._wedged():
                        # a wedged batched chunk cannot be attributed:
                        # the head is quarantined, the rest rebuilt
                        self.stats.watchdog_trips += 1
                        self._recover(decode, [decode[0]], outs,
                                      "wedged decode chunk (watchdog)")
                    else:
                        # step-major drain: row j of toks is trip j, -1
                        # marks a frozen row; _emit re-derives eos and
                        # max_tokens
                        emitted: Dict[str, int] = {}
                        for j in range(toks.shape[0]):
                            for i, req in enumerate(decode):
                                t = int(toks[j, i])
                                if t >= 0 and not req.finished:
                                    self._emit(req, t, outs)
                                    emitted[req.request_id] = \
                                        emitted.get(req.request_id, 0) + 1
                        for req in decode:
                            n_emit = emitted.get(req.request_id, 0)
                            if n_emit:
                                obs.reqtrace.record(
                                    "decode_chunk", req.tid,
                                    req.request_id, n=n_emit,
                                    total=len(req.output_ids),
                                    finished=req.finished,
                                    **self._rev_tag)
            step_ev.args = {"step": step_no, "outputs": len(outs),
                            "errors": self.stats.errors,
                            "expired": self.stats.expired,
                            "shed": self.stats.shed,
                            "recoveries": self.stats.recoveries}
        # per-step telemetry, all from host values in hand
        step_dt = time.perf_counter() - self._step_start
        self.stats.observe_step(step_dt)
        # the measured service rate of the deadline early reject
        self.scheduler.note_step_seconds(step_dt)
        self.stats.set_prefill_spend(prefill_spend)
        if self.stats.generated_tokens:
            self.stats.set_syncs_per_token(
                self.stats.host_syncs("decode")
                / self.stats.generated_tokens)
        self.stats.set_step_gauges(
            running=self.scheduler.num_running(),
            waiting=self.scheduler.num_waiting(),
            blocks_used=self.cache.num_used(),
            blocks_free=self.cache.num_free())
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
        self.stats.inc_host_sync("prefill")
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
        self.stats.inc_host_sync("decode")
        live = len(reqs)
        self.stats.set_padding_waste(0.0 if ragged else (n - live) / n)
        if fed:
            self.stats.inc_prefill_chunks(len(fed))
        bad = fetched[k + 1, :live].astype(bool)
        if not bad.any():
            for req, f in fed:
                req.prefill_pos += f
                obs.reqtrace.record(
                    "prefill_chunk", req.tid, req.request_id, fed=f,
                    pos=req.prefill_pos, target=req.pf_target)
                if self.cache.prefix_index is not None:
                    self.cache.register_prefix(
                        req.request_id,
                        req.all_token_ids()[:req.prefill_pos])
        return fetched[:k, :live], bad

    # ------------------------------------------------------- convenience
    def run(self, max_steps: int = None) -> Dict[str, np.ndarray]:
        """Drive every queued request to completion; returns
        {request_id: np.ndarray of generated token ids} (cancelled
        requests excluded, and migrated-out ones, whose stream finishes
        on another engine)."""
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
                    if r.state not in (RequestState.CANCELLED,
                                       RequestState.MIGRATED)}


class ServingPredictor:
    """Paddle predictor facade over LLMEngine, which
    inference.create_predictor returns once Config.enable_llm_engine was
    called.

    IO: input 'input_ids' [B, T] (right-padded) and optional
    'prompt_lens' [B]; output 'sequences' [B, T_out], each row its
    prompt and then its generated tokens, right-padded with the pad
    token (eos when set, else 0), int64. The engine runs on CUDA unless
    the Config asked for the CPU (Config.disable_gpu()). Each run beats
    the elastic heartbeat."""

    def __init__(self, config):
        model = getattr(config, "_llm_model", None)
        if model is None:
            raise ValueError(
                "Config.enable_llm_engine(model=...) must receive the "
                "model object; serving runs live parameters, not a "
                "serialized artifact")
        opts = dict(getattr(config, "_llm_options", {}) or {})
        self._sampling = SamplingParams(**{
            k: opts.pop(k) for k in list(opts)
            if k in SamplingParams.__dataclass_fields__})
        device = f"cuda:{config.gpu_device_id()}" if config.use_gpu() \
            else "cpu"
        self.engine = LLMEngine.from_model(model, EngineConfig(**opts),
                                           device=device)
        from .. import Tensor
        self._inputs = {n: Tensor(n)
                        for n in ("input_ids", "prompt_lens")}
        self._outputs = {}

    def get_input_names(self):
        return ["input_ids", "prompt_lens"]

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_names(self):
        return ["sequences"]

    def get_output_handle(self, name):
        return self._outputs[name]

    def run(self, inputs: Optional[list] = None):
        heartbeat()  # no-op when unsupervised
        if inputs is not None:
            self._inputs["input_ids"].copy_from_cpu(
                np.asarray(inputs[0]))
            if len(inputs) > 1:
                self._inputs["prompt_lens"].copy_from_cpu(
                    np.asarray(inputs[1]))
        ids_h = self._inputs["input_ids"]
        if ids_h._arr is None:
            raise RuntimeError("input 'input_ids' not set")
        ids = np.asarray(ids_h._arr)
        lens_h = self._inputs["prompt_lens"]
        lens = (np.asarray(lens_h._arr).astype(int).reshape(-1)
                if lens_h._arr is not None
                else np.full(ids.shape[0], ids.shape[1]))
        rids = [self.engine.add_request(ids[b, :lens[b]], self._sampling)
                for b in range(ids.shape[0])]
        results = self.engine.run()
        pad = self._sampling.eos_token_id
        pad = 0 if pad is None else int(pad)
        width = max(int(lens[b]) + len(results[r].tolist())
                    for b, r in enumerate(rids))
        out = np.full((ids.shape[0], width), pad, np.int64)
        for b, rid in enumerate(rids):
            seq = np.concatenate([ids[b, :lens[b]].astype(np.int64),
                                  results[rid]])
            out[b, :seq.size] = seq
        from .. import Tensor
        t = Tensor("sequences")
        t._arr = out
        self._outputs = {"sequences": t}
        if inputs is not None:
            return [out]
        return None

    # Predictor-surface parity no-ops
    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass
