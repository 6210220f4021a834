"""Continuous-batching LLM serving over a paged KV cache (port of
paddle_tpu/inference/serving/: the single engine with the radix-trie
prefix cache and copy-on-write blocks, the host-RAM KV tier, int8 KV
blocks, deadlines, the step watchdog and fault injection; multi-tenant
WFQ admission priced by the prefill cost model, quotas and
share-weighted prefix eviction; the registry-backed EngineStats, request
tracing and the ServingPredictor facade)."""
from .attention import (PACK_COLS, fused_decode_chunk, gather_block_kv,
                        pack_f32, paged_decode_step)
from .engine import (EngineConfig, EngineStats, LLMEngine, RequestOutput,
                     ServingPredictor)
from .host_tier import HostTierStore
from .paged_cache import CacheExhausted, PagedKVCache
from .prefix_cache import PrefixCacheIndex, PrefixNode
from .scheduler import (EngineOverloaded, Request, RequestState,
                        SamplingParams, ScheduledBatch, Scheduler,
                        SchedulerConfig)
from .tenancy import TenantConfig, TenantQuotaExceeded, TenantRegistry

__all__ = ["PACK_COLS", "fused_decode_chunk", "gather_block_kv", "pack_f32",
           "paged_decode_step", "EngineConfig", "EngineStats", "LLMEngine",
           "RequestOutput", "ServingPredictor", "HostTierStore",
           "CacheExhausted", "PagedKVCache", "PrefixCacheIndex",
           "PrefixNode", "EngineOverloaded", "Request", "RequestState",
           "SamplingParams", "ScheduledBatch", "Scheduler",
           "SchedulerConfig", "TenantConfig", "TenantQuotaExceeded",
           "TenantRegistry"]
