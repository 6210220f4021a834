"""Continuous-batching LLM serving over a paged KV cache (port of
paddle_tpu/inference/serving/: the single engine with the radix-trie
prefix cache and copy-on-write blocks, the host-RAM KV tier, int8 KV
blocks, deadlines, the step watchdog and fault injection; multi-tenant
WFQ admission priced by the prefill cost model, quotas and
share-weighted prefix eviction; the registry-backed EngineStats, request
tracing and the ServingPredictor facade; and the fleet: supervised
engine replicas behind the ReplicaSet router with failover, live
KV-block migration for disaggregated prefill/decode, the autoscaler,
and the model registry with rolling weight deploys)."""
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
from .replica import EngineReplica, ReplicaCrashed, ReplicaState
from .migration import BlockMigration, MIGRATION_REASONS
from .router import ReplicaSet, RouterConfig, RouterRequest
from .tenancy import TenantConfig, TenantQuotaExceeded, TenantRegistry
from .autoscaler import Autoscaler, AutoscalerConfig, AutoscalerPolicy
from .deploy import DeployConfig, DeployController, ModelRegistry, Revision

__all__ = ["PACK_COLS", "fused_decode_chunk", "gather_block_kv", "pack_f32",
           "paged_decode_step", "EngineConfig", "EngineStats", "LLMEngine",
           "RequestOutput", "ServingPredictor", "HostTierStore",
           "CacheExhausted", "PagedKVCache", "PrefixCacheIndex",
           "PrefixNode", "EngineOverloaded", "Request", "RequestState",
           "SamplingParams", "ScheduledBatch", "Scheduler",
           "SchedulerConfig", "EngineReplica", "ReplicaCrashed",
           "ReplicaState", "BlockMigration", "MIGRATION_REASONS",
           "ReplicaSet", "RouterConfig", "RouterRequest", "TenantConfig",
           "TenantQuotaExceeded", "TenantRegistry", "Autoscaler",
           "AutoscalerConfig", "AutoscalerPolicy", "DeployConfig",
           "DeployController", "ModelRegistry", "Revision"]
