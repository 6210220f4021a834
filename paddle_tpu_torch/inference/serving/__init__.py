"""Continuous-batching LLM serving over a paged KV cache (port of
paddle_tpu/inference/serving/: the single-engine core, the radix-trie
prefix cache with copy-on-write blocks, the host-RAM KV tier, int8 KV
blocks, deadlines, the step watchdog and fault injection)."""
from .attention import (PACK_COLS, fused_decode_chunk, gather_block_kv,
                        pack_f32, paged_decode_step)
from .engine import EngineConfig, EngineStats, LLMEngine, RequestOutput
from .host_tier import HostTierStore
from .paged_cache import CacheExhausted, PagedKVCache
from .prefix_cache import PrefixCacheIndex, PrefixNode
from .scheduler import (EngineOverloaded, Request, RequestState,
                        SamplingParams, ScheduledBatch, Scheduler,
                        SchedulerConfig)

__all__ = ["PACK_COLS", "fused_decode_chunk", "gather_block_kv", "pack_f32",
           "paged_decode_step", "EngineConfig", "EngineStats", "LLMEngine",
           "RequestOutput", "HostTierStore", "CacheExhausted",
           "PagedKVCache", "PrefixCacheIndex", "PrefixNode",
           "EngineOverloaded", "Request", "RequestState", "SamplingParams",
           "ScheduledBatch", "Scheduler", "SchedulerConfig"]
