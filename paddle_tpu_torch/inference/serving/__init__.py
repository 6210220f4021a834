"""Continuous-batching LLM serving over a paged KV cache (port of
paddle_tpu/inference/serving/, slice 1: the single-engine core)."""
from .attention import (PACK_COLS, fused_decode_chunk, gather_block_kv,
                        pack_f32, paged_decode_step)
from .engine import EngineConfig, EngineStats, LLMEngine, RequestOutput
from .paged_cache import CacheExhausted, PagedKVCache
from .scheduler import (EngineOverloaded, Request, RequestState,
                        SamplingParams, ScheduledBatch, Scheduler,
                        SchedulerConfig)

__all__ = ["PACK_COLS", "fused_decode_chunk", "gather_block_kv", "pack_f32",
           "paged_decode_step", "EngineConfig", "EngineStats", "LLMEngine",
           "RequestOutput", "CacheExhausted", "PagedKVCache",
           "EngineOverloaded", "Request", "RequestState", "SamplingParams",
           "ScheduledBatch", "Scheduler", "SchedulerConfig"]
