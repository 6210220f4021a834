"""The host-RAM KV tier of the port (paddle_tpu_torch/inference/serving/
host_tier.py and PagedKVCache's demote/promote paths) against the JAX
package, on the CPU.

- engine: a sequential templated workload whose revisits find their
  templates demoted to host RAM. Tokens, prefix_stats() (demotions,
  promotion outcomes, hits), the engine's tier readings and
  check_integrity() equal the JAX engine's, in f32 and in int8 pools;
  the tokens also equal the device-hit engine's and the cache-off
  engine's, greedy and seeded-stochastic;
- faults: kill_promotion (outcome "timeout", the entry stays on host),
  kill_demotion (plain eviction instead) and corrupt_host_block (outcome
  "integrity", the subtree dropped) degrade as in the reference: the
  same counters and tokens as the JAX engine under the same spec;
- cache: a demoted chain's digests equal the JAX cache's; promotion is
  bitwise, a deadline leaves entries retryable, a torn host copy fails
  its sha256, and a scrub taint poisons host copies.
Tokens and counters are compared exactly.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
from paddle_tpu.inference.serving import EngineConfig as JEngineConfig
from paddle_tpu.inference.serving import LLMEngine as JLLMEngine
from paddle_tpu.inference.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.inference.serving import SamplingParams as JSamplingParams
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.testing.faults import ServingFaultInjector as JFaults

from paddle_tpu_torch.inference.serving import (EngineConfig, LLMEngine,
                                                PagedKVCache, SamplingParams)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.testing.faults import ServingFaultInjector

VOCAB = 97
GEOM_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**GEOM_KW))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**GEOM_KW), params,
                                   device="cpu")


def _tiering_prompts(seed=0, suffix=4):
    """4 templates of 24 tokens revisited after enough churn that a
    20-block pool demotes the early ones (tests/test_serving_tiered.py's
    workload), each with a unique suffix of `suffix` tokens."""
    rng = np.random.RandomState(seed)
    tpls = [rng.randint(1, VOCAB, (24,), dtype=np.int32) for _ in range(4)]
    return [np.concatenate([tpls[t], rng.randint(1, VOCAB, (suffix,),
                                                 dtype=np.int32)])
            for t in (0, 1, 2, 3, 0, 1)]


def _config(**kw):
    return dict(dict(block_size=4, num_blocks=20, max_num_seqs=4,
                     decode_chunk_size=4, enable_prefix_cache=True,
                     host_tier_blocks=64), **kw)


def _run(engine, sp_cls, prompts, max_tokens=6, **sp):
    """One request at a time, drained before the next arrives."""
    out = []
    for i, p in enumerate(prompts):
        kw = dict(sp, seed=100 + i) if sp else {}
        r = engine.add_request(p, sp_cls(max_tokens=max_tokens, **kw))
        while engine.has_unfinished():
            engine.step()
        out.append(list(engine.get_request(r).output_ids))
    return out


def _pair(models, spec="", **kw):
    jm, tm = models
    te = LLMEngine.from_model(tm, EngineConfig(**_config(**kw)),
                              ServingFaultInjector(spec), device="cpu")
    je = JLLMEngine.from_model(jm, JEngineConfig(**_config(**kw)),
                               faults=JFaults(spec))
    return te, je


def _assert_same(te, je, tout, jout):
    assert tout == jout
    tps, jps = te.cache.prefix_stats(), je.cache.prefix_stats()
    assert tps == jps
    assert te.stats.tier_demotions() == tps["tier_demotions"]
    for o in ("hit", "timeout", "integrity", "raced"):
        assert te.stats.promotion_counter(o) == tps[f"promote_{o}"]
    assert te.cache.check_integrity() == je.cache.check_integrity()
    assert te.cache.stats() == je.cache.stats()
    assert te.cache.host_tier.stats() == je.cache.host_tier.stats()
    return tps


def _audit_clean(cache):
    cache.check_integrity()
    cache.clear_prefix_cache()
    r = cache.check_integrity()
    assert r["leaked"] == r["host_leaked"] == r["host_orphans"] == 0
    s = cache.stats()
    assert s["blocks_allocated"] == s["blocks_freed"]
    assert len(cache.host_tier) == 0


# ------------------------------------------------------------ engine
@pytest.mark.parametrize("kvdt", ["float32", "int8"])
def test_demote_promote_matches_jax(models, kvdt):
    te, je = _pair(models, kv_cache_dtype=kvdt)
    prompts = _tiering_prompts()
    ps = _assert_same(te, je, _run(te, SamplingParams, prompts),
                      _run(je, JSamplingParams, prompts))
    assert ps["tier_demotions"] >= 1 and ps["promote_hit"] >= 1, ps
    q = te.stats.promote_quantile(0.5)
    assert q == q and q >= 0.0                   # measured, not NaN
    _audit_clean(te.cache)


def test_tiered_tokens_equal_device_hits_and_cache_off(models):
    _, tm = models
    prompts = _tiering_prompts(seed=1)
    outs = []
    for kw in (dict(), dict(num_blocks=64),
               dict(enable_prefix_cache=False, host_tier_blocks=0)):
        eng = LLMEngine.from_model(tm, EngineConfig(**_config(**kw)),
                                   device="cpu")
        outs.append(_run(eng, SamplingParams, prompts))
        if not kw:
            ps = eng.cache.prefix_stats()
            assert ps["tier_demotions"] >= 1 and ps["promote_hit"] >= 1
    assert outs[0] == outs[1] == outs[2]


def test_tiered_stochastic_equals_cache_off(models):
    """All engines on the chunked path (prefill_chunk_threshold=0), so
    every draw is in-chunk: the tier round trip changes no draw."""
    _, tm = models
    prompts = _tiering_prompts(seed=2)
    outs = []
    for kw in (dict(), dict(enable_prefix_cache=False, host_tier_blocks=0)):
        eng = LLMEngine.from_model(tm, EngineConfig(**_config(
            prefill_chunk_threshold=0, **kw)), device="cpu")
        outs.append(_run(eng, SamplingParams, prompts, temperature=0.8,
                         top_k=20))
        if not kw:
            assert eng.cache.prefix_stats()["promote_hit"] >= 1
    assert outs[0] == outs[1]


@pytest.mark.parametrize("spec,outcome", [
    ("kill_promotion@0", "promote_timeout"),
    ("kill_demotion@0", "evictions"),
    ("corrupt_host_block@0", "promote_integrity")])
def test_tier_faults_degrade_as_reference(models, spec, outcome):
    """corrupt_host_block tears the LRU-oldest host entry, which is only
    ever promoted when it is a template block: its requests carry a
    one-token suffix and two new tokens, so every full block they write
    is a template block."""
    te, je = _pair(models, spec)
    corrupt = spec.startswith("corrupt")
    prompts = _tiering_prompts(seed=3, suffix=1 if corrupt else 4)
    n = 2 if corrupt else 6
    tout = _run(te, SamplingParams, prompts, n)
    ps = _assert_same(te, je, tout, _run(je, JSamplingParams, prompts, n))
    assert ps[outcome] >= 1, ps
    assert te.faults.fired_log == je.faults.fired_log
    _, tm = models
    off = LLMEngine.from_model(tm, EngineConfig(**_config(
        enable_prefix_cache=False, host_tier_blocks=0)), device="cpu")
    assert _run(off, SamplingParams, prompts, n) == tout
    _audit_clean(te.cache)


# ------------------------------------------------------------- cache
def _demoted_chain(cls, promote_timeout_s=None, **dev):
    """A cache whose 4-block template chain was demoted whole, each block
    holding a recognisable value. Returns (cache, tokens)."""
    cache = cls(1, 1, 2, 8, 4, enable_prefix_cache=True, host_tier_blocks=8,
                promote_timeout_s=promote_timeout_s, **dev)
    ta = np.arange(1, 18, dtype=np.int32)
    assert cache.allocate_with_prefix("a", ta) == 0
    cache.reserve_slots("a", len(ta))
    blocks = list(cache.block_table("a")[:4])
    pools = [[np.asarray(p).copy() for p in pair] for pair in cache.pools]
    for j, b in enumerate(blocks):
        pools[0][0][b] = float(j + 1)
        pools[0][1][b] = -float(j + 1)
    if cls is PagedKVCache:
        cache.pools = tuple(tuple(torch.from_numpy(p) for p in pair)
                            for pair in pools)
    else:
        cache.pools = tuple(tuple(jnp.asarray(p) for p in pair)
                            for pair in pools)
    cache.free("a", cache_tokens=ta)
    cache.allocate("f", 24)                      # demotes 2
    cache.free("f")
    cache.allocate("g", 32)                      # demotes 2 more
    cache.free("g")
    assert cache.match_len(ta) == 0 and cache.host_match_len(ta) == 16
    assert cache.tier_demotions == 4
    return cache, ta


def test_demoted_chain_digests_match_jax():
    t, ta = _demoted_chain(PagedKVCache, device="cpu")
    j, _ = _demoted_chain(JPagedKVCache)
    assert t.host_tier.ids() == j.host_tier.ids()
    for hid in t.host_tier.ids():
        assert t.host_tier.get(hid)["digest"] == j.host_tier.get(hid)["digest"]
    assert t.ensure_promoted(ta)["outcomes"] == \
        j.ensure_promoted(ta)["outcomes"] == ["hit"] * 4
    assert t.check_integrity() == j.check_integrity()


def test_cache_promote_roundtrip_is_bitwise():
    cache, ta = _demoted_chain(PagedKVCache, device="cpu")
    promo = cache.ensure_promoted(ta)
    assert promo["outcomes"] == ["hit"] * 4 and promo["promoted_blocks"] == 4
    assert cache.match_len(ta) == 16 and len(cache.host_tier) == 0
    path, _ = cache.prefix_index.match([int(t) for t in ta[:16]])
    kp, vp = cache.pools[0]
    for j, node in enumerate(path):
        assert bool(torch.all(kp[node.block] == float(j + 1)))
        assert bool(torch.all(vp[node.block] == -float(j + 1)))
    _audit_clean(cache)


def test_cache_promote_timeout_is_retryable():
    cache, ta = _demoted_chain(PagedKVCache, promote_timeout_s=0.0,
                               device="cpu")
    promo = cache.ensure_promoted(ta)
    assert promo["outcomes"] == ["timeout"] and promo["promoted_blocks"] == 0
    assert cache.host_match_len(ta) == 16
    cache.promote_timeout_s = None
    assert cache.ensure_promoted(ta)["outcomes"] == ["hit"] * 4
    assert cache.match_len(ta) == 16
    _audit_clean(cache)


def test_cache_corrupt_host_block_fails_integrity_and_drops():
    cache, ta = _demoted_chain(PagedKVCache, device="cpu")
    assert cache.host_tier.corrupt_oldest()
    promo = cache.ensure_promoted(ta)
    assert promo["outcomes"] == ["hit"] * 3 + ["integrity"]
    assert cache.match_len(ta) == 12 and cache.host_match_len(ta) == 0
    assert len(cache.host_tier) == 0
    _audit_clean(cache)


def test_taint_poisons_host_copy_and_never_spills():
    cache = PagedKVCache(1, 1, 2, 8, 4, enable_prefix_cache=True,
                         host_tier_blocks=8, device="cpu")
    ta = np.arange(1, 18, dtype=np.int32)
    cache.allocate_with_prefix("a", ta)
    cache.reserve_slots("a", len(ta))
    blocks = list(cache.block_table("a")[:4])
    cache.free("a", cache_tokens=ta)
    cache.allocate("f", 24)
    cache.free("f")
    assert cache.tier_demotions == 2
    dev = blocks[:2]
    for kp, vp in cache.pools:
        kp[dev] = 1.0
        vp[dev] = 1.0
    tb = np.concatenate([ta[:8], [50, 51]]).astype(np.int32)
    tc = np.concatenate([ta[:8], [60, 61]]).astype(np.int32)
    assert cache.allocate_with_prefix("b", tb) == 8
    cache.reserve_slots("b", 2)
    assert cache.allocate_with_prefix("c", tc) == 8
    cache.reserve_slots("c", 2)
    cache.free("b", scrub=True)
    hs = cache.host_tier.stats()
    assert hs["poisoned"] == 2 and len(cache.host_tier) == 0
    assert hs["puts"] == 2
    assert cache.match_len(ta) == 0 and cache.host_match_len(ta) == 0
    assert bool(torch.all(cache.pools[0][0][dev] == 1.0))
    cache.free("c")
    assert bool(torch.all(cache.pools[0][0][dev] == 0.0))
    r = cache.check_integrity()
    assert r["leaked"] == 0 and r["stale_tainted"] == 0
