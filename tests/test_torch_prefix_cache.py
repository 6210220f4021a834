"""Prefix caching in the port (paddle_tpu_torch/inference/serving/
prefix_cache.py and the refcounted PagedKVCache) against the JAX
package, on the CPU.

- the radix trie: the same random sequence of insert / match /
  match_tiered / demote / promote / pop_lru_leaf / lru_demotable /
  remove_subtree on both packages' PrefixCacheIndex gives the same
  answers, audits and stats after every operation;
- the cache: 200 allocate-with-prefix / grow / free (scrubbed or
  registered) lifetimes on both caches give the same cached lengths,
  block tables, audits and stats;
- the engine, on templated traffic with hits, copy-on-write forks,
  eviction pressure, preemption and cancels: greedy tokens,
  prefix_stats() counters and check_integrity() reports equal the JAX
  engine's, and tokens equal dense generate() and the cache-off engine;
- in-place writes and sharing: a row's write range must lie in blocks
  only it holds (PagedKVCache.write_blocks raises otherwise), scrub
  never zeroes a block under another holder, and the fused chunk over
  tables that name the same blocks matches JAX's.
Tokens and counters are compared exactly; pools within 2e-5 (float32,
as test_torch_serving.py).
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
from paddle_tpu.inference.serving import PrefixCacheIndex as JIndex
from paddle_tpu.inference.serving import SamplingParams as JSamplingParams
from paddle_tpu.inference.serving import fused_decode_chunk as jfused
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

import paddle_tpu_torch.models.generation as gen
from paddle_tpu_torch.inference.serving import (
    PACK_COLS, EngineConfig, LLMEngine, PagedKVCache, PrefixCacheIndex,
    SamplingParams, fused_decode_chunk, pack_f32)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig

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


# ------------------------------------------------------------ the trie
def _node_ids(nodes):
    return [(n.block, n.host_id, n.tier) for n in nodes]


def _apply(idx, op, args):
    """One trie operation; returns a comparable answer."""
    if op == "insert":
        return idx.insert(*args)
    if op == "match":
        path, partial = idx.match(*args)
        return _node_ids(path), (None if partial is None
                                 else (partial[0].block, partial[1]))
    if op == "match_tiered":
        dev, host = idx.match_tiered(args[0])
        return _node_ids(dev), _node_ids(host)
    if op == "pop":
        node = idx.pop_lru_leaf(lambda b: b % 3 != 0)
        return None if node is None else node.block
    if op == "demote":
        node = idx.lru_demotable(lambda b: True)
        if node is None:
            return None
        b = node.block
        idx.demote(node, args[0])
        return b
    if op == "promote":
        node = idx.node_of_host(args[0])
        if node is None or (node.parent.key is not None
                            and node.parent.tier != "device"):
            return None
        idx.promote(node, args[1])
        return node.block
    if op == "remove_subtree":
        node = idx.node_of(args[0])
        if node is None:
            return None
        return _node_ids(idx.remove_subtree(node))
    raise ValueError(op)


def test_trie_operations_match_jax():
    rng = np.random.RandomState(0)
    tpls = [rng.randint(1, 9, (12,)).tolist() for _ in range(4)]
    idx, jidx = PrefixCacheIndex(4), JIndex(4)
    next_block, next_host = 0, 0
    for step in range(300):
        toks = tpls[rng.randint(4)][:int(rng.randint(4, 13))] \
            + rng.randint(1, 9, (int(rng.randint(0, 6)),)).tolist()
        op = ["insert", "match", "match_tiered", "pop", "demote", "promote",
              "remove_subtree"][int(rng.choice(7, p=[.3, .25, .1, .1, .1,
                                                     .1, .05]))]
        if op == "insert":
            n = len(toks) // 4
            args = (toks, list(range(next_block, next_block + n)))
            next_block += n
        elif op == "match":
            args = (toks, bool(rng.rand() < 0.5))
        elif op == "match_tiered":
            args = (toks,)
        elif op == "demote":
            args = (next_host,)
            next_host += 1
        elif op == "promote":
            hosts = sorted(jidx.host_ids())
            if not hosts:
                continue
            args = (hosts[int(rng.randint(len(hosts)))], next_block)
            next_block += 1
        elif op == "remove_subtree":
            blocks = sorted(jidx.blocks())
            if not blocks:
                continue
            args = (blocks[int(rng.randint(len(blocks)))],)
        else:
            args = ()
        assert _apply(idx, op, args) == _apply(jidx, op, args), (step, op)
        assert idx.audit() == jidx.audit() == 0
        assert idx.stats() == jidx.stats()
        assert idx.tenant_census() == jidx.tenant_census()
        assert sorted(idx.blocks()) == sorted(jidx.blocks())
    assert idx.clear() == jidx.clear()


def test_lru_demotable_batched_matches_sequential():
    """Batched selection (pending nodes count as demoted) picks the
    victims the one-at-a-time loop would."""
    def build():
        idx = PrefixCacheIndex(2)
        idx.insert([1, 2, 3, 4, 5, 6], [10, 11, 12])
        idx.insert([1, 2, 3, 4, 7, 8], [10, 11, 13])
        idx.insert([9, 9, 8, 8], [14, 15])
        idx.match([9, 9, 8, 8])                  # touch: younger
        return idx
    seq, hid = build(), 0
    order = []
    while (node := seq.lru_demotable(lambda b: True)) is not None:
        order.append(node.block)
        seq.demote(node, hid)
        hid += 1
    bat, pending = build(), []
    while (node := bat.lru_demotable(lambda b: True,
                                     pending=set(pending))) is not None:
        pending.append(node)
    assert [n.block for n in pending] == order


# ----------------------------------------------------------- the cache
def _churn(cache, seed=3):
    """200 lifetimes over a small shared pool (tests/test_serving_
    prefix.py's churn); yields a comparable record after each."""
    rng = np.random.RandomState(seed)
    tpls = [rng.randint(1, 50, (16,)).tolist() for _ in range(5)]
    live = {}
    for i in range(200):
        sid = f"s{i}"
        toks = np.array(tpls[i % 5] + rng.randint(
            1, 50, (int(rng.randint(1, 9)),)).tolist(), dtype=np.int32)
        try:
            got = cache.allocate_with_prefix(sid, toks)
        except Exception as e:                   # CacheExhausted
            yield ("exhausted", type(e).__name__)
            continue
        cache.reserve_slots(sid, len(toks) - got)
        live[sid] = toks
        record = [got, cache.block_table(sid)]
        if len(live) >= 6 or rng.rand() < 0.5:
            victim = list(live)[int(rng.randint(len(live)))]
            vt = live.pop(victim)
            scrub = rng.rand() < 0.3
            record.append(cache.free(victim, scrub=scrub,
                                     cache_tokens=None if scrub else vt))
        if i % 25 == 0:
            record.append(cache.check_integrity())
        yield record
    for sid, vt in live.items():
        cache.free(sid, cache_tokens=vt)
    yield cache.check_integrity(), cache.prefix_stats(), cache.stats()
    cache.clear_prefix_cache()
    yield cache.check_integrity(), cache.stats()


def test_cache_churn_matches_jax():
    t = PagedKVCache(2, 2, 4, 48, 4, enable_prefix_cache=True, device="cpu")
    j = JPagedKVCache(2, 2, 4, 48, 4, enable_prefix_cache=True)
    n = 0
    for a, b in zip(_churn(t), _churn(j)):
        assert a == b, n
        n += 1
    assert n == 202
    s = t.stats()
    assert s["blocks_allocated"] == s["blocks_freed"]
    assert s["free"] == t.num_blocks


def test_scrub_is_refcount_aware():
    cache = PagedKVCache(1, 1, 2, 8, 4, enable_prefix_cache=True,
                         device="cpu")
    tpl = np.arange(1, 9, dtype=np.int32)
    ta, tb, tc = (np.append(tpl, x).astype(np.int32) for x in (50, 60, 70))
    assert cache.allocate_with_prefix("a", ta) == 0
    cache.reserve_slots("a", len(ta))
    blocks = cache.block_table("a")[:2]
    for kp, vp in cache.pools:
        kp[blocks] = 1.0
        vp[blocks] = 1.0
    cache.free("a", cache_tokens=ta)
    assert cache.allocate_with_prefix("b", tb) == 8
    assert cache.allocate_with_prefix("c", tc) == 8
    assert cache.prefix_stats()["shared_blocks"] == 2
    cache.free("b", scrub=True)
    assert bool(torch.all(cache.pools[0][0][blocks] == 1.0))
    assert cache.match_len(tb) == 0
    cache.free("c")
    assert bool(torch.all(cache.pools[0][0][blocks] == 0.0))
    r = cache.check_integrity()
    assert r["leaked"] == 0 and r["stale_tainted"] == 0


def test_write_blocks_refuses_shared_blocks():
    """The pools are written in place: a write range that reaches a
    block another table or the trie holds raises."""
    cache = PagedKVCache(1, 1, 2, 8, 4, enable_prefix_cache=True,
                         device="cpu")
    ta = np.arange(1, 11, dtype=np.int32)
    cache.allocate_with_prefix("a", ta)
    cache.reserve_slots("a", len(ta))
    cache.register_prefix("a", ta[:8])
    assert cache.write_blocks("a", 8) == cache.block_table("a")[2:]
    with pytest.raises(RuntimeError, match="shared"):
        cache.write_blocks("a", 7)               # an indexed block
    tb = np.append(ta[:8], 5).astype(np.int32)
    assert cache.allocate_with_prefix("b", tb) == 8
    cache.reserve_slots("b", 1)
    assert len(cache.write_blocks("b", 8)) == 1
    with pytest.raises(RuntimeError, match="refcount 2"):
        cache.write_blocks("b", 4)               # a's block, attached


def test_engine_refuses_a_chunk_that_writes_a_shared_block(models):
    """A row whose write range reaches a shared block stops the step
    with RuntimeError: it is never turned into a quarantine."""
    _, tm = models
    eng = LLMEngine.from_model(tm, EngineConfig(
        block_size=4, num_blocks=32, max_num_seqs=4, decode_chunk_size=4,
        enable_prefix_cache=True), device="cpu")
    tpl = np.arange(1, 13, dtype=np.int32)
    a = eng.add_request(tpl, SamplingParams(max_tokens=8))
    eng.step()                                   # dense prefill, indexed
    b = eng.add_request(np.append(tpl, 7).astype(np.int32),
                        SamplingParams(max_tokens=8))
    shared = eng.cache.block_table(a)[0]
    real = eng.cache.write_blocks

    def forge(seq_id, pos):
        if seq_id == b:                          # aim b's write at a's
            eng.cache._tables[b][pos // 4] = shared   # first block
        return real(seq_id, pos)
    eng.cache.write_blocks = forge
    with pytest.raises(RuntimeError, match="shared"):
        eng.step()
    assert eng.stats.errors == 0


# ---------------------------------------------------------- the engine
def _templated(rng, n, tpl_len, n_tpl):
    tpls = [rng.randint(1, VOCAB, (tpl_len,), dtype=np.int32)
            for _ in range(n_tpl)]
    return [np.concatenate([tpls[i % n_tpl], rng.randint(
        1, VOCAB, (int(rng.randint(2, 6)),), dtype=np.int32)])
        for i in range(n)]


def _scenario(name):
    """(engine kwargs, list of (arrival step, prompt, max_tokens), cancel
    every k steps or 0)."""
    rng = np.random.RandomState(7)
    if name == "staggered":
        prompts = _templated(rng, 6, 24, 2)
        return {}, [(0 if i < 2 else 6, p, 8)
                    for i, p in enumerate(prompts)], 0
    if name == "cow":
        base = rng.randint(1, VOCAB, (28,), dtype=np.int32)
        div = base.copy()
        div[22:] = (div[22:] + 7) % (VOCAB - 1) + 1
        return {}, [(0, base, 6), (6, div, 6), (14, base, 6)], 0
    if name == "eviction":
        prompts = _templated(rng, 12, 20, 12)
        return dict(num_blocks=28), [(8 * i, p, 4)
                                     for i, p in enumerate(prompts)], 0
    if name == "chunked":
        prompts = _templated(rng, 8, 20, 2)
        return dict(prefill_chunk_threshold=0), \
            [(3 * i, p, 8) for i, p in enumerate(prompts)], 0
    if name == "churn":
        prompts = _templated(rng, 16, 20, 2)
        return dict(num_blocks=16, max_waiting=20), \
            [(i, p, 12) for i, p in enumerate(prompts)], 5
    raise ValueError(name)


def _drive(eng, sp_cls, arrivals, cancel_every):
    rng = np.random.RandomState(4)
    rids, step = [], 0
    pending = list(arrivals)
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= step:
            _, p, mt = pending.pop(0)
            rids.append(eng.add_request(p, sp_cls(max_tokens=mt)))
        if eng.has_unfinished():
            eng.step()
        step += 1
        if cancel_every and step % cancel_every == 0:
            alive = [r for r in rids if not eng.get_request(r).finished]
            if alive:
                eng.cancel(alive[int(rng.randint(len(alive)))])
        assert step <= 800
    return rids


SCENARIOS = ["staggered", "cow", "eviction", "chunked", "churn"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_prefix_cache_matches_jax(models, name):
    jm, tm = models
    kw, arrivals, cancel = _scenario(name)
    cfg = dict(dict(block_size=4, num_blocks=64, max_num_seqs=4,
                    decode_chunk_size=4, enable_prefix_cache=True), **kw)
    te = LLMEngine.from_model(tm, EngineConfig(**cfg), device="cpu")
    je = JLLMEngine.from_model(jm, JEngineConfig(**cfg))
    trids = _drive(te, SamplingParams, arrivals, cancel)
    jrids = _drive(je, JSamplingParams, arrivals, cancel)
    for tr, jr in zip(trids, jrids):
        treq, jreq = te.get_request(tr), je.get_request(jr)
        assert treq.state == jreq.state, tr
        assert treq.output_ids == jreq.output_ids, tr
    tps, jps = te.cache.prefix_stats(), je.cache.prefix_stats()
    assert tps == jps
    for kind in ("hits", "misses", "evictions"):
        assert te.stats.prefix_counter(kind) == tps[kind]
    assert te.cache.check_integrity() == je.cache.check_integrity()
    assert te.cache.stats() == je.cache.stats()
    want = {"staggered": "hits", "cow": "cow_forks", "eviction": "evictions",
            "chunked": "hits", "churn": "hits"}[name]
    assert tps[want] > 0, tps
    if name == "churn":
        assert te.stats.cancelled > 0 and te.stats.preemptions > 0
    te.cache.clear_prefix_cache()
    s = te.cache.stats()
    assert s["blocks_allocated"] == s["blocks_freed"]


@pytest.mark.parametrize("name", ["staggered", "cow", "eviction"])
def test_engine_prefix_cache_matches_dense_generate_and_cache_off(models,
                                                                  name):
    _, tm = models
    kw, arrivals, _ = _scenario(name)
    outs = {}
    for on in (True, False):
        cfg = dict(dict(block_size=4, num_blocks=64, max_num_seqs=4,
                        decode_chunk_size=4, enable_prefix_cache=on), **kw)
        eng = LLMEngine.from_model(tm, EngineConfig(**cfg), device="cpu")
        rids = _drive(eng, SamplingParams, arrivals, 0)
        outs[on] = [eng.get_request(r).output_ids for r in rids]
    assert outs[True] == outs[False]
    for (_, p, mt), got in zip(arrivals, outs[True]):
        want = gen.generate(tm, p[None], mt)[0, len(p):]
        np.testing.assert_array_equal(got, want)


def test_stochastic_parity_cache_on_vs_off(models):
    """Both engines on the chunked path (prefill_chunk_threshold=0), so
    every draw comes from the in-chunk sampler and only sharing
    differs."""
    _, tm = models
    rng = np.random.RandomState(1)
    prompts = _templated(rng, 5, 24, 1)
    outs = {}
    for on in (True, False):
        eng = LLMEngine.from_model(tm, EngineConfig(
            block_size=4, num_blocks=64, max_num_seqs=4, decode_chunk_size=4,
            enable_prefix_cache=on, prefill_chunk_threshold=0), device="cpu")
        arrivals = [(0 if i == 0 else 10, p, 8) for i, p in enumerate(prompts)]
        rids = []
        pending, step = list(arrivals), 0
        while pending or eng.has_unfinished():
            while pending and pending[0][0] <= step:
                _, p, mt = pending.pop(0)
                i = len(rids)
                rids.append(eng.add_request(p, SamplingParams(
                    max_tokens=mt, temperature=0.8, top_k=20,
                    seed=100 + i)))
            if eng.has_unfinished():
                eng.step()
            step += 1
        outs[on] = [eng.get_request(r).output_ids for r in rids]
        if on:
            assert eng.cache.prefix_stats()["hits"] >= 3
    assert outs[True] == outs[False]


# ------------------------------------------- K3 over shared block tables
@pytest.mark.parametrize("kernel", ["ragged", "bucketed"])
def test_fused_chunk_over_shared_blocks_matches_jax(models, kernel):
    """Three rows whose tables start with the same two blocks (a shared
    prefix) and write into private tails: tokens exactly, pools within
    2e-5, and the shared blocks unchanged."""
    jm, tm = models
    geom = tm.cfg.geom
    L, H, D, S = geom
    k, bs, nb = 4, 4, 24
    mb = S // bs
    rng = np.random.RandomState(8)
    pools = [(rng.randn(nb, bs, H, D).astype(np.float32),
              rng.randn(nb, bs, H, D).astype(np.float32)) for _ in range(L)]
    packed = np.zeros((4, PACK_COLS + k + mb), np.int32)
    tables = {0: [3, 7, 10, 11], 1: [3, 7, 12, 13], 2: [3, 7, 14, 15]}
    for i, pos in ((0, 12), (1, 10), (2, 8)):
        packed[i, :PACK_COLS] = [5 + i, pos, 1, 1, 30, -1, pack_f32(0.0), 0,
                                 pack_f32(1.0), i, 0, 0]
        packed[i, PACK_COLS + k:PACK_COLS + k + len(tables[i])] = tables[i]
    jout, jpools = jfused(jgen.extract_params(jm),
                          tuple((jnp.asarray(a), jnp.asarray(b))
                                for a, b in pools),
                          jnp.asarray(packed), geom, k, kernel)
    tpools = tuple((torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
                   for a, b in pools)
    tout, tpools = fused_decode_chunk(gen.extract_params(tm), tpools,
                                      torch.from_numpy(packed), geom, k,
                                      kernel)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    for (tk, tv), (jk, jv), (ok, ov) in zip(tpools, jpools, pools):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=2e-5)
        np.testing.assert_array_equal(tk.numpy()[[3, 7]], ok[[3, 7]])
        np.testing.assert_array_equal(tv.numpy()[[3, 7]], ov[[3, 7]])


def test_chip_smoke_prefix_passes_run_on_cpu_at_tiny_size(monkeypatch):
    """chip_smoke.py's phases 6a-6c (prefix cache, int8 KV blocks, host
    tier) rehearsed on the CPU at a tiny size with every gate live; K3's
    wrapper runs its plain version there and counts no launch."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "PREFIX_TRAFFIC", dict(
        template_len=32, n_followers=9, burst=3, s_lo=2, s_hi=6, t_lo=6,
        t_hi=12))
    monkeypatch.setattr(chip_smoke, "TIERED_TRAFFIC", dict(
        n_templates=5, template_len=32, s_lo=2, s_hi=6, t_lo=4, t_hi=8,
        r_lo=2, r_hi=4))
    monkeypatch.setattr(chip_smoke, "TIERED_ENGINE", dict(
        num_blocks=28, host_tier_blocks=64, max_num_seqs=4))
    model = GPT(GPTConfig(vocab_size=101, hidden_size=32, num_layers=2,
                          num_heads=2, max_seq_len=128), device="cpu")
    ecfg = EngineConfig(block_size=8, num_blocks=96, max_num_seqs=4,
                        decode_chunk_size=4, prefill_chunk_threshold=12)
    assert chip_smoke.run_prefix_passes(model, ecfg, torch.device("cpu"),
                                        0) == {"prefix": 0, "int8": 0,
                                               "tiered": 0}


def test_paged_decode_step_over_shared_blocks_matches_jax(models):
    """paged_decode_step with two rows whose tables name the same prefix
    block, each writing its new token into a private block: logits within
    2e-5 of JAX's, the shared block unchanged."""
    from paddle_tpu.inference.serving import paged_decode_step as jstep
    from paddle_tpu_torch.inference.serving import paged_decode_step
    jm, tm = models
    geom = tm.cfg.geom
    L, H, D, S = geom
    bs, nb = 4, 12
    rng = np.random.RandomState(9)
    pools = [(rng.randn(nb, bs, H, D).astype(np.float32),
              rng.randn(nb, bs, H, D).astype(np.float32)) for _ in range(L)]
    tables = np.zeros((2, S // bs), np.int32)
    tables[0, :2] = [5, 6]
    tables[1, :2] = [5, 9]
    args = (np.array([3, 4], np.int32), np.array([6, 5], np.int32), tables,
            np.array([6, 9], np.int32), np.array([2, 1], np.int32))
    jl, _ = jstep(jgen.extract_params(jm),
                  tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in pools),
                  *(jnp.asarray(a) for a in args), geom)
    tpools = tuple((torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
                   for a, b in pools)
    tl, tpools = paged_decode_step(gen.extract_params(tm), tpools,
                                   *(torch.from_numpy(a) for a in args),
                                   geom)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=2e-5)
    for (tk, tv), (ok, ov) in zip(tpools, pools):
        np.testing.assert_array_equal(tk.numpy()[5], ok[5])
        np.testing.assert_array_equal(tv.numpy()[5], ov[5])
