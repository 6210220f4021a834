"""int8 KV blocks of the port (paddle_tpu_torch/inference/serving/
kv_quant.py and PagedKVCache(kv_cache_dtype="int8")) against the JAX
package, on the CPU.

- the codec's codes and scales equal the JAX codec's bit for bit. XLA's
  CPU compiler turns the codec's division by the constant 127 into a
  product with the float32 reciprocal of 127, which is one ulp off true
  division in some tiles; the port computes the scale as the compiled
  JAX program does, and `test_jax_scale_is_the_reciprocal_product`
  reports the difference;
- the monotone re-encode leaves unchanged blocks bit-identical, fresh
  blocks decode to exact zeros, writes stay within KV_INT8_REL_ERR;
- the quantized host-tier payload (L code pairs plus one [L, H] scale
  pair) and its sha256 equal the JAX cache's on the same content;
- the int8 engine's greedy tokens, cache.stats() and audit equal the
  JAX int8 engine's; its dequantized pools equal the JAX engine's within
  2e-5 (the f32 engines' own float32 agreement, test_torch_serving.py).
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
from paddle_tpu.inference.serving import kv_quant as jkv
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

from paddle_tpu_torch.inference.serving import (EngineConfig, LLMEngine,
                                                PagedKVCache, SamplingParams)
from paddle_tpu_torch.inference.serving import kv_quant
from paddle_tpu_torch.models.gpt import GPT, GPTConfig

VOCAB = 97
BOUND = kv_quant.KV_INT8_REL_ERR
GEOM_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=24)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**GEOM_KW))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**GEOM_KW), params,
                                   device="cpu")


def _blocks(seed, n=48, magnitude=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 8, 4, 16) * magnitude).astype(np.float32)
    x[3] = 0.0                                   # an all-zero block
    x[5, :, 1] = 0.0                             # an all-zero tile
    return x


def _bits(a):
    return np.asarray(a).view(np.int32) if np.asarray(a).dtype == \
        np.float32 else np.asarray(a)


def _tile_rel_err(got, want):
    absmax = want.abs().amax(dim=(1, 3), keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / absmax).max())


# ------------------------------------------------------------- codec
def test_constants_match_jax():
    assert kv_quant.KV_INT8_LEVELS == jkv.KV_INT8_LEVELS
    assert kv_quant.KV_INT8_REL_ERR == jkv.KV_INT8_REL_ERR


@pytest.mark.parametrize("magnitude", [1e-3, 1.0, 37.0, 1e4])
def test_codec_bitwise_matches_jax(magnitude):
    x = _blocks(int(np.log10(magnitude) + 5), magnitude=magnitude)
    prev = np.abs(np.random.RandomState(9).randn(48, 4)).astype(np.float32) \
        * magnitude / 127
    jq, js = jkv.quantize_blocks(jnp.asarray(x))
    tq, ts = kv_quant.quantize_blocks(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    jq2, js2 = jkv.requantize_blocks(jnp.asarray(x), jnp.asarray(prev))
    tq2, ts2 = kv_quant.requantize_blocks(torch.from_numpy(x),
                                          torch.from_numpy(prev))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(_bits(ts2.numpy()), _bits(js2))
    np.testing.assert_array_equal(
        _bits(kv_quant.dequantize_blocks(tq2, ts2).numpy()),
        _bits(jkv.dequantize_blocks(jq2, js2)))
    # the compiled codec's composition (the un-jitted jkv.
    # kv_block_roundtrip divides truly: test_jax_scale_is_the_...)
    np.testing.assert_array_equal(
        _bits(kv_quant.kv_block_roundtrip(torch.from_numpy(x)).numpy()),
        _bits(jkv.dequantize_blocks(*jkv.quantize_blocks(jnp.asarray(x)))))
    assert tq.dtype == torch.int8 and int(tq.abs().max()) <= 127


def test_jax_scale_is_the_reciprocal_product():
    """The compiled JAX codec's scale (quantize_blocks, what the JAX
    cache runs) is absmax times float32(1/127), not absmax / 127: the
    two differ by one ulp in some tiles (reported, not tolerated), and
    the port's scale is the former bit for bit. The un-jitted JAX
    kv_block_roundtrip (the jaxnum probe) runs the same jnp code eagerly
    and so divides truly."""
    x = _blocks(11, n=512)
    absmax = np.abs(x).max(axis=(1, 3))
    _, js = jkv.quantize_blocks(jnp.asarray(x))
    js = np.asarray(js)
    product = absmax * np.float32(1.0 / 127)
    division = absmax / np.float32(127)
    np.testing.assert_array_equal(_bits(js), _bits(product))
    _, eager = jkv._quantize_blocks(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(eager), _bits(division))
    off = _bits(division) - _bits(product)
    assert set(np.unique(off)) <= {-1, 0, 1}
    print(f"tiles where XLA's scale is one ulp off true division: "
          f"{int((off != 0).sum())} of {off.size}")
    assert (off != 0).any()


def test_dequantized_error_within_bound():
    x = torch.from_numpy(_blocks(3))
    assert _tile_rel_err(kv_quant.kv_block_roundtrip(x), x) \
        <= BOUND * (1 + 1e-6)


# --------------------------------------------------------- pool mode
def _rand_pools(seed, layers, shape):
    rng = np.random.RandomState(seed)
    return tuple((torch.from_numpy(rng.randn(*shape).astype(np.float32)),
                  torch.from_numpy(rng.randn(*shape).astype(np.float32)))
                 for _ in range(layers))


def test_int8_pool_write_read_within_bound():
    c = PagedKVCache(2, 4, 8, 16, 4, kv_cache_dtype="int8", device="cpu")
    want = _rand_pools(0, 2, (16, 4, 4, 8))
    c.pools = want
    worst = max(_tile_rel_err(g, w) for gp, wp in zip(c.pools, want)
                for g, w in zip(gp, wp))
    assert worst <= BOUND * (1 + 1e-6)
    for (qk, qv), (sk, sv) in c.stored_pools():
        assert qk.dtype == qv.dtype == torch.int8
        assert sk.shape == (16, 4) and sk.dtype == torch.float32


def test_int8_unchanged_blocks_are_bit_stable():
    c = PagedKVCache(2, 4, 8, 16, 4, kv_cache_dtype="int8", device="cpu")
    c.pools = _rand_pools(1, 2, (16, 4, 4, 8))
    before = [t.clone() for pair in c.stored_pools() for p in pair
              for t in p]
    for _ in range(3):
        c.pools = c.pools
    after = [t for pair in c.stored_pools() for p in pair for t in p]
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_int8_reused_blocks_reset_scale_and_content():
    rng = np.random.RandomState(2)
    c = PagedKVCache(1, 2, 4, 8, 2, kv_cache_dtype="int8", device="cpu")
    ids = c.allocate("big", 16)
    big = torch.from_numpy(100.0 * rng.randn(8, 2, 2, 4).astype(np.float32))
    c.pools = ((big, big),)
    c.free("big")
    ids2 = c.allocate("small", 16)
    assert sorted(ids2) == sorted(ids)
    kp, vp = c.pools[0]
    assert float(kp[ids2].abs().max()) == 0.0
    assert float(vp[ids2].abs().max()) == 0.0
    want = _rand_pools(3, 1, (8, 2, 2, 4))
    c.pools = want
    assert max(_tile_rel_err(g, w) for g, w in zip(c.pools[0], want[0])) \
        <= BOUND * (1 + 1e-6)


def test_kv_cache_dtype_validated_and_f32_storage_plain():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        PagedKVCache(1, 2, 4, 8, 2, kv_cache_dtype="int4", device="cpu")
    c = PagedKVCache(1, 2, 4, 8, 2, device="cpu")
    assert c.pools is c.stored_pools()
    assert c.pools[0][0].dtype == torch.float32


def test_pool_setter_matches_jax_codes_bitwise():
    """The same f32 content through both caches' pools setters: the
    stored codes and scales are equal bit for bit."""
    want = _rand_pools(4, 2, (16, 4, 4, 8))
    t = PagedKVCache(2, 4, 8, 16, 4, kv_cache_dtype="int8", device="cpu")
    j = JPagedKVCache(2, 4, 8, 16, 4, kv_cache_dtype="int8")
    t.pools = want
    j.pools = tuple((jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
                    for k, v in want)
    for ((tqk, tqv), (tsk, tsv)), (jqk, jqv), (jsk, jsv) in zip(
            t.stored_pools(), j._qpools, j._scales):
        for a, b in ((tqk, jqk), (tqv, jqv), (tsk, jsk), (tsv, jsv)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


# ---------------------------------------------------- quantized spill
def _fill_and_demote(c, pools):
    """Register 8 blocks of content, then claim the whole pool so every
    cached block demotes to the host tier; hand the blocks back."""
    toks = list(range(1, 17))
    c.allocate("a", 16)
    c.pools = pools
    c.free("a", cache_tokens=toks)
    ids = c._take_blocks("hog", 8)
    assert c.tier_demotions == 8
    for b in ids:
        del c._refcount[b]
        c._free.append(b)
        c.blocks_freed += 1
    return toks


def test_int8_spill_payload_and_digest_match_jax():
    pools = _rand_pools(5, 2, (8, 2, 2, 4))
    t = PagedKVCache(2, 2, 4, 8, 2, enable_prefix_cache=True,
                     host_tier_blocks=8, kv_cache_dtype="int8", device="cpu")
    j = JPagedKVCache(2, 2, 4, 8, 2, enable_prefix_cache=True,
                      host_tier_blocks=8, kv_cache_dtype="int8")
    _fill_and_demote(t, pools)
    _fill_and_demote(j, tuple((jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
                              for k, v in pools))
    assert t.host_tier.ids() == j.host_tier.ids()
    for hid in t.host_tier.ids():
        te, je = t.host_tier.get(hid), j.host_tier.get(hid)
        assert te["digest"] == je["digest"]
        tp, jp = te["payload"], je["payload"]
        assert len(tp) == len(jp) == t.num_layers + 1
        for (a, b), (c_, d) in zip(tp, jp):
            assert a.dtype == c_.dtype and b.dtype == d.dtype
            np.testing.assert_array_equal(_bits(a), _bits(c_))
            np.testing.assert_array_equal(_bits(b), _bits(d))
        assert tp[-1][0].shape == (t.num_layers, t.num_heads)
        assert all(p[0].dtype == np.int8 for p in tp[:-1])


def test_int8_spill_promotes_within_twice_the_bound():
    pools = _rand_pools(6, 2, (8, 2, 2, 4))
    c = PagedKVCache(2, 2, 4, 8, 2, enable_prefix_cache=True,
                     host_tier_blocks=8, kv_cache_dtype="int8", device="cpu")
    table = list(range(8))                       # allocate takes 0..7
    toks = _fill_and_demote(c, pools)
    res = c.ensure_promoted(toks + [99])
    assert res["outcomes"] == ["hit"] * 8
    path, _ = c.prefix_index.match(toks, touch=False)
    promoted = [n.block for n in path]
    worst = 0.0
    for (ak, av), (bk, bv) in zip(c.pools, pools):
        for a, b in ((ak, bk), (av, bv)):
            worst = max(worst, _tile_rel_err(a[promoted], b[table]))
    assert worst <= 2 * BOUND
    c.check_integrity()


def test_int8_corrupted_host_block_trips_sha256():
    c = PagedKVCache(2, 2, 4, 8, 2, enable_prefix_cache=True,
                     host_tier_blocks=8, kv_cache_dtype="int8", device="cpu")
    toks = _fill_and_demote(c, _rand_pools(7, 2, (8, 2, 2, 4)))
    assert c.host_tier.corrupt_oldest()
    res = c.ensure_promoted(toks + [99])
    assert "integrity" in res["outcomes"]
    assert c.tier_promotions["integrity"] == 1
    c.check_integrity()


# ----------------------------------------------------- engine parity
def _run(engine_cls, sp_cls, model, kvdt, **kw):
    cfg = dict(dict(block_size=4, num_blocks=16, max_num_seqs=4,
                    kv_cache_dtype=kvdt), **kw)
    if engine_cls is LLMEngine:
        eng = LLMEngine.from_model(model, EngineConfig(**cfg), device="cpu")
    else:
        eng = JLLMEngine.from_model(model, JEngineConfig(**cfg))
    rng = np.random.RandomState(0)
    for i, n in enumerate((5, 3, 7, 9)):
        eng.add_request(rng.randint(0, VOCAB, (n,)).astype(np.int32),
                        sp_cls(max_tokens=8), request_id=f"r{i}")
    return eng, eng.run(max_steps=200)


@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk_threshold=4),
                                dict(num_blocks=8)],
                         ids=["dense", "chunked", "preempting"])
def test_engine_int8_matches_jax_int8(models, kw):
    jm, tm = models
    je, jo = _run(JLLMEngine, JSamplingParams, jm, "int8", **kw)
    te, to = _run(LLMEngine, SamplingParams, tm, "int8", **kw)
    assert set(to) == set(jo)
    for rid in jo:
        np.testing.assert_array_equal(to[rid], jo[rid])
    assert te.cache.stats() == je.cache.stats()
    assert te.cache.stats()["kv_cache_dtype"] == "int8"
    assert te.cache.check_integrity() == je.cache.check_integrity()
    for (tk, tv), (jk, jv) in zip(te.cache.pools, je.cache.pools):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=2e-5)


def test_engine_int8_tracks_f32_within_bound(models):
    """The int8 engine's greedy tokens equal the f32 engine's; the live
    f32 KV round-trips the codec within the bound; the two engines'
    pools differ by at most 4x the bound per tile (JAX's alarm
    threshold for compounding error)."""
    _, tm = models
    e32, o32 = _run(LLMEngine, SamplingParams, tm, "float32")
    e8, o8 = _run(LLMEngine, SamplingParams, tm, "int8")
    for rid in o32:
        np.testing.assert_array_equal(o32[rid], o8[rid])
    st = e8.cache.stats()
    assert st["blocks_allocated"] == st["blocks_freed"]
    worst = div = 0.0
    for (ak, av), (bk, bv) in zip(e32.cache.pools, e8.cache.pools):
        for a, b in ((ak, bk), (av, bv)):
            worst = max(worst, _tile_rel_err(kv_quant.kv_block_roundtrip(a),
                                             a))
            div = max(div, _tile_rel_err(b, a))
    assert worst <= BOUND * (1 + 1e-6)
    assert div <= 4 * BOUND


def test_int8_chunk_stages_only_its_working_set(models):
    """The decode chunk runs on f32 staging pools holding the blocks its
    rows name (not a second pool), and re-encodes only what it wrote."""
    _, tm = models
    eng = LLMEngine.from_model(tm, EngineConfig(
        block_size=4, num_blocks=64, max_num_seqs=4, kv_cache_dtype="int8"),
        device="cpu")
    eng.add_request(np.arange(1, 6, dtype=np.int32),
                    SamplingParams(max_tokens=6))
    eng.step()                                   # dense prefill
    eng.step()                                   # the first chunk
    # 3 blocks named, staged in buffers grown in steps of 32 blocks
    assert eng.cache._stage[0][0].shape[0] == 32 < eng.cache.num_blocks
    eng.run()
