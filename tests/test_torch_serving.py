"""Serving parity of the port (paddle_tpu_torch/inference/serving/)
against the JAX package, on the CPU at the serving test geometry.

- fused_decode_chunk against JAX's on the same packed control array
  (decode rows, a chunked-prefill row, a max_tokens row, an eos row, a
  padding row), k in {1, 8}, ragged and bucketed: tokens, finished and
  bad rows exactly, pools within 2e-5 (float32 reduction order);
- paged-cache twins of tests/test_serving.py's PagedKVCache tests;
- engine greedy output equal to the JAX LLMEngine's and to JAX
  generate(), under preemption and chunked prefill, zero leaked blocks;
- EOS mid-chunk, stochastic streams invariant under k, non-finite
  quarantine with bitwise survivors;
- structure: the port imports neither jax nor paddle_tpu, and its
  entry points refuse to fall back to the CPU.
"""
import ast
from pathlib import Path

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
from paddle_tpu.inference.serving import fused_decode_chunk as jfused
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

import paddle_tpu_torch.models.generation as gen
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.inference.serving import (
    PACK_COLS, CacheExhausted, EngineConfig, EngineOverloaded, LLMEngine,
    PagedKVCache, SamplingParams, fused_decode_chunk, gather_block_kv,
    pack_f32)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig

VOCAB = 97
TOL = 2e-5
GEOM_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=24)
REPO = Path(__file__).resolve().parents[1]


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
    tm = GPT.load_jax_params(GPTConfig(**GEOM_KW), params, device="cpu")
    return jm, tm


def _engine(model, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 16)
    kw.setdefault("max_num_seqs", 4)
    return LLMEngine.from_model(model, EngineConfig(**kw), device="cpu")


def _jengine(model, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 16)
    kw.setdefault("max_num_seqs", 4)
    return JLLMEngine.from_model(model, JEngineConfig(**kw))


def _reference_tokens(jm, prompt, max_new):
    out = np.asarray(jgen.generate(
        jm, jnp.asarray(np.asarray(prompt)[None], jnp.int32), max_new))
    return out[0, len(prompt):]


# ------------------------------------------------------- fused chunk
def _chunk_state(k, eos_row0=-1):
    """Packed control array + initial pools (numpy) for 5 rows over a
    16-block pool of 4 positions: row 0 decodes (optional eos), row 1
    hits max_tokens mid-chunk, row 2 is a chunked-prefill row (6 prompt
    tokens left), row 3 decodes greedily far from its limit, row 4 is
    padding."""
    L, H, D, S = 2, 4, 8, 24
    bs, nb, mb = 4, 16, S // 4
    rng = np.random.RandomState(5)
    pools = [(rng.randn(nb, bs, H, D).astype(np.float32),
              rng.randn(nb, bs, H, D).astype(np.float32))
             for _ in range(L)]
    packed = np.zeros((5, PACK_COLS + k + mb), np.int32)
    tables = {0: [0, 1, 2, 3], 1: [4, 5, 6], 2: [7, 8], 3: [9, 10, 11, 12]}
    rows = {  # tok, pos, out_cnt, max_out, eos
        0: (11, 5, 1, 20, eos_row0),
        1: (22, 7, 2, 5, -1),
        2: (0, 0, 0, 9, -1),
        3: (33, 3, 1, 30, -1),
    }
    for i, (tok, pos, cnt, max_out, eos) in rows.items():
        packed[i, :PACK_COLS] = [tok, pos, 1, cnt, max_out, eos,
                                 pack_f32(0.0), 0, pack_f32(1.0), i, 0, 0]
        packed[i, PACK_COLS + k:PACK_COLS + k + len(tables[i])] = tables[i]
    prompt = rng.randint(0, VOCAB, (6,)).astype(np.int32)
    f = min(k, 6)
    packed[2, 10] = f
    packed[2, 11] = 1 if 6 > k else 0
    packed[2, PACK_COLS:PACK_COLS + f] = prompt[:f]
    return packed, pools


def _run_chunks(models, k, kernel, eos_row0=-1):
    jm, tm = models
    geom = tm.cfg.geom
    packed, pools = _chunk_state(k, eos_row0)
    jout, jpools = jfused(jgen.extract_params(jm),
                          tuple((jnp.asarray(a), jnp.asarray(b))
                                for a, b in pools),
                          jnp.asarray(packed), geom, k, kernel)
    tpools = tuple((torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
                   for a, b in pools)
    tout, tpools = fused_decode_chunk(gen.extract_params(tm), tpools,
                                      torch.from_numpy(packed), geom, k,
                                      kernel)
    return np.asarray(jout), jpools, tout.numpy(), tpools


@pytest.mark.parametrize("kernel", ["ragged", "bucketed"])
@pytest.mark.parametrize("k", [1, 8])
def test_fused_chunk_matches_jax(models, k, kernel):
    jout, jpools, tout, tpools = _run_chunks(models, k, kernel)
    np.testing.assert_array_equal(tout, jout)
    if k == 8:
        assert tout[k, 1] == 1                  # max_tokens mid-chunk
        # the trip consuming the 6th (last) prompt token samples
        assert (tout[:5, 2] == -1).all() and (tout[5:k, 2] >= 0).all()
        assert (tout[:k, 4] == -1).all()        # padding row frozen
    for (tk, tv), (jk, jv) in zip(tpools, jpools):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=TOL)


def test_fused_chunk_eos_mid_chunk_matches_jax(models):
    _, _, first, _ = _run_chunks(models, 8, "ragged")
    row = list(first[:8, 0])
    eos = next(int(t) for i, t in enumerate(row) if i >= 2
               and t not in row[:i])
    jout, _, tout, _ = _run_chunks(models, 8, "ragged", eos_row0=eos)
    np.testing.assert_array_equal(tout, jout)
    stop = row.index(eos)
    assert tout[stop, 0] == eos and (tout[stop + 1:8, 0] == -1).all()
    assert tout[8, 0] == 1


# ------------------------------------------------------- paged cache
def test_paged_cache_alloc_free_and_exhaustion():
    pc = PagedKVCache(num_layers=2, num_heads=4, head_dim=8,
                      num_blocks=4, block_size=4, device="cpu")
    assert pc.num_free() == 4 and pc.utilization() == 0.0
    ids = pc.allocate("a", 7)
    assert len(ids) == 2 and pc.num_used() == 2
    assert pc.block_table("a") == ids and pc.seq_len("a") == 7
    blk, off, pos = pc.append_slot("a")
    assert (blk, off, pos) == (ids[1], 3, 7)
    blk, off, pos = pc.append_slot("a")
    assert off == 0 and pos == 8 and len(pc.block_table("a")) == 3
    pc.allocate("b", 4)
    with pytest.raises(CacheExhausted) as ei:
        pc.allocate("c", 5)
    assert ei.value.needed == 2 and ei.value.free == 0
    assert ei.value.total == 4 and ei.value.seq_id == "c"
    assert pc.alloc_failures == 1 and not pc.has_seq("c")
    assert pc.free("a") == 3 and pc.free("b") == 1
    assert pc.num_free() == 4
    st = pc.stats()
    assert st["blocks_allocated"] == st["blocks_freed"] == 4
    assert st["high_water"] == 4
    pc.check_integrity()
    pc.allocate("d", 1)
    with pytest.raises(ValueError):
        pc.allocate("d", 1)


def test_paged_cache_block_order_matches_jax():
    """Same allocation sequence -> same block ids as the JAX cache (so
    pools written by both packages line up block for block)."""
    caches = [PagedKVCache(1, 1, 4, num_blocks=8, block_size=4,
                           device="cpu"),
              JPagedKVCache(1, 1, 4, num_blocks=8, block_size=4)]
    seen = []
    for c in caches:
        c.allocate("a", 5)
        c.allocate("b", 2)
        c.free("a")
        c.allocate("c", 9)
        c.reserve_slots("b", 7)
        seen.append((c.block_table("b"), c.block_table("c")))
    assert seen[0] == seen[1]


def test_reserve_slots_grows_atomically():
    pc = PagedKVCache(1, 2, 4, num_blocks=3, block_size=4, device="cpu")
    pc.allocate("a", 3)
    assert pc.reserve_slots("a", 6) == (pc.block_table("a")[0], 3, 3)
    assert pc.seq_len("a") == 9 and len(pc.block_table("a")) == 3
    with pytest.raises(CacheExhausted):
        pc.reserve_slots("a", 4)           # needs a 4th block
    assert pc.seq_len("a") == 9 and len(pc.block_table("a")) == 3
    with pytest.raises(ValueError):
        pc.reserve_slots("a", 0)


def test_write_prefill_roundtrips_dense_cache(models):
    _, tm = models
    geom = tm.cfg.geom
    L, H, D, S = geom
    ids = np.random.RandomState(0).randint(0, VOCAB, (2, 7)).astype(
        np.int32)
    _, dense = gen.prefill(gen.extract_params(tm), torch.from_numpy(ids),
                           geom)
    pc = PagedKVCache(L, H, D, num_blocks=16, block_size=4, device="cpu")
    for b, sid in enumerate(("s0", "s1")):
        pc.allocate(sid, 7)
        pc.write_prefill(sid, dense, 7, batch_index=b)
    for b, sid in enumerate(("s0", "s1")):
        table = torch.tensor([pc.block_table(sid)], dtype=torch.int32)
        for i in range(L):
            for j in range(2):
                got = gather_block_kv(pc.pools[i][j], table)
                want = dense[i][j][b][:, :got.shape[2]]
                torch.testing.assert_close(got[0], want, rtol=0, atol=0)


def test_scrub_zeroes_freed_blocks():
    pc = PagedKVCache(1, 1, 2, num_blocks=4, block_size=2, device="cpu")
    ids = pc.allocate("a", 3)
    pc.pools[0][0].fill_(float("nan"))
    pc.free("a", scrub=True)
    assert torch.all(pc.pools[0][0][ids] == 0)
    assert torch.isnan(pc.pools[0][0][[b for b in range(4)
                                        if b not in ids]]).all()


def test_unported_cache_modes_raise():
    """KV migration and peer prefix fetch, the last cache modes to be
    ported (slice 7), against the JAX cache in f32 and int8 pools:
    export_blocks gives the JAX payload bit for bit, import_blocks leaves
    the stored pool (int8: codes and scales) the JAX import leaves,
    payload_bytes agrees, and export_prefix / admit_prefix ship and
    install the same blocks, digests and tokens. Nothing raises
    NotImplementedError any more."""
    rng = np.random.RandomState(4)
    shape = (8, 2, 2, 4)                     # blocks, block size, H, D
    raw = [(rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32)) for _ in range(2)]

    def stored(c):
        if isinstance(c, PagedKVCache):
            return [np.asarray(a) for pair in c.stored_pools()
                    for a in (pair if c._qpools is None
                              else (*pair[0], *pair[1]))]
        if c._qpools is None:
            return [np.asarray(a) for pair in c._pools for a in pair]
        return [np.asarray(a) for q, sc in zip(c._qpools, c._scales)
                for a in (*q, *sc)]

    def bits(a):
        a = np.asarray(a)
        return a.view(np.int32) if a.dtype == np.float32 else a

    for kvdt in ("float32", "int8"):
        kw = dict(enable_prefix_cache=True, kv_cache_dtype=kvdt)
        t = PagedKVCache(2, 2, 4, 8, 2, device="cpu", **kw)
        j = JPagedKVCache(2, 2, 4, 8, 2, **kw)
        for c in (t, j):
            c.allocate("a", 5)
        t.pools = tuple((torch.from_numpy(k), torch.from_numpy(v))
                        for k, v in raw)
        j.pools = tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in raw)
        (tp, tn), (jp, jn) = t.export_blocks("a"), j.export_blocks("a")
        assert tn == jn == 5
        for (tk, tv), (jk, jv) in zip(tp, jp):
            np.testing.assert_array_equal(bits(tk.numpy()), bits(jk))
            np.testing.assert_array_equal(bits(tv.numpy()), bits(jv))
        assert t.payload_bytes(tp) == j.payload_bytes(jp) == 2 * 2 * 3 * 64
        # import into a fresh pool of each package (one block taken
        # first, so the import lands on other block ids than the source)
        t2 = PagedKVCache(2, 2, 4, 8, 2, device="cpu", **kw)
        j2 = JPagedKVCache(2, 2, 4, 8, 2, **kw)
        for c, p in ((t2, tp), (j2, jp)):
            c.allocate("x", 1)
            assert c.import_blocks("a", p, 5) == [1, 2, 3]
            c.check_integrity()
        for a, b in zip(stored(t2), stored(j2)):
            np.testing.assert_array_equal(bits(a), bits(b))
        # peer prefix fetch: the finished sequence's blocks, cached
        toks = np.arange(1, 6, dtype=np.int32)
        for c in (t, j):
            c.free("a", cache_tokens=toks[:4])
        te = t.export_prefix(np.arange(1, 7, dtype=np.int32))
        je = j.export_prefix(np.arange(1, 7, dtype=np.int32))
        assert te["tokens"] == je["tokens"] == [1, 2, 3, 4]
        assert te["bytes"] == je["bytes"]
        assert len(te["blocks"]) == len(je["blocks"]) == 2
        for (tpay, tdig), (jpay, jdig) in zip(te["blocks"], je["blocks"]):
            assert tdig == jdig
            for (tk, tv), (jk, jv) in zip(tpay, jpay):
                assert tk.dtype == np.float32
                np.testing.assert_array_equal(bits(tk), bits(jk))
                np.testing.assert_array_equal(bits(tv), bits(jv))
        peer_t = PagedKVCache(2, 2, 4, 8, 2, device="cpu", **kw)
        peer_j = JPagedKVCache(2, 2, 4, 8, 2, **kw)
        assert peer_t.admit_prefix(te["tokens"], te["blocks"]) == \
            peer_j.admit_prefix(je["tokens"], je["blocks"]) == 2
        peer_t.check_integrity()
        for a, b in zip(stored(peer_t), stored(peer_j)):
            np.testing.assert_array_equal(bits(a), bits(b))
        assert peer_t.match_len(np.arange(1, 7)) == 4


# ------------------------------------------------------- engine parity
def _mixed_workload(models, **kw):
    """8 requests, staggered arrivals, a pool tight enough to preempt
    (the acceptance workload of tests/test_serving.py), on the port and
    on the JAX engine."""
    jm, tm = models
    rng = np.random.RandomState(3)
    lens = [3, 6, 2, 8, 5, 4, 7, 3]
    max_toks = [8, 5, 10, 6, 8, 12, 4, 9]
    prompts = [rng.randint(0, VOCAB, (n,)).astype(np.int32) for n in lens]
    engines = [_engine(tm, num_blocks=6, **kw), _jengine(jm, num_blocks=6,
                                                         **kw)]
    sps = [SamplingParams, JSamplingParams]
    for eng, sp in zip(engines, sps):
        arrived, steps = 0, 0

        def arrive(n):
            nonlocal arrived
            for i in range(arrived, min(arrived + n, 8)):
                eng.add_request(prompts[i], sp(max_tokens=max_toks[i]),
                                request_id=f"r{i}")
            arrived = min(arrived + n, 8)

        arrive(3)
        while eng.has_unfinished() or arrived < 8:
            eng.step()
            steps += 1
            if steps % 2 == 0:
                arrive(2)
            assert steps < 300
    return engines, prompts, max_toks


@pytest.mark.parametrize("threshold", [None, 4])
def test_engine_greedy_matches_jax_under_preemption(models, threshold):
    jm, _ = models
    (teng, jeng), prompts, max_toks = _mixed_workload(
        models, prefill_chunk_threshold=threshold)
    for i, p in enumerate(prompts):
        got = teng.get_request(f"r{i}")
        assert got.state in ("finished_stopped", "finished_length")
        np.testing.assert_array_equal(
            got.output_ids, jeng.get_request(f"r{i}").output_ids)
        np.testing.assert_array_equal(
            got.output_ids, _reference_tokens(jm, p, max_toks[i]))
    assert teng.stats.preemptions >= 1
    assert teng.cache.num_free() == teng.config.num_blocks
    teng.cache.check_integrity()
    d = teng.stats.as_dict()
    assert d["completed"] == 8 and d["generated_tokens"] == sum(max_toks)


def test_engine_bucketed_matches_ragged(models):
    jm, tm = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, VOCAB, (n,)).astype(np.int32)
               for n in (5, 3, 7)]
    res = []
    for kernel in ("ragged", "bucketed"):
        eng = _engine(tm, kernel=kernel)
        for i, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(max_tokens=8),
                            request_id=f"r{i}")
        res.append(eng.run(max_steps=100))
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(res[0][f"r{i}"], res[1][f"r{i}"])
        np.testing.assert_array_equal(res[0][f"r{i}"],
                                      _reference_tokens(jm, p, 8))


def test_eos_mid_chunk_stops_exactly_at_eos(models):
    """The eos token is one the reference stream has not emitted before
    its 4th position, so the stream must stop exactly there."""
    jm, tm = models
    p = np.arange(1, 6, dtype=np.int32)
    ref = list(_reference_tokens(jm, p, 12))
    stop = next(i for i in range(3, 12) if ref[i] not in ref[:i])
    eng = _engine(tm, decode_chunk_size=8)
    rid = eng.add_request(p, SamplingParams(max_tokens=12,
                                            eos_token_id=int(ref[stop])))
    outs = []
    while eng.has_unfinished():
        outs.extend(eng.step())
    req = eng.get_request(rid)
    assert req.output_ids == ref[:stop + 1]
    assert outs[-1].finished and outs[-1].finish_reason == "stop"
    assert eng.cache.num_free() == eng.config.num_blocks
    eng.cache.check_integrity()


def test_stochastic_stream_is_invariant_under_chunk_size(models):
    _, tm = models
    prompts = [np.arange(1, 4, dtype=np.int32),
               np.asarray([9, 1, 7, 3], np.int32)]
    samp = [SamplingParams(max_tokens=10, temperature=0.9, top_k=9,
                           top_p=0.8, seed=11),
            SamplingParams(max_tokens=12, temperature=1.1, top_p=0.95,
                           seed=33)]
    res = []
    for k in (1, 8):
        eng = _engine(tm, decode_chunk_size=k, num_blocks=32)
        rids = [eng.add_request(p, s) for p, s in zip(prompts, samp)]
        out = eng.run(max_steps=200)
        res.append([out[r] for r in rids])
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)
        assert np.all(a >= 0) and np.all(a < VOCAB)
    assert not np.array_equal(res[0][0][:3], res[0][1][:3])


def test_nan_in_chunk_quarantines_offender_survivors_bitwise(models):
    """NaN written into one request's KV blocks after its prefill poisons
    its next chunk: nothing from the chunk is emitted, the offender
    finishes 'error', the survivors re-prefill and match generate()."""
    jm, tm = models
    eng = _engine(tm, decode_chunk_size=8)
    prompts = [np.arange(1, 4, dtype=np.int32),
               np.asarray([9, 1, 7, 3], np.int32),
               np.arange(5, 10, dtype=np.int32)]
    rids = [eng.add_request(p, SamplingParams(max_tokens=7))
            for p in prompts]
    eng.step()                                   # prefills + first tokens
    victim = eng.cache.block_table(rids[1])
    for kp, _ in eng.cache.pools:
        kp[victim] = float("nan")
    res = eng.run(max_steps=100)
    assert eng.get_request(rids[1]).state == "finished_error"
    assert eng.stats.errors == 1 and eng.stats.recoveries == 1
    assert eng.stats.rebuilt == 2
    for p, rid in zip(prompts, rids):
        if rid != rids[1]:
            np.testing.assert_array_equal(res[rid],
                                          _reference_tokens(jm, p, 7))
    assert eng.cache.num_free() == eng.config.num_blocks
    eng.cache.check_integrity()
    assert torch.isfinite(eng.cache.pools[0][0]).all()


def test_zero_leaked_blocks_under_churn_and_cancel(models):
    _, tm = models
    rng = np.random.RandomState(7)
    eng = _engine(tm, num_blocks=10, max_num_seqs=4)
    rids = [eng.add_request(rng.randint(0, VOCAB, (int(rng.randint(2, 9)),)),
                            SamplingParams(max_tokens=int(rng.randint(1, 8))))
            for _ in range(10)]
    cancelled, steps = 0, 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        if steps in (2, 5):                  # the latest arrivals
            cancelled += eng.cancel(rids[-1 if steps == 2 else -2])
        assert steps < 200
    st = eng.cache.stats()
    assert st["blocks_allocated"] == st["blocks_freed"]
    assert eng.cache.num_free() == eng.config.num_blocks
    assert eng.stats.cancelled == cancelled >= 1
    eng.cache.check_integrity()


def test_bounded_waiting_queue(models):
    _, tm = models
    eng = _engine(tm, max_waiting=2)
    p = np.arange(1, 4, dtype=np.int32)
    eng.add_request(p, request_id="a")
    eng.add_request(p, request_id="b")
    with pytest.raises(EngineOverloaded):
        eng.add_request(p, request_id="c")
    eng = _engine(tm, max_waiting=1, admission_policy="shed_oldest")
    eng.add_request(p, request_id="a")
    eng.add_request(p, request_id="b")
    outs = eng.step()
    assert outs[0].request_id == "a" and outs[0].finish_reason == "shed"
    with pytest.raises(ValueError, match="grow num_blocks"):
        _engine(tm, num_blocks=2).add_request(np.zeros(6, np.int32),
                                              SamplingParams(max_tokens=8))


def test_host_syncs_per_chunk(models):
    _, tm = models
    eng = _engine(tm, decode_chunk_size=8)
    eng.add_request(np.arange(1, 5, dtype=np.int32),
                    SamplingParams(max_tokens=17))
    eng.run(max_steps=50)
    assert (eng.stats.host_syncs("prefill"),
            eng.stats.host_syncs("decode")) == (1, 2)
    assert eng.stats.as_dict()["host_syncs_per_token"] == \
        pytest.approx(2 / 17)


# ---------------------------------------------------------- structure
def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    assert {"paddle_tpu_torch/obs/registry.py",
            "paddle_tpu_torch/obs/reqtrace.py",
            "paddle_tpu_torch/analysis/jaxplan.py",
            "paddle_tpu_torch/inference/__init__.py",
            "paddle_tpu_torch/inference/serving/tenancy.py",
            # slice 6a's eager surface
            "paddle_tpu_torch/__init__.py",
            "paddle_tpu_torch/core/tensor.py",
            "paddle_tpu_torch/core/autograd.py",
            "paddle_tpu_torch/core/dispatch.py",
            "paddle_tpu_torch/core/dtypes.py",
            "paddle_tpu_torch/core/errors.py",
            "paddle_tpu_torch/core/random.py",
            "paddle_tpu_torch/ops/creation.py",
            "paddle_tpu_torch/ops/math.py",
            "paddle_tpu_torch/ops/manipulation.py",
            "paddle_tpu_torch/ops/linalg.py",
            "paddle_tpu_torch/nn/initializer.py",
            "paddle_tpu_torch/nn/layer/base.py",
            "paddle_tpu_torch/optimizer/lr.py",
            "paddle_tpu_torch/amp/auto_cast.py",
            "paddle_tpu_torch/amp/grad_scaler.py",
            # slice 10a's static graph and transpiler
            "paddle_tpu_torch/static/program.py",
            "paddle_tpu_torch/static/executor.py",
            "paddle_tpu_torch/static/io.py",
            "paddle_tpu_torch/static/proto_io.py",
            "paddle_tpu_torch/distributed/transpiler.py",
            "paddle_tpu_torch/utils/__init__.py",
            # slice 10b's to_static, artifacts and predictors
            "paddle_tpu_torch/jit/__init__.py",
            "paddle_tpu_torch/jit/dy2static.py",
            "paddle_tpu_torch/ops/control_flow.py",
            "paddle_tpu_torch/models/generation.py",
            "paddle_tpu_torch/onnx/__init__.py",
            "paddle_tpu_torch/onnx/export.py"} <= scanned
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"


def test_entry_points_refuse_to_fall_back_to_cpu(models, monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine.from_model(tm, EngineConfig(block_size=4, num_blocks=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT(GPTConfig(**GEOM_KW))
    with pytest.raises(ValueError):
        resolve_device("tpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_phases_run_on_cpu_at_tiny_size():
    """chip_smoke.py's logits and engine phases, rehearsed on the CPU at a
    tiny size (the plain K3 version stands in for the kernel)."""
    import chip_smoke
    from paddle_tpu_torch.tools.serving_traffic import (bench_traffic,
                                                        drive_engine)
    model = GPT(GPTConfig(vocab_size=101, hidden_size=32, num_layers=2,
                          num_heads=2, max_seq_len=64), device="cpu")
    assert chip_smoke.check_logits(model, "cpu", 0, lens=(5, 17, 30),
                                   block_size=8, num_blocks=16) <= 1e-4
    ecfg = EngineConfig(block_size=8, num_blocks=32, max_num_seqs=4,
                        decode_chunk_size=8, prefill_chunk_threshold=12)
    specs = bench_traffic(101, 0, n_req=5, p_lo=4, p_hi=24, t_lo=4, t_hi=20)
    eng, rids = drive_engine(model, ecfg, specs, "cpu")
    assert chip_smoke.check_engine_outputs(model, eng, rids, specs) == 0
    q, kp, _, tables, lengths = chip_smoke.k3_inputs("cpu", torch.float32, 0)
    assert tuple(q.shape) == (chip_smoke.N, chip_smoke.H, chip_smoke.D)
    assert tables.dtype == torch.int32 and lengths.tolist() == list(
        chip_smoke.LENGTHS)


def test_unported_engine_options_raise(models):
    """EngineConfig.model and revision are ported (slice 7): an engine
    keyed ("m1", "r1") stamps its key on the KV it exports, and an
    engine serving other weights refuses that payload, as the JAX
    engine does. An unknown kernel still raises."""
    _, tm = models
    src = LLMEngine.from_model(
        tm, EngineConfig(block_size=4, model="m1", revision="r1"),
        device="cpu")
    rid = src.add_request(np.arange(1, 6, dtype=np.int32),
                          SamplingParams(max_tokens=4))
    src.step()
    snap = src.export_request(rid)
    assert (snap["model"], snap["revision"]) == ("m1", "r1")
    for key in ({}, {"model": "m1"}, {"revision": "r1"}):
        dst = LLMEngine.from_model(tm, EngineConfig(block_size=4, **key),
                                   device="cpu")
        with pytest.raises(ValueError, match="cross-revision"):
            dst.admit_migrated(snap)
        assert dst.cache.num_free() == dst.cache.num_blocks
    with pytest.raises(ValueError):
        _engine(tm, kernel="pallas")
