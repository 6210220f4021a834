"""Model and generation parity of the port (paddle_tpu_torch/models/)
against the JAX package, on the serving test geometry: GPTConfig(vocab
97, hidden 32, 2 layers, 4 heads, max_seq 24), the JAX model's weights
carried over by GPT.load_jax_params.

Tolerances: logits and caches within 2e-5 absolute (float32; the two
frameworks fuse and order their reductions differently, which moves
O(1) values by a few ulps per layer); token streams exactly.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
from paddle_tpu.inference.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.inference.serving import paged_decode_step as jpaged_step
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

import paddle_tpu_torch.models.generation as gen
from paddle_tpu_torch.inference.serving import PagedKVCache, paged_decode_step
from paddle_tpu_torch.models.gpt import GPT, GPTConfig

VOCAB = 97
TOL = 2e-5
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
    tm = GPT.load_jax_params(GPTConfig(**GEOM_KW), params, device="cpu")
    return jm, tm


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_weights_carry_exactly(models):
    jm, tm = models
    jp = jgen.extract_params(jm)
    tp = gen.extract_params(tm)
    assert set(jp) == set(tp)
    for name in jp:
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))


def test_load_jax_params_refuses_mismatched_names():
    params = {k: v.detach().numpy()
              for k, v in GPT(GPTConfig(**GEOM_KW), device="cpu")
              .named_parameters()}
    params["blocks.0.attn.qkv.weight_t"] = params.pop(
        "blocks.0.attn.qkv.weight")
    with pytest.raises(ValueError, match="names differ"):
        GPT.load_jax_params(GPTConfig(**GEOM_KW), params, device="cpu")


def test_unported_config_fields_raise():
    """No GPTConfig field raises any more: sequence_parallel and
    context_parallel (slice 9b) build, and with no sp mesh the model
    computes what the plain one does (the JAX package's flags change no
    result there either); MoE (slice 9a) builds."""
    ids = np.random.RandomState(2).randint(0, VOCAB, (2, 9))
    with torch.no_grad():
        want = GPT(GPTConfig(**GEOM_KW), device="cpu", seed=1)(ids)
        for kw in ("sequence_parallel", "context_parallel"):
            got = GPT(GPTConfig(**{kw: True}, **GEOM_KW), device="cpu",
                      seed=1)(ids)
            assert torch.equal(got, want), kw
    assert GPT(GPTConfig(moe_experts=4, **GEOM_KW), device="cpu")
    assert GPTConfig.tiny().geom == (2, 4, 16, 64)


def test_forward_matches_jax(models):
    jm, tm = models
    ids = np.random.RandomState(0).randint(0, VOCAB, (2, 9)).astype(np.int32)
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        _close(tm(ids), want)


def test_prefill_logits_and_cache_match_jax(models):
    jm, tm = models
    geom = tm.cfg.geom
    ids = np.random.RandomState(1).randint(0, VOCAB, (2, 7)).astype(np.int32)
    jl, jc = jgen.prefill(jgen.extract_params(jm), jnp.asarray(ids), geom)
    tl, tc = gen.prefill(gen.extract_params(tm), torch.from_numpy(ids), geom)
    _close(tl, jl)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        _close(tk, jk)
        _close(tv, jv)


def test_decode_steps_match_jax(models):
    jm, tm = models
    geom = tm.cfg.geom
    jp, tp = jgen.extract_params(jm), gen.extract_params(tm)
    ids = np.random.RandomState(2).randint(0, VOCAB, (3, 5)).astype(np.int32)
    jl, jc = jgen.prefill(jp, jnp.asarray(ids), geom)
    tl, tc = gen.prefill(tp, torch.from_numpy(ids), geom)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for step in range(6):
        jl, jc = jgen.decode_step(jp, jc, jnp.asarray(tok),
                                  jnp.asarray(5 + step, jnp.int32), geom)
        tl, tc = gen.decode_step(tp, tc, torch.from_numpy(tok), 5 + step,
                                 geom)
        _close(tl, jl)
        assert (tl.argmax(-1).numpy() == np.argmax(np.asarray(jl), -1)).all()
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for (tk, _), (jk, _) in zip(tc, jc):
        _close(tk, jk)


@pytest.mark.parametrize("kernel", ["ragged", "bucketed"])
def test_paged_decode_step_matches_jax(models, kernel):
    """Rows at different positions, one padded row (slot_blocks ==
    num_blocks: not written), against the JAX paged step: logits of the
    live rows and the written pools."""
    jm, tm = models
    geom = tm.cfg.geom
    L, H, D, S = geom
    bs, nb = 4, 16
    jp, tp = jgen.extract_params(jm), gen.extract_params(tm)
    rng = np.random.RandomState(3)
    lens = [3, 7, 5]
    jcache = JPagedKVCache(L, H, D, num_blocks=nb, block_size=bs)
    tcache = PagedKVCache(L, H, D, num_blocks=nb, block_size=bs,
                          device="cpu")
    toks = []
    for b, n in enumerate(lens):
        p = rng.randint(0, VOCAB, (n,)).astype(np.int32)
        jl, jd = jgen.prefill(jp, jnp.asarray(p[None]), geom)
        _, td = gen.prefill(tp, torch.from_numpy(p[None]), geom)
        toks.append(int(np.argmax(np.asarray(jl)[0])))
        for c in (jcache, tcache):
            c.allocate(b, n)
        jcache.write_prefill(b, jd, n)
        tcache.write_prefill(b, td, n)
    slots = [tcache.append_slot(b) for b in range(3)]
    assert slots == [jcache.append_slot(b) for b in range(3)]
    tables = np.zeros((4, S // bs), np.int32)
    for b in range(3):
        t = tcache.block_table(b)
        tables[b, :len(t)] = t
    args = (np.asarray(toks + [0], np.int32),
            np.asarray(lens + [0], np.int32), tables,
            np.asarray([s[0] for s in slots] + [nb], np.int32),
            np.asarray([s[1] for s in slots] + [0], np.int32))
    jl, jpools = jpaged_step(jp, jcache.pools, *map(jnp.asarray, args), geom)
    tl, tpools = paged_decode_step(tp, tcache.pools,
                                   *map(torch.from_numpy, args), geom,
                                   kernel=kernel)
    _close(tl[:3], np.asarray(jl)[:3])
    for (tk, tv), (jk, jv) in zip(tpools, jpools):
        _close(tk, jk)
        _close(tv, jv)


@pytest.mark.parametrize("eos", [False, True])
def test_generate_greedy_tokens_match_jax(models, eos):
    jm, tm = models
    ids = np.random.RandomState(4).randint(0, VOCAB, (3, 4)).astype(np.int32)
    want = np.asarray(jgen.generate(jm, jnp.asarray(ids), 12))
    eos_id = None
    if eos:
        # a token of row 0's stream that it has not emitted before
        row = list(want[0, 4:])
        eos_id = next(int(t) for i, t in enumerate(row)
                      if i >= 2 and t not in row[:i])
        want = np.asarray(jgen.generate(jm, jnp.asarray(ids), 12,
                                        eos_token_id=eos_id))
    got = gen.generate(tm, ids, 12, eos_token_id=eos_id)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ beam search, sampling
@pytest.mark.parametrize("beam,penalty,eos", [(3, 0.0, None), (4, 0.7, None),
                                              (3, 1.0, "first")])
def test_beam_search_matches_jax(models, beam, penalty, eos):
    """beam_search_generate is deterministic: the same sequences as the
    JAX package's, scores within 2e-5 (float32 sums of log-probs)."""
    jm, tm = models
    ids = np.random.RandomState(5).randint(0, VOCAB, (2, 5)).astype(np.int32)
    eos_id = None
    if eos:
        # a token some beam emits, so finished beams are exercised
        seqs, _ = jgen.beam_search_generate(jm, jnp.asarray(ids), beam, 10)
        eos_id = int(np.asarray(seqs)[0, 7])
    js, jsc = jgen.beam_search_generate(jm, jnp.asarray(ids), beam, 10,
                                        penalty, eos_id)
    ts, tsc = gen.beam_search_generate(tm, ids, beam, 10, penalty, eos_id)
    np.testing.assert_array_equal(ts, np.asarray(js))
    np.testing.assert_allclose(tsc, np.asarray(jsc), rtol=0, atol=2e-5)


@pytest.mark.parametrize("temp,top_k,top_p", [(0.8, 20, 0.9), (1.3, 0, 0.7),
                                              (0.5, 5, None), (1.0, 0, 1.0)])
def test_sampling_filter_matches_jax_draws(models, temp, top_k, top_p):
    """The port's sampling filter is `_sampling_rollout`'s: JAX's own
    generate() draws (argmax of the filtered logits plus the Gumbel noise
    of its split keys, which is what jax.random.categorical computes)
    are reproduced exactly from the port's filter over the port's
    logits along JAX's token stream."""
    import jax
    jm, tm = models
    ids = np.random.RandomState(6).randint(0, VOCAB, (2, 5)).astype(np.int32)
    T, new = ids.shape[1], 8
    want = np.asarray(jgen.generate(jm, jnp.asarray(ids), new, temp, top_k,
                                    top_p, None, 3))
    key = jax.random.PRNGKey(3)
    probe = jax.random.normal(jax.random.PRNGKey(9), (2, VOCAB))
    assert np.array_equal(
        np.asarray(jax.random.categorical(key, probe, axis=-1)),
        np.argmax(np.asarray(probe + jax.random.gumbel(key, (2, VOCAB))),
                  axis=-1))
    params = gen.extract_params(tm)
    for t in range(new):
        key, sub = jax.random.split(key)
        logits, _ = gen.prefill(params, torch.as_tensor(want[:, :T + t]),
                                tm.cfg.geom)
        lg = gen._sample_filter(
            logits, torch.full((2,), temp), torch.full((2,), top_k or 0),
            torch.full((2,), 1.0 if top_p is None else top_p))
        noise = np.asarray(jax.random.gumbel(sub, (2, VOCAB), jnp.float32))
        np.testing.assert_array_equal(
            np.argmax(lg.numpy() + noise, axis=-1), want[:, T + t])


def test_top_p_one_drops_the_nucleus_step(models):
    _, tm = models
    ids = np.random.RandomState(7).randint(0, VOCAB, (2, 4)).astype(np.int32)
    a = gen.generate(tm, ids, 8, 0.9, 10, None, seed=4)
    b = gen.generate(tm, ids, 8, 0.9, 10, 1.0, seed=4)
    np.testing.assert_array_equal(a, b)
    lg = torch.randn(3, VOCAB)
    knobs = (torch.full((3,), 0.9), torch.full((3,), 10, dtype=torch.int32))
    assert torch.equal(gen._sample_filter(lg, *knobs, torch.full((3,), 1.0)),
                       gen._sample_filter(lg, *knobs, torch.full((3,), 2.0)))


def test_sampling_is_seeded_and_filtered(models):
    """Port against port (JAX's threefry draws cannot be matched): one
    seed gives one stream, another seed another, top_k=1 is greedy, and
    every draw lies inside the top-k set of its logits."""
    _, tm = models
    ids = np.random.RandomState(8).randint(0, VOCAB, (3, 4)).astype(np.int32)
    a = gen.generate(tm, ids, 10, 1.0, 5, 0.9, seed=11)
    np.testing.assert_array_equal(a, gen.generate(tm, ids, 10, 1.0, 5, 0.9,
                                                  seed=11))
    assert not np.array_equal(a, gen.generate(tm, ids, 10, 1.0, 5, 0.9,
                                              seed=12))
    np.testing.assert_array_equal(gen.generate(tm, ids, 10, 1.5, 1, None,
                                               seed=3),
                                  gen.generate(tm, ids, 10))
    params = gen.extract_params(tm)
    for t in range(10):
        logits, _ = gen.prefill(params, torch.as_tensor(a[:, :4 + t]),
                                tm.cfg.geom)
        top5 = torch.topk(logits, 5).indices.numpy()
        assert all(a[r, 4 + t] in top5[r] for r in range(3))
