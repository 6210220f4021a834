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
    with pytest.raises(NotImplementedError):
        GPT(GPTConfig(moe_experts=4, **GEOM_KW), device="cpu")
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
