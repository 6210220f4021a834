"""Ring and Ulysses attention and the sequence- and context-parallel GPT
of the port, against the JAX package; K1's CPU backward contract.

K1's plain backward reads the o and lse it is given (the kernel's
contract), so a ring hop's block, handed the merged output and the
logsumexp of the whole row, gets its share of the row's gradients. The
multi-rank cases run on 4 gloo ranks (tests/test_torch_dist_worker.py,
suite "ring", one spawn for the module) against the JAX functions under
shard_map on the virtual mesh (sp 4), as tests/test_ring_attention.py
runs them, and the GPT runs against the JAX ShardedTrainStep on one
device with dense attention (the same function, summed in another
order).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu as jpaddle
import paddle_tpu.models.generation as jgen
import paddle_tpu.optimizer as jopt
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jgpt_loss_fn
from paddle_tpu.parallel import (ShardedTrainStep as JShardedTrainStep,
                                 build_mesh as jbuild_mesh,
                                 set_global_mesh as jset_global_mesh,
                                 shard_map)
from paddle_tpu.parallel.ring_attention import (
    ring_attention as jring_attention, ulysses_attention as
    julysses_attention)

from paddle_tpu_torch.ops.kernels import flash_attention as k1
# the module (the package's `ring_attention` is the function)
R = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

from test_torch_dist_worker import SGD_LR, run_cluster

# attention at sp 4: outputs and gradients within ATTN_TOL of the JAX
# functions (f32 on both sides, blocks merged in another order; measured
# under 1e-6)
ATTN_TOL = 2e-5
# GPT losses within REL of the JAX step's (relative), parameters within
# PARAM_REL of each array's largest magnitude; the key bias (zero
# gradient in exact arithmetic) within KEY_BIAS_ABS, as in
# test_torch_distributed.py
REL = 1e-5
PARAM_REL = 5e-5
KEY_BIAS_ABS = 1e-6
# K1's plain backward against autograd of the plain forward, both f32:
# the FA2 products from o and lse against softmax's own backward (f32
# rounding of o and lse; measured 1.2e-6)
BWD_TOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for _ in range(n)]


# ------------------------------------------------- K1's CPU backward
def test_k1_cpu_backward_equals_autograd_with_its_own_o_and_lse():
    """flash_attention_bwd on CPU tensors runs the plain FA2 backward from
    the o and lse it is given; with the forward's own it is the gradient
    autograd takes through the plain forward."""
    for causal in (True, False):
        q, k, v, do = _qkv((2, 2, 64, 16), 1)
        o, lse = k1.flash_attention_fwd(q, k, v, causal)
        got = k1.flash_attention_bwd(q, k, v, o, lse, do, causal)
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(
            k1.flash_attention_reference(*ts, causal), ts, do)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=BWD_TOL)


def test_k1_cpu_backward_reads_a_longer_rows_lse():
    """A block of the keys, given the output and logsumexp of the whole
    row, gives the block's part of the row's gradients: dq sums over the
    blocks, dk and dv are the row's on the block's keys. (A backward
    that recomputes its own softmax over the block gives the block's
    softmax gradients instead.)"""
    q, k, v, do = _qkv((1, 2, 32, 8), 2)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    full = k1.flash_attention_reference(*ts, False)
    want = torch.autograd.grad(full, ts, do)
    o, lse = k1.flash_attention_fwd(q, k, v, False)
    dq = torch.zeros_like(q)
    dks, dvs = [], []
    for s in (slice(0, 12), slice(12, 32)):
        gq, gk, gv = k1.flash_attention_bwd(q, k[:, :, s], v[:, :, s], o,
                                            lse, do, False)
        dq += gq
        dks.append(gk)
        dvs.append(gv)
    for g, w in zip((dq, torch.cat(dks, 2), torch.cat(dvs, 2)), want):
        torch.testing.assert_close(g, w, rtol=0, atol=BWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_chunks_in_one_process_match_full_attention(causal):
    """ring_chunks / ring_chunks_bwd (the card's one-process ring) over 4
    chunks equal the plain version over the whole sequence."""
    q, k, v, do = _qkv((2, 3, 64, 16), 3)
    qs, ks, vs, dos = (list(t.chunk(4, 2)) for t in (q, k, v, do))
    outs, lses = R.ring_chunks(qs, ks, vs, causal)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    full = k1.flash_attention_reference(*ts, causal)
    want = torch.autograd.grad(full, ts, do)
    torch.testing.assert_close(torch.cat(outs, 2), full.detach(), rtol=0,
                               atol=ATTN_TOL)
    got = R.ring_chunks_bwd(qs, ks, vs, outs, lses, dos, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(torch.cat(g, 2), w, rtol=0,
                                   atol=ATTN_TOL)


def test_merge_guards_rows_no_block_reached():
    """Two blocks whose rows both have lse -inf merge to 0, not nan (the
    JAX function's safe_l guard)."""
    o = torch.ones(1, 1, 2, 4)
    lse = torch.full((1, 1, 2), -float("inf"))
    acc = R.merge(R.merge(None, o, lse), o, lse)
    assert torch.isfinite(acc[0]).all() and (acc[0] == 0).all()


def test_ulysses_refuses_heads_not_divisible():
    """H % the axis size != 0 raises, as in the JAX package (a mesh with
    sp 4 and no process group: the check comes before any collective)."""
    from paddle_tpu_torch.parallel import mesh as pmesh
    pmesh.set_global_mesh(pmesh.RankMesh(np.arange(4).reshape(
        1, 1, 1, 4, 1, 1)))
    try:
        q = torch.zeros(1, 3, 4, 8)
        with pytest.raises(ValueError, match="must divide"):
            R.ulysses_attention(q, q, q, "sp")
    finally:
        pmesh.set_global_mesh(None)


# ---------------------------------------------------- 4 gloo ranks
def _tiny_cfg(**kw):
    return JGPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, max_seq_len=16, **kw)


def _params(model):
    return {k: np.asarray(v) for k, v in
            jgen.extract_params(model).items()}


@pytest.fixture(scope="module")
def cluster():
    rng = np.random.RandomState(0)
    inputs = {"x": rng.randint(0, 64, (8, 16)).astype(np.int64),
              "y": rng.randint(0, 64, (8, 16)).astype(np.int64)}
    for t in "qkvw":
        inputs[f"attn/{t}"] = rng.randn(2, 4, 64, 16).astype(np.float32)
    jpaddle.seed(0)
    inputs.update({f"gpt/{k}": v for k, v in
                   _params(JGPT(_tiny_cfg())).items()})
    return {"inputs": inputs, "ranks": run_cluster(inputs, 4, "ring")}


_ATTN = {}


def _jax_attention(fn, inputs, causal):
    """(out, dq, dk, dv) of the JAX function under shard_map over sp 4,
    causal and full in one jitted program a function (one compile)."""
    if fn not in _ATTN:
        mesh = jbuild_mesh(sp=4, devices=jax.devices()[:4])
        jset_global_mesh(mesh)
        try:
            spec = P(None, None, "sp", None)

            def both(q, k, v, w):
                res = {}
                for c in (True, False):
                    f = shard_map(
                        lambda a, b, d, c=c: fn(a, b, d, "sp", causal=c),
                        mesh=mesh, in_specs=(spec, spec, spec),
                        out_specs=spec, check_vma=False)
                    out, vjp = jax.vjp(f, q, k, v)
                    res[c] = (out, *vjp(w))
                return res
            got = jax.jit(both)(*(jnp.asarray(inputs[f"attn/{t}"])
                                  for t in "qkvw"))
            _ATTN[fn] = {c: [np.asarray(t) for t in r]
                         for c, r in got.items()}
        finally:
            jset_global_mesh(None)
    return _ATTN[fn][causal]


@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_on_four_ranks_matches_jax(cluster, name, causal):
    """Each rank's chunk of the output and of dq, dk, dv, put back in
    rank order, equals the JAX function's under shard_map at sp 4."""
    fn = jring_attention if name == "ring" else julysses_attention
    want = _jax_attention(fn, cluster["inputs"], causal)
    tag = f"{name}/{'causal' if causal else 'full'}"
    ranks = cluster["ranks"]
    for w, t in zip(want, ("out", "dq", "dk", "dv")):
        got = np.concatenate([ranks[r][f"{tag}/{t}"] for r in range(4)], 2)
        np.testing.assert_allclose(got, w, rtol=0, atol=ATTN_TOL,
                                   err_msg=f"{tag} {t}")


_REF = {}


def _jax_run(sgd):
    """Losses and final parameters of 3 JAX ShardedTrainStep steps on one
    device (AdamW 1e-3, epsilon 1e-6, or SGD at SGD_LR)."""
    if sgd not in _REF:
        mesh = jbuild_mesh(dp=1, devices=jax.devices()[:1])
        jset_global_mesh(mesh)
        try:
            jpaddle.seed(0)
            model = JGPT(_tiny_cfg())
            optim = jopt.SGD(SGD_LR, parameters=model.parameters()) \
                if sgd else jopt.AdamW(1e-3, epsilon=1e-6,
                                       parameters=model.parameters())
            step = JShardedTrainStep(model, jgpt_loss_fn, optim, mesh=mesh)
            rng = np.random.RandomState(0)
            x = rng.randint(0, 64, (8, 16)).astype(np.int64)
            y = rng.randint(0, 64, (8, 16)).astype(np.int64)
            xs, ys = jpaddle.to_tensor(x), jpaddle.to_tensor(y)
            losses = [float(step(xs, ys).numpy()) for _ in range(3)]
            _REF[sgd] = (np.array(losses), _params(model))
        finally:
            jset_global_mesh(None)
    return _REF[sgd]


def _close(got, want, what, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("run", ["cp_sp4", "cp_dp2sp2", "ag_dp2sp2"])
@pytest.mark.parametrize("sgd", [False, True])
def test_sequence_parallel_gpt_matches_jax(cluster, run, sgd):
    """The GPT over the sp group (the ring with context_parallel at sp 4
    and dp 2 x sp 2; the all-gathered keys with sequence_parallel at
    dp 2 x sp 2): 3 AdamW steps, and 3 SGD steps (its update is the
    gradient times lr, so a gradient at the wrong scale, a sum over sp
    for the mean, moves the parameters by whole updates where AdamW's
    normalisation hides it), equal the JAX step's on one device: every
    rank's losses equal, within REL of the JAX losses, parameters within
    PARAM_REL (SGD: REL)."""
    losses, params = _jax_run(sgd)
    tag = run + ("_sgd" if sgd else "")
    ranks = cluster["ranks"]
    for r in range(4):
        np.testing.assert_array_equal(ranks[r][f"{tag}/losses"],
                                      ranks[0][f"{tag}/losses"])
    _close(ranks[0][f"{tag}/losses"], losses, f"{tag} losses", REL)
    for name, want in params.items():
        got = ranks[0][f"{tag}/{name}"]
        if name.endswith("attn.qkv.bias") and not sgd:
            q, kb, v = np.split(got, 3)
            wq, wk, wv = np.split(want, 3)
            _close(np.concatenate([q, v]), np.concatenate([wq, wv]),
                   f"{tag} {name}", PARAM_REL)
            assert np.abs(kb - wk).max() <= KEY_BIAS_ABS, (tag, name)
            continue
        _close(got, want, f"{tag} {name}", REL if sgd else PARAM_REL)


def test_context_parallel_dropout_raises():
    """Attention dropout under the ring raises, as in the JAX package."""
    from paddle_tpu_torch.models.gpt import GPTAttention, GPTConfig
    from paddle_tpu_torch.parallel import set_global_mesh
    from paddle_tpu_torch.parallel import mesh as pmesh
    import paddle_tpu_torch as tpaddle
    tpaddle.set_device("cpu")
    mesh = pmesh.RankMesh(np.arange(2).reshape(1, 1, 1, 2, 1, 1))
    set_global_mesh(mesh)
    try:
        att = GPTAttention(GPTConfig(vocab_size=8, hidden_size=16,
                                     num_layers=1, num_heads=2,
                                     max_seq_len=8, dropout=0.1,
                                     context_parallel=True))
        with pytest.raises(NotImplementedError, match="dropout"):
            att(torch.zeros(1, 4, 16))
    finally:
        set_global_mesh(None)
        from paddle_tpu_torch.core import place
        place._default = None
