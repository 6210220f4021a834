"""The port's MoE (distributed/moe.py) and MoE GPT against the JAX
package, on the CPU.

Each case of tests/test_moe.py:50-143 runs on both packages with the
same weights (the JAX layer's, loaded into the port's): forced routing,
the top-2 renormalisation, capacity overflow, the slot positions of
moe_dispatch_combine and gradients to every expert. The port's indexed
routing is held to its dense twin (the JAX package's one-hot form), the
MoE GPT of test_moe.py:133 to the JAX GPT in loss and gradients with and
without recompute. On 4 gloo ranks at dp 2 x ep 2, MoEMLP and 5 SGD
steps of an MoE GPT under ShardedTrainStep are held to the JAX layer
and step on one device over the whole batch, with pairs dropped: the
routing is the global batch's. f32 throughout; the tolerance of each
case says why.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed.moe import MoEMLP as JMoEMLP
from paddle_tpu.distributed.moe import moe_dispatch_combine as jdispatch
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jgpt_loss_fn

import paddle_tpu_torch
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.nn.layer.layers import load_jax_state

# outputs and gradients of one layer: the same f32 products summed in
# another order (einsums against bmm and index_add)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle_tpu_torch.set_device("cpu")
    torch.set_num_threads(1)
    yield
    place._default = prev


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _pair(seed, *args, router=None, **kw):
    """The JAX MoEMLP (seeded) and a port MoEMLP with its weights;
    `router` replaces both routers."""
    jpaddle.seed(seed)
    jm = JMoEMLP(*args, **kw)
    if router is not None:
        jm.router._value = jnp.asarray(router)
    tm = moe.MoEMLP(*args, **kw)
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _run(jm, tm, x):
    """(out, aux, {param: grad}) of both layers for loss
    out.sum() + aux."""
    xj = jpaddle.to_tensor(x)
    yj = jm(xj)
    (yj.sum() + jm.aux_loss).backward()
    j = (np.asarray(yj.numpy()), float(jm.aux_loss.numpy()),
         {k: np.asarray(p.grad.numpy()) for k, p in jm.named_parameters()})
    xt = torch.from_numpy(x)
    yt = tm(xt)
    (yt.sum() + tm.aux_loss).backward()
    t = (yt.detach().numpy(), float(tm.aux_loss),
         {k: p.grad.numpy() for k, p in tm.named_parameters()})
    return j, t


def _force_router(h, e, expert):
    """test_moe.py's router: every token (x >= 0) to `expert`."""
    r = np.full((h, e), -20.0, np.float32)
    r[:, expert] = 20.0
    return r / h


def _check_pair(j, t, what):
    _close(t[0], j[0], f"{what} out")
    assert abs(t[1] - j[1]) <= TOL * abs(j[1]), (what, t[1], j[1])
    for k, g in j[2].items():
        _close(t[2][k], g, f"{what} d{k}")


def test_forced_routing_matches_jax_and_dense_expert():
    jm, tm = _pair(0, 16, 4, ffn_hidden_size=32, top_k=1,
                   capacity_factor=8.0, router=_force_router(16, 4, 1))
    x = np.abs(np.random.RandomState(0).randn(1, 6, 16)).astype(np.float32)
    j, t = _run(jm, tm, x)
    _check_pair(j, t, "forced")
    assert t[1] > 1.5  # maximally unbalanced


def test_top2_renormalised_combine_matches_jax():
    jm, tm = _pair(1, 8, 2, ffn_hidden_size=16, top_k=2,
                   capacity_factor=8.0, router=np.zeros((8, 2), np.float32))
    x = np.random.RandomState(1).randn(1, 5, 8).astype(np.float32)
    j, t = _run(jm, tm, x)
    _check_pair(j, t, "top2")
    np.testing.assert_allclose(t[1], 1.0, atol=1e-4)


def test_capacity_overflow_drops_to_zero_as_jax():
    jm, tm = _pair(2, 8, 4, ffn_hidden_size=16, top_k=1,
                   capacity_factor=0.25, min_capacity=1,
                   router=_force_router(8, 4, 0))
    x = np.abs(np.random.RandomState(2).randn(1, 8, 8)).astype(np.float32)
    j, t = _run(jm, tm, x)
    _check_pair(j, t, "overflow")
    out = t[0].reshape(8, 8)
    assert np.abs(out[0]).sum() > 0
    np.testing.assert_array_equal(out[1:], np.zeros_like(out[1:]))


def test_dispatch_combine_positions_match_jax():
    gates = np.asarray([[0.9, 0.1], [0.1, 0.9], [0.9, 0.1], [0.1, 0.9]],
                       np.float32)
    jd, jc, ja = jdispatch(jnp.asarray(gates), top_k=1, capacity=2)
    td, tc, ta = moe.moe_dispatch_combine(torch.from_numpy(gates), 1, 2)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    d = td.numpy()
    assert d[0, 0, 0] == 1 and d[2, 0, 1] == 1
    assert d[1, 1, 0] == 1 and d[3, 1, 1] == 1 and d.sum() == 4
    # the indexed form: the same slots and weights, nothing dropped
    tok, slot, w, dropped, aux = moe._route(torch.from_numpy(gates), 1, 2)
    assert sorted(zip(tok.tolist(), slot.tolist())) == \
        [(0, 0), (1, 2), (2, 1), (3, 3)]
    np.testing.assert_allclose(w.numpy(), 0.9, rtol=1e-6)
    assert int(dropped) == 0


def test_grads_flow_to_all_experts_as_jax():
    jm, tm = _pair(3, 8, 2, ffn_hidden_size=16, top_k=2,
                   capacity_factor=4.0, router=np.zeros((8, 2), np.float32))
    x = np.random.RandomState(3).randn(2, 4, 8).astype(np.float32)
    j, t = _run(jm, tm, x)
    _check_pair(j, t, "grads")
    for k, g in t[2].items():
        assert np.abs(g).sum() > 0, k
    assert np.abs(t[2]["w_up"][0]).sum() > 0
    assert np.abs(t[2]["w_up"][1]).sum() > 0


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 1.25), (2, 0.5)])
def test_indexed_matches_dense_twin(top_k, cf):
    """The indexed routing (gather, bmm, index_add) against the dense
    one-hot twin on the same weights: outputs, aux, the dropped count
    and every gradient, with tokens dropped at capacity factors 0.5 and
    1.0."""
    torch.manual_seed(0)
    m = moe.MoEMLP(16, 4, ffn_hidden_size=32, top_k=top_k,
                   capacity_factor=cf)
    x = torch.randn(2, 24, 16, requires_grad=True)
    r = torch.randn(2, 24, 16)
    args = (m.router, m.w_up, m.b_up, m.w_down, m.b_down, top_k, cf, 4)
    got, want = [], []
    for fn, sink in ((moe._moe_indexed, got), (moe._moe_dense, want)):
        out, aux, dropped = fn(x, *args)
        g = torch.autograd.grad((out * r).sum() + aux,
                                [x] + list(m.parameters()))
        sink += [out.detach(), aux.detach(), dropped] + list(g)
    assert int(got[2]) > 0 or cf > 1.0
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.detach().numpy(), b.detach().numpy(), f"entry {i}")


def _gpt_pair(use_recompute=False):
    """The JAX MoE GPT without recompute (its eager tape leaves some
    gradients of a recomputed block unset; recompute changes no math,
    test_moe.py:128) and the port's with its weights under
    `use_recompute`."""
    cfg_kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                  max_seq_len=16, moe_experts=4, moe_top_k=2, moe_every=1,
                  moe_capacity_factor=2.0)
    jpaddle.seed(0)
    jm = JGPT(JGPTConfig(**cfg_kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPT.load_jax_params(GPTConfig(use_recompute=use_recompute,
                                       **cfg_kw), state, device="cpu")
    return jm, tm


@pytest.mark.parametrize("recompute", [False, True, "full"])
def test_moe_gpt_loss_and_grads_match_jax(recompute):
    """test_moe.py:133's GPT (4 experts, every block MoE, top-2, capacity
    2.0): the loss (task loss + 0.01 x each block's aux) and every
    gradient equal the JAX GPT's, without recompute, with per-block
    recompute and under "full" (the aux losses ride the checkpoint's
    return). 1e-5 of each gradient's largest magnitude."""
    jm, tm = _gpt_pair(use_recompute=recompute)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, (4, 16)).astype(np.int64)
    y = rng.randint(0, 64, (4, 16)).astype(np.int64)
    jl = jgpt_loss_fn(jm, jpaddle.to_tensor(x), jpaddle.to_tensor(y))
    jl.backward()
    tl = gpt_loss_fn(tm, torch.from_numpy(x), torch.from_numpy(y))
    tl.backward()
    assert abs(float(tl) - float(jl.numpy())) <= 1e-6 * float(jl.numpy())
    jg = {k: np.asarray(p.grad.numpy()) for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        _close(p.grad.numpy(), jg[k], k)
    aux = [float(b.mlp.aux_loss) for b in tm.blocks]
    assert all(0.5 < a < 2.0 for a in aux), aux


def test_moe_gpt_trains_under_trainstep():
    """Five Adam steps of the MoE GPT through jit.TrainStep: the losses
    fall."""
    from paddle_tpu_torch import jit, optimizer
    _, tm = _gpt_pair()
    step = jit.TrainStep(tm, gpt_loss_fn,
                         optimizer.Adam(1e-3, parameters=tm.parameters()))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 64, (4, 16)))
    y = torch.from_numpy(rng.randint(0, 64, (4, 16)))
    losses = [float(step(x, y)) for _ in range(5)]
    assert losses[-1] < losses[0], losses


@pytest.fixture(scope="module")
def ep_cluster():
    """4 gloo ranks at dp 2 x ep 2 (tests/test_torch_dist_worker.py's
    "moe" suite) on the JAX package's weights and batches: MoEMLP with
    the batch's rows split over dp (the ep ranks of a dp rank hold the
    same rows) and over dp and ep, and 5 SGD steps of the MoE GPT under
    ShardedTrainStep with each of those batch specs."""
    from test_torch_dist_worker import MOE_GPT, run_cluster
    rng = np.random.RandomState(5)
    jpaddle.seed(9)
    jm = JMoEMLP(16, 4, ffn_hidden_size=32, top_k=2, capacity_factor=1.0)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    inputs = {"moe_x": rng.randn(4, 8, 16).astype(np.float32),
              "moe_r": rng.randn(4, 8, 16).astype(np.float32)}
    inputs.update({f"moe/{k}": v for k, v in state.items()})
    x, y = _gpt_batch()
    inputs.update({"x": x, "y": y})
    jpaddle.seed(0)
    jg = JGPT(JGPTConfig(**_TINY, **MOE_GPT))
    inputs.update({f"moegpt/{k}": np.asarray(v.numpy())
                   for k, v in jg.state_dict().items()})
    return {"inputs": inputs, "state": state,
            "ranks": run_cluster(inputs, 4, "moe", timeout=180)}


_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=16)


def _gpt_batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 64, (8, 16)).astype(np.int64),
            rng.randint(0, 64, (8, 16)).astype(np.int64))


def _jax_moe_layer(state, x, r, n):
    """(out, aux, dx, {param: grad}) of the JAX MoEMLP on the whole batch
    for loss sum(out * r) / n + 0.5 aux: the mean over n ranks of the
    ranks' losses sum(their out * their r) + 0.5 aux."""
    jm = JMoEMLP(16, 4, ffn_hidden_size=32, top_k=2, capacity_factor=1.0)
    for k, p in jm.named_parameters():
        p._value = jnp.asarray(state[k])
    xt = jpaddle.to_tensor(x)
    xt.stop_gradient = False
    y = jm(xt)
    ((y * jpaddle.to_tensor(r)).sum() / n + 0.5 * jm.aux_loss).backward()
    return (np.asarray(y.numpy()), float(jm.aux_loss.numpy()),
            np.asarray(xt.grad.numpy()),
            {k: np.asarray(p.grad.numpy()) for k, p in jm.named_parameters()})


def _check_ep_layer(ep_cluster, name, n, coord):
    """The ranks' MoEMLP against the JAX layer on the whole batch; rank r
    holds block coord(r) of n. Each rank's output and aux are the JAX
    layer's (its rows); its input gradient is n times the JAX one (the
    aux's all-reduce sums every rank's gradient into each); the router's
    gradient averaged over the 4 ranks, and each expert's gathered over
    ep, divided by ep and averaged over dp (ShardedTrainStep's
    reduction), are the JAX gradients. Pairs are dropped (capacity
    factor 1.0)."""
    inputs, ranks = ep_cluster["inputs"], ep_cluster["ranks"]
    x, r = inputs["moe_x"], inputs["moe_r"]
    out, aux, dx, grads = _jax_moe_layer(ep_cluster["state"], x, r, n)
    rows = len(x) // n
    dropped = {}
    for rank in range(4):
        got, c = ranks[rank], coord(rank)
        part = slice(c * rows, (c + 1) * rows)
        _close(got[f"{name}/out"], out[part], f"rank {rank} out")
        assert abs(float(got[f"{name}/aux"]) - aux) <= TOL * aux, rank
        _close(got[f"{name}/dx"] / n, dx[part], f"rank {rank} dx")
        np.testing.assert_array_equal(got[f"{name}/local/w_up"],
                                      [2, 16, 32])
        dropped[c] = int(got[f"{name}/dropped"])
    assert sum(dropped.values()) > 0, dropped
    _close(np.mean([ranks[k][f"{name}/drouter"] for k in range(4)], 0),
           grads["router"], "router")
    for k in ("w_up", "b_up", "w_down", "b_down"):
        # ranks 0 and 2 are ep coordinate 0 of dp 0 and 1
        mean = np.mean([ranks[q][f"{name}/d{k}"] for q in (0, 2)], 0) / 2
        _close(mean, grads[k], f"d{k}")


def test_moe_ep2_on_gloo_matches_one_rank(ep_cluster):
    """MoEMLP at dp 2 x ep 2 on 4 gloo ranks (experts 0-1 on ep rank 0,
    2-3 on ep rank 1; tokens to their experts and back by
    all_to_all_single), the batch's rows split over dp, against the JAX
    layer on one device over the whole batch (_check_ep_layer): routing,
    capacity and aux are the global batch's."""
    _check_ep_layer(ep_cluster, "dp", 2, lambda rank: rank // 2)


def test_moe_ep2_batch_split_over_ep_matches_jax(ep_cluster):
    """The same with the rows split over dp and ep (mesh.batch_axes
    ("dp", "ep")): four blocks, rank r holding block r."""
    _check_ep_layer(ep_cluster, "dpep", 4, lambda rank: rank)


_MOE_REF = {}


def _jax_moe_gpt_run(steps=5):
    """Losses and final parameters of the JAX ShardedTrainStep on one
    device: the worker's MoE GPT, SGD at its SGD_LR, the whole batch."""
    from paddle_tpu.parallel import (ShardedTrainStep, build_mesh,
                                     set_global_mesh)
    import paddle_tpu.optimizer as jopt
    import jax
    from test_torch_dist_worker import MOE_GPT, SGD_LR
    if steps not in _MOE_REF:
        mesh = build_mesh(dp=1, devices=jax.devices()[:1])
        set_global_mesh(mesh)
        try:
            jpaddle.seed(0)
            jg = JGPT(JGPTConfig(**_TINY, **MOE_GPT))
            step = ShardedTrainStep(jg, jgpt_loss_fn, jopt.SGD(
                SGD_LR, parameters=jg.parameters()), mesh=mesh)
            x, y = (jpaddle.to_tensor(a) for a in _gpt_batch())
            losses = [float(step(x, y).numpy()) for _ in range(steps)]
            _MOE_REF[steps] = (np.array(losses), {
                k: np.asarray(v.numpy())
                for k, v in jg.state_dict().items()})
        finally:
            set_global_mesh(None)
    return _MOE_REF[steps]


@pytest.mark.parametrize("run", ["gpt_dp", "gpt_dpep"])
def test_moe_gpt_dp2_ep2_sharded_step_matches_jax(ep_cluster, run):
    """5 SGD steps of the MoE GPT (every block MoE, 4 experts, capacity
    factor 1.0) under ShardedTrainStep at dp 2 x ep 2, the batch split
    over dp ("gpt_dp") or over dp and ep ("gpt_dpep"), against the JAX
    ShardedTrainStep on one device over the whole batch: every rank's
    losses equal, within 1e-5 relative of the JAX losses, and the
    gathered final parameters within 1e-5 of each array's largest
    magnitude (SGD: the ep division and the dp mean show at full scale),
    the key bias within 1e-6 absolute (its gradient is zero in exact
    arithmetic); the step drops pairs."""
    ranks = ep_cluster["ranks"]
    losses, params = _jax_moe_gpt_run()
    for rank in range(4):
        np.testing.assert_array_equal(ranks[rank][f"{run}/losses"],
                                      ranks[0][f"{run}/losses"])
    _close(ranks[0][f"{run}/losses"], losses, f"{run} losses")
    assert losses[-1] < losses[0]
    assert sum(int(ranks[q][f"{run}/dropped"].sum()) for q in range(4)) > 0
    for k, want in params.items():
        got = ranks[0][f"{run}/{k}"]
        if k.endswith("attn.qkv.bias"):
            q, kb, v = np.split(got, 3)
            wq, wk, wv = np.split(want, 3)
            _close(np.concatenate([q, v]), np.concatenate([wq, wv]), k)
            assert np.abs(kb - wk).max() <= 1e-6, k
            continue
        _close(got, want, f"{run} {k}")
