"""The fleet's communication-optimizing steps of the port
(distributed/fleet/comm_opt.py) against the JAX package.

tests/test_strategies.py:27-178's cases run on 4 gloo ranks at dp 4
(tests/test_torch_dist_worker.py, suite "comm_opt", one spawn for the
module) on its toy Linear(4, 2), against the JAX package's steps over a
4-device dp mesh of the virtual mesh on the same weights and data. DGC's
mask is held to the JAX package's quantile mask on a tensor above 2^24
elements in this process.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu as jpaddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.comm_opt import (
    AdaptiveLocalSGDStep as JAdaptiveLocalSGDStep, DGCStep as JDGCStep,
    Fp16AllReduceStep as JFp16AllReduceStep, LocalSGDStep as JLocalSGDStep)

import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch.distributed.fleet.comm_opt import quantile_linear

from test_torch_dist_worker import run_cluster

# f32 steps of the toy model: weights and losses within TOL of the JAX
# step's (measured under 1e-7; the ranks' means reorder additions)
TOL = 1e-6
# the 16-bit allreduces: XLA's CPU pmean of bf16 sums in f32 and rounds
# the mean once, gloo (like NCCL) adds in the 16-bit type, rounding each
# add, so a synced gradient lands up to a few 16-bit ulps from the JAX
# step's; losses, weights and biases within one 16-bit ulp, relative
# (2^-8 for bf16, 2^-11 for f16; measured 1.1e-3 on bf16's losses)
FP16_REL = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh4():
    return Mesh(np.asarray(jax.devices()[:4]), ("dp",))


def _jtoy():
    jpaddle.seed(0)
    return jpaddle.nn.Linear(4, 2)


def _data():
    X = np.random.RandomState(0).randn(16, 4).astype("float32")
    Y = np.random.RandomState(1).randn(16, 2).astype("float32")
    return X, Y


def _jloss(m, x, y):
    return ((m(x) - y) ** 2).mean()


@pytest.fixture(scope="module")
def cluster():
    X, Y = _data()
    m = _jtoy()
    inputs = {"toy/X": X, "toy/Y": Y,
              "toy/weight": np.asarray(m.weight.numpy()),
              "toy/bias": np.asarray(m.bias.numpy())}
    return run_cluster(inputs, 4, "comm_opt")


def _run(make, steps):
    """(losses, weight, bias, step) of a JAX step on the 4-device dp
    mesh."""
    m = _jtoy()
    step = make(m)
    X, Y = _data()
    x, y = jpaddle.to_tensor(X), jpaddle.to_tensor(Y)
    losses = [float(step(x, y).numpy()) for _ in range(steps)]
    return np.array(losses), m.weight.numpy(), m.bias.numpy(), step


def _same(ranks, tag, losses, weight, bias, tol=TOL, rel=0.0):
    for r in range(4):
        np.testing.assert_array_equal(ranks[r][f"{tag}/weight"],
                                      ranks[0][f"{tag}/weight"])
    atol = 0.0 if rel else tol
    if losses is not None:
        np.testing.assert_allclose(ranks[0][f"{tag}/losses"], losses,
                                   rtol=rel, atol=atol, err_msg=tag)
    np.testing.assert_allclose(ranks[0][f"{tag}/weight"], weight, rtol=rel,
                               atol=atol, err_msg=tag)
    np.testing.assert_allclose(ranks[0][f"{tag}/bias"], bias, rtol=rel,
                               atol=atol, err_msg=tag)


def test_localsgd_k1_matches_jax(cluster):
    """k_steps 1: every step averages the parameters (synchronous dp)."""
    want = _run(lambda m: JLocalSGDStep(
        m, _jloss, jopt.SGD(0.1, parameters=m.parameters()), k_steps=1,
        mesh=_mesh4()), 3)
    _same(cluster, "localsgd_k1", *want[:3])


def test_localsgd_copies_diverge_then_sync_as_jax(cluster):
    """k 3: after steps 1 and 2 the ranks' copies differ, after step 3
    they agree; each rank's copy at each step equals the JAX step's."""
    m = _jtoy()
    step = JLocalSGDStep(m, _jloss, jopt.SGD(0.1,
                                             parameters=m.parameters()),
                         k_steps=3, mesh=_mesh4())
    X, Y = _data()
    for i in range(3):
        step(jpaddle.to_tensor(X), jpaddle.to_tensor(Y))
        for r in (0, 1):
            want = np.asarray(step.rank_params(r)["weight"])
            for rank in range(4):
                np.testing.assert_allclose(
                    cluster[rank][f"localsgd_k3/{i}/rank{r}"], want,
                    rtol=0, atol=TOL)
        a = cluster[0][f"localsgd_k3/{i}/rank0"]
        b = cluster[0][f"localsgd_k3/{i}/rank1"]
        assert np.allclose(a, b) == (i == 2), i
    _same(cluster, "localsgd_k3", None, m.weight.numpy(), m.bias.numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fp16_allreduce_matches_jax(cluster, dtype):
    """Gradients all-reduced in 16 bits (gloo takes both types) and cast
    back: the copies stay equal and track the JAX step within one 16-bit
    ulp (FP16_REL)."""
    want = _run(lambda m: JFp16AllReduceStep(
        m, _jloss, jopt.SGD(0.1, parameters=m.parameters()), dtype=dtype,
        mesh=_mesh4()), 3)
    _same(cluster, f"fp16_{dtype}", *want[:3], rel=FP16_REL[dtype])


def test_dgc_matches_jax(cluster):
    """DGC (rampup at step 2 over 4 steps, sparsity 0.75 then 0.9) with
    Momentum: 20 losses and the final weights equal the JAX step's; the
    dense steps before rampup are the dense baseline; the kept fraction
    after rampup is the JAX step's."""
    losses, w, b, step = _run(lambda m: JDGCStep(
        m, _jloss, jopt.Momentum(0.05, momentum=0.9,
                                 parameters=m.parameters()),
        rampup_begin_step=2, rampup_step=4, sparsity=[0.75, 0.9],
        mesh=_mesh4()), 20)
    _same(cluster, "dgc", losses, w, b)
    assert float(cluster[0]["dgc/density"]) == pytest.approx(
        step.last_density, abs=1e-6)
    assert float(cluster[0]["dgc/density"]) <= 0.25


def test_adaptive_localsgd_matches_jax(cluster):
    """The AdaComm period follows the losses as in the JAX step."""
    m = _jtoy()
    step = JAdaptiveLocalSGDStep(
        m, _jloss, jopt.SGD(0.1, parameters=m.parameters()),
        init_k_steps=2, mesh=_mesh4())
    X, Y = _data()
    losses, ks = [], []
    for _ in range(6):
        losses.append(float(step(jpaddle.to_tensor(X),
                                 jpaddle.to_tensor(Y)).numpy()))
        ks.append(step._k)
    np.testing.assert_array_equal(cluster[0]["adaptive/k"], ks)
    np.testing.assert_allclose(cluster[0]["adaptive/losses"], losses,
                               rtol=0, atol=TOL)
    # the last step did not sync: each rank holds its own copy (the JAX
    # Layer holds the mean of the last sync; its rank_params the copies)
    for r in range(4):
        want = step.rank_params(r)
        for k in ("weight", "bias"):
            np.testing.assert_allclose(cluster[r][f"adaptive/{k}"],
                                       np.asarray(want[k]), rtol=0,
                                       atol=TOL, err_msg=f"rank {r} {k}")


def test_strategies_through_the_fleet(cluster):
    """strategy.dgc and strategy.localsgd build their steps through
    fleet.distributed_train_step; the losses fall and DGC's sync is
    sparse."""
    assert str(cluster[0]["fleet_dgc/type"]) == "DGCStep"
    assert str(cluster[0]["fleet_localsgd/type"]) == "LocalSGDStep"
    for flag in ("dgc", "localsgd"):
        losses = cluster[0][f"fleet_{flag}/losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert float(cluster[0]["fleet_dgc/density"]) <= 0.35


def test_localsgd_averages_once_every_k_steps(cluster):
    """LocalSGD at k 4 all-reduces its parameters once in 4 steps (one
    flat all-reduce) beside each step's loss mean."""
    calls = json.loads(str(cluster[0]["localsgd_k4/calls"]))
    assert calls["all_reduce"] == 4 + 1, calls


@pytest.mark.parametrize("other", ["localsgd", "fp16_allreduce"])
def test_dgc_compose_conflicts_raise(other):
    s = fleet.DistributedStrategy()
    s.dgc = True
    setattr(s, other, True)
    with pytest.raises(NotImplementedError, match="dgc"):
        fleet.fleet.distributed_train_step(object(), None, None, s)


def test_localsgd_with_fp16_allreduce_raises():
    s = fleet.DistributedStrategy()
    s.localsgd = True
    s.fp16_allreduce = True
    with pytest.raises(NotImplementedError, match="localsgd"):
        fleet.fleet.distributed_train_step(object(), None, None, s)


def test_dgc_mask_matches_jax_quantile_above_2_24_elements():
    """DGC's threshold on bench_gpt's wte shape (32768 x 768 = 25.2 M
    elements, above torch.quantile's 2^24 limit): the same kept mask as
    jnp.quantile's at sparsity 0.999, and the same threshold."""
    rng = np.random.RandomState(5)
    v = np.abs(rng.randn(32768, 768).astype(np.float32))
    thr = jnp.quantile(jnp.asarray(v).ravel(), jnp.asarray(0.999,
                                                          jnp.float32))
    got = quantile_linear(torch.from_numpy(v), 0.999)
    assert float(got) == float(thr)
    want_mask = np.asarray(jnp.asarray(v) >= thr)
    np.testing.assert_array_equal((torch.from_numpy(v) >= got).numpy(),
                                  want_mask)
    kept = want_mask.mean()
    assert abs(kept - 0.001) < 1e-5
