"""The port's LeNet (paddle_tpu_torch.vision.models.lenet), MultiStepTrainStep
(paddle_tpu_torch.jit) and the pooler's tanh against the JAX package, on
the CPU.

Both packages get the same weights (`LeNet.load_jax_params` over the
numpy form of the JAX `state_dict()`) and the same numpy batches.
MultiStepTrainStep is held to the JAX MultiStepTrainStep (K 3, two
calls: the shape of tests/test_multistep_train.py's parity test) and to
K sequential TrainStep calls of the port.

Tolerances (float32; the frameworks sum convolutions and reductions in
different orders): logits within 1e-5 relative to the largest entry;
parameters within 0.1 % of one Adam step for each step taken, steps *
lr * 1e-3 absolute (an Adam step moves each weight by about lr whatever
its gradient's size, so the rounding of a small gradient shows in the
parameter at that scale, once a step): 1e-6 after one step at lr 1e-3,
6e-5 after the six multistep steps at lr 1e-2; the multistep losses
within rtol 1e-5, as the JAX package's own parity test holds its two
paths; the port's K steps in one call against K calls of its TrainStep
exactly (the same operations in the same order).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.vision.models import LeNet as JLeNet

from paddle_tpu_torch import jit
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.tools import train_bench
from paddle_tpu_torch.tools.train_bench import ce_loss_fn
from paddle_tpu_torch.vision.models import LeNet

K, CALLS = 3, 2


def _pair(seed=0):
    paddle.seed(seed)
    jm = JLeNet()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, LeNet(device="cpu").load_jax_params(state)


def _batches(n, bs=8, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, bs, 1, 28, 28).astype(np.float32),
            rng.randint(0, 10, (n, bs, 1)).astype(np.int64))


def _j_loss_fn(m, x, y):
    return JF.cross_entropy(m(x), y)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def test_names_and_shapes_equal_jax():
    paddle.seed(0)
    want = {k: tuple(v.shape) for k, v in JLeNet().state_dict().items()}
    got = {k: tuple(p.shape) for k, p in
           LeNet(device="cpu").named_parameters()}
    assert got == want
    assert LeNet(0, device="cpu")(torch.zeros(2, 1, 28, 28)).shape == \
        (2, 16, 5, 5)


def test_logits_match_jax():
    jm, tm = _pair()
    xs, _ = _batches(1)
    want = jm(paddle.to_tensor(xs[0])).numpy()
    got = tm(torch.from_numpy(xs[0])).detach().numpy()
    assert got.shape == (8, 10)
    assert _rel(got, want) <= 1e-5


def test_one_adam_step_matches_jax():
    jm, tm = _pair()
    xs, ys = _batches(1)
    jstep = paddle.jit.TrainStep(jm, _j_loss_fn, jopt.Adam(
        1e-3, parameters=jm.parameters()))
    tstep = jit.TrainStep(tm, ce_loss_fn, Adam(
        1e-3, parameters=tm.parameters()))
    jl = float(jstep(paddle.to_tensor(xs[0]), paddle.to_tensor(ys[0]))
               .numpy())
    tl = tstep(xs[0], ys[0]).item()
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    jp = jm.state_dict()
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_multistep_matches_jax_multistep():
    jm, tm = _pair(3)
    xs, ys = _batches(K * CALLS)
    jstep = paddle.jit.MultiStepTrainStep(jm, _j_loss_fn, jopt.Adam(
        1e-2, parameters=jm.parameters()), steps=K)
    tstep = jit.MultiStepTrainStep(tm, ce_loss_fn, Adam(
        1e-2, parameters=tm.parameters()), K)
    jl, tl = [], []
    for c in range(CALLS):
        sl = slice(c * K, (c + 1) * K)
        jl += np.asarray(jstep(paddle.to_tensor(xs[sl]),
                               paddle.to_tensor(ys[sl])).numpy(),
                         np.float64).tolist()
        out = tstep(xs[sl], ys[sl])
        assert tuple(out.shape) == (K,)
        tl += out.tolist()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jp = jm.state_dict()
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k].numpy(),
                                   rtol=0, atol=K * CALLS * 1e-2 * 1e-3,
                                   err_msg=k)
    assert tstep.optimizer._global_step == K * CALLS


def test_multistep_equals_sequential_port_steps():
    xs, ys = _batches(K * CALLS, seed=2)
    _, ta = _pair(4)
    _, tb = _pair(4)
    seq = jit.TrainStep(ta, ce_loss_fn, Adam(
        1e-2, parameters=ta.parameters()))
    multi = jit.MultiStepTrainStep(tb, ce_loss_fn, Adam(
        1e-2, parameters=tb.parameters()), K, False)
    la = [seq(xs[i], ys[i]).item() for i in range(K * CALLS)]
    lb = sum((multi(torch.from_numpy(xs[c * K:(c + 1) * K]),
                    ys[c * K:(c + 1) * K]).tolist()
              for c in range(CALLS)), [])
    assert la == lb
    for (k, a), (_, b) in zip(ta.named_parameters(),
                              tb.named_parameters()):
        assert torch.equal(a, b), k
    assert multi.optimizer._global_step == seq.optimizer._global_step


def test_multistep_rejects_unstacked_batches_and_bad_steps():
    _, tm = _pair()
    optim = Adam(1e-3, parameters=tm.parameters())
    step = jit.MultiStepTrainStep(tm, ce_loss_fn, optim, steps=4)
    xs, ys = _batches(4)
    with pytest.raises(ValueError, match="stacked"):
        step(xs[0], ys[0])
    with pytest.raises(ValueError, match="stacked"):
        step(xs, ys[:3])
    for bad in (0, -1):
        with pytest.raises(ValueError):
            jit.MultiStepTrainStep(tm, ce_loss_fn, optim, steps=bad)


def test_tanh_matches_jax():
    x = np.random.RandomState(3).randn(4, 7).astype(np.float32) * 3
    np.testing.assert_allclose(F.tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(JF.tanh(jnp.asarray(x)).numpy()),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("multistep", [None, 5])
def test_lenet_bench_runs_its_recipe(multistep):
    """run_lenet on the CPU at 10 steps: the stacked [K, 64, ...] batch
    for the multistep run, Adam(1e-3), one loss a step, the loss
    falling."""
    net, step, args = train_bench.build_lenet(0, multistep, "cpu")
    lead = (multistep,) if multistep else ()
    assert tuple(args[0].shape) == (*lead, 64, 1, 28, 28)
    assert tuple(args[1].shape) == (*lead, 64, 1)
    assert step.optimizer.get_lr() == 1e-3
    res = train_bench.run_lenet(multistep, 2, 10, built=(net, step, args))
    n = multistep or 1
    assert res["timed_steps"] == 10 and len(res["losses"]) == 2 * n + 10
    assert np.mean(res["losses"][-n:]) < np.mean(res["losses"][:n])
