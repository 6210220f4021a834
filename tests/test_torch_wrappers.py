"""The port's optimizer wrappers (paddle_tpu_torch.optimizer.wrappers:
ExponentialMovingAverage, ModelAverage, LookaheadOptimizer / Lookahead,
and incubate.optimizer's names for them) against the JAX package, on
the CPU.

Both packages train the same Linear(4, 2) (the JAX layer's weights
copied into the port's) on the same numpy batch; the shadow weights
that apply() swaps in, the live weights restore() brings back and the
Lookahead weights are held to the JAX package's within 1e-6 relative
(float32; both compute the same f32 expressions in the same order).
The twins of tests/test_strategies.py run each body on both packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt

import paddle_tpu_torch
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import incubate

X = np.random.RandomState(0).randn(16, 4).astype("float32")
Y = np.random.RandomState(1).randn(16, 2).astype("float32")


@pytest.fixture(autouse=True)
def _cpu_device():
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    place._default = prev


PKGS = {"jax": (paddle, jopt), "port": (paddle_tpu_torch, topt)}


def _toy(pkg, seed=0):
    """The toy model of tests/test_strategies.py; the port's takes the JAX
    layer's weights."""
    paddle.seed(seed)
    jm = paddle.nn.Linear(4, 2)
    if pkg == "jax":
        return jm
    tm = paddle_tpu_torch.nn.Linear(4, 2)
    tm.set_state_dict({k: np.array(v.numpy()) for k, v in
                       jm.state_dict().items()})
    return tm


def _loss(pkg, m):
    lib = PKGS[pkg][0]
    return ((m(lib.to_tensor(X)) - lib.to_tensor(Y)) ** 2).mean()


def _w(m):
    return np.array(m.weight.numpy())


def _train(pkg, opt, m, steps, after=None):
    for _ in range(steps):
        _loss(pkg, m).backward()
        opt.step()
        opt.clear_grad()
        if after is not None:
            after()


# --------------------------------------------------- against the JAX package
@pytest.mark.parametrize("thres_steps", [None, 100])
def test_ema_matches_jax(thres_steps):
    """5 SGD steps with an EMA(0.9) update after each (with thres_steps,
    the decay min(0.9, (1 + t) / (10 + t))): the applied shadows, the
    restored live weights and a state_dict round trip."""
    got = {}
    for pkg, (_, o) in PKGS.items():
        m = _toy(pkg)
        sgd = o.SGD(0.1, parameters=m.parameters())
        ema = o.ExponentialMovingAverage(0.9, thres_steps,
                                         parameters=m.parameters())
        _train(pkg, sgd, m, 5, ema.update)
        live = _w(m)
        with ema.apply():
            shadow = _w(m)
        np.testing.assert_array_equal(_w(m), live)
        got[pkg] = (shadow, live, ema.state_dict(), m)
    for a, e in zip(got["port"][:2], got["jax"][:2]):
        np.testing.assert_allclose(a, e, rtol=1e-6, atol=1e-7)
    state, m = got["port"][2:]
    assert state["ema_step"] == got["jax"][2]["ema_step"] == 5
    assert sorted(state) == sorted([f"{p.name}_ema" for p in m.parameters()]
                                   + ["ema_step"])
    # a new EMA over the same parameters takes the state and applies the
    # same shadows
    fresh = topt.ExponentialMovingAverage(0.9, parameters=m.parameters())
    fresh.set_state_dict({k: v if isinstance(v, int) else v.numpy()
                          for k, v in state.items()})
    assert fresh._step == 5
    with fresh.apply():
        np.testing.assert_array_equal(_w(m), got["port"][0])


def test_ema_apply_without_restore_then_restore():
    m = _toy("port")
    ema = topt.ExponentialMovingAverage(0.5, parameters=m.parameters())
    sgd = topt.SGD(0.1, parameters=m.parameters())
    _train("port", sgd, m, 2, ema.update)
    live = _w(m)
    with ema.apply(need_restore=False):
        shadow = _w(m)
    np.testing.assert_array_equal(_w(m), shadow)
    ema.restore()
    np.testing.assert_array_equal(_w(m), live)
    with pytest.raises(ValueError):
        topt.ExponentialMovingAverage(0.9)


@pytest.mark.parametrize("min_w,max_w,rate", [(2, 10, 0.15), (3, 4, 0.5),
                                              (100, 1000, 0.15)])
def test_model_average_matches_jax(min_w, max_w, rate):
    """7 SGD steps with ModelAverage.update after each: the applied
    average (sum_1/sum_2/sum_3 rotation) equals the JAX package's."""
    got = {}
    for pkg, (_, o) in PKGS.items():
        m = _toy(pkg)
        sgd = o.SGD(0.1, parameters=m.parameters())
        ma = o.ModelAverage(rate, parameters=m.parameters(),
                            min_average_window=min_w,
                            max_average_window=max_w)
        _train(pkg, sgd, m, 7, ma.update)
        live = _w(m)
        with ma.apply():
            avg = _w(m)
        np.testing.assert_array_equal(_w(m), live)
        got[pkg] = (avg, ma._num_accumulates, ma._old_num_accumulates)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=1e-6,
                               atol=1e-7)
    assert got["port"][1:] == got["jax"][1:]


@pytest.mark.parametrize("alpha,k", [(0.5, 2), (0.8, 3)])
def test_lookahead_matches_jax(alpha, k):
    """7 Momentum steps under LookaheadOptimizer(alpha, k): the weights
    after each sync and at the end equal the JAX package's; minimize
    returns the (param, grad) pairs."""
    got = {}
    for pkg, (_, o) in PKGS.items():
        m = _toy(pkg)
        la = o.LookaheadOptimizer(o.Momentum(0.05, 0.9,
                                             parameters=m.parameters()),
                                  alpha=alpha, k=k)
        trace = []
        _train(pkg, la, m, 7, lambda: trace.append(_w(m)))
        _, pairs = la.minimize(_loss(pkg, m))
        assert len(pairs) == 2 and all(g is not None for _, g in pairs)
        got[pkg] = trace + [_w(m)]
    np.testing.assert_allclose(np.array(got["port"]), np.array(got["jax"]),
                               rtol=1e-6, atol=1e-7)


def test_incubate_names():
    assert incubate.optimizer.LookAhead is topt.LookaheadOptimizer
    assert topt.Lookahead is topt.LookaheadOptimizer
    assert incubate.optimizer.ModelAverage is topt.ModelAverage
    assert incubate.optimizer.ExponentialMovingAverage is \
        topt.ExponentialMovingAverage


def test_ema_shadows_stay_f32_under_o2():
    """Under AMP O2 (bf16 parameters, f32 masters) through jit.TrainStep
    the shadows are f32 and follow the bf16 parameters:
    shadow = d * shadow + (1 - d) * float(param), checked by hand within
    1e-6; apply() casts them to bf16 and restore() brings the bf16 live
    weights back bitwise."""
    from paddle_tpu_torch import amp, jit
    m = _toy("port")
    opt = topt.Momentum(0.1, parameters=m.parameters())
    m, opt = amp.decorate(m, opt, level="O2", dtype="bfloat16")
    ema = topt.ExponentialMovingAverage(0.99, parameters=m.parameters())
    manual = [p.detach().float().clone() for p in m.parameters()]
    step = jit.TrainStep(m, lambda mm, x, y: ((mm(x) - y) ** 2).mean(), opt)
    for _ in range(4):
        step(torch.from_numpy(X).bfloat16(), torch.from_numpy(Y).bfloat16())
        ema.update()
        manual = [0.99 * s + 0.01 * p.detach().float()
                  for s, p in zip(manual, m.parameters())]
    for s, w in zip(ema._shadow.values(), manual):
        assert s.dtype == torch.float32
        assert (s - w).abs().max().item() <= 1e-6
    live = [p.detach().clone() for p in m.parameters()]
    with ema.apply():
        for p, w in zip(m.parameters(), manual):
            assert p.dtype == torch.bfloat16
            assert torch.equal(p.detach(), w.bfloat16())
    for p, w in zip(m.parameters(), live):
        assert torch.equal(p.detach(), w)


# ------------------------------------------- twins of test_strategies.py
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ema_matches_manual(pkg):
    lib, o = PKGS[pkg]
    model = _toy(pkg)
    sgd = o.SGD(0.1, parameters=model.parameters())
    ema = o.ExponentialMovingAverage(0.9, parameters=model.parameters())
    manual = _w(model).astype(np.float64)
    for _ in range(3):
        _loss(pkg, model).backward()
        sgd.step()
        sgd.clear_grad()
        ema.update()
        manual = 0.9 * manual + 0.1 * _w(model)
    live = _w(model).copy()
    with ema.apply():
        np.testing.assert_allclose(_w(model), manual, rtol=1e-5)
    np.testing.assert_allclose(_w(model), live)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_model_average_matches_mean(pkg):
    lib, o = PKGS[pkg]
    model = _toy(pkg)
    sgd = o.SGD(0.1, parameters=model.parameters())
    ma = o.ModelAverage(0.15, parameters=model.parameters(),
                        min_average_window=2, max_average_window=10)
    snaps = []
    for _ in range(4):
        _loss(pkg, model).backward()
        sgd.step()
        sgd.clear_grad()
        ma.update()
        snaps.append(_w(model).copy())
    with ma.apply():
        np.testing.assert_allclose(_w(model), np.mean(snaps[2:], axis=0),
                                   rtol=1e-4)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_lookahead_slow_weights(pkg):
    lib, o = PKGS[pkg]
    model = _toy(pkg)
    inner = o.SGD(0.1, parameters=model.parameters())
    la = o.LookaheadOptimizer(inner, alpha=0.5, k=2)
    w0 = _w(model).astype(np.float64)
    fast = [w0.copy()]
    for _ in range(2):
        _loss(pkg, model).backward()
        g = np.array(model.weight.grad.numpy())
        fast.append(fast[-1] - 0.1 * g)
        la.step()
        la.clear_grad()
    expected = w0 + 0.5 * (fast[-1] - w0)
    np.testing.assert_allclose(_w(model), expected, rtol=1e-4)
    with pytest.raises(ValueError):
        o.LookaheadOptimizer(inner, alpha=1.5)
    with pytest.raises(ValueError):
        o.LookaheadOptimizer(inner, k=0)
