"""Twins of tests/test_dtype_promotion.py on the port, on the CPU: the
same expressions keep the same dtypes in both packages (f32 and bf16
stay, Python and numpy scalars do not widen, int and bool division
gives float32).

`test_train_step_no_f64_in_module` scans the JAX package's compiled
StableHLO for f64 arrays; the port has no compiled program, so its twin
records the dtype of every tensor operation that one jit.TrainStep call
runs (a TorchDispatchMode) and requires no float64 among them.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import place as _place

PKGS = (paddle_tpu, paddle_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    _place._default = prev


def _names(dtypes):
    return [str(d).replace("torch.", "").replace("float64", "f64")
            for d in dtypes]


def test_scalar_arith_stays_f32():
    for paddle in PKGS:
        x = paddle.ones([4], dtype="float32")
        for expr in (x * 2.0, x + 0.5, 2.0 * x, x / 3.0, x - 1.0,
                     x ** 2.0, x * np.pi):
            assert expr.dtype == paddle.float32, (paddle.__name__,
                                                  expr.dtype)


def test_functional_surface_stays_f32():
    x = np.random.RandomState(0).randn(4, 8).astype("float32")
    lab = np.random.RandomState(1).randint(0, 8, (4,))
    got = []
    for paddle in PKGS:
        F = paddle.nn.functional
        paddle.seed(0)
        t = paddle.to_tensor(x)
        outs = [F.softmax(t), F.gelu(t), F.layer_norm(t, [8]),
                F.dropout(t, 0.5, training=True),
                F.cross_entropy(t, paddle.to_tensor(lab)),
                paddle.nn.Linear(8, 4)(t)]
        assert all(o.dtype == paddle.float32 for o in outs)
        got.append([o.numpy() for o in outs[:3]] + [outs[4].numpy()])
    for g, w in zip(got[1], got[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_layer_forward_bf16_stays_bf16():
    x = np.random.RandomState(2).randn(2, 8).astype("float32")
    for paddle in PKGS:
        paddle.seed(0)
        lin = paddle.nn.Linear(8, 4)
        lin.to(dtype="bfloat16")
        out = lin(paddle.to_tensor(x).astype("bfloat16"))
        assert out.dtype == paddle.bfloat16, out.dtype
        assert (out * 2.0).dtype == paddle.bfloat16


def test_optimizer_keeps_param_dtype():
    for paddle in PKGS:
        paddle.seed(0)
        lin = paddle.nn.Linear(4, 2)
        opt = paddle.optimizer.Adam(1e-3, parameters=lin.parameters())
        (lin(paddle.ones([2, 4])) ** 2).mean().backward()
        opt.step()
        for p in lin.parameters():
            assert p.dtype == paddle.float32, (p.name, p.dtype)


class _Dtypes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if torch.is_tensor(t):
                self.seen.add(t.dtype)
        return out


def test_train_step_no_f64_in_module():
    """Every tensor one TrainStep call (forward, backward, clip, AdamW)
    produces is float32 or integer: no float64."""
    paddle = paddle_tpu_torch
    paddle.seed(0)
    model = paddle.nn.Sequential(paddle.nn.Linear(8, 8), paddle.nn.GELU(),
                                 paddle.nn.Linear(8, 2))
    optim = paddle.optimizer.AdamW(
        1e-3, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    step = paddle.jit.TrainStep(
        model, lambda m, x, y: paddle.nn.functional.cross_entropy(m(x), y),
        optim)
    x = paddle.to_tensor(np.random.randn(4, 8).astype("float32"))
    y = paddle.to_tensor(np.random.randint(0, 2, (4, 1)))
    with _Dtypes() as mode:
        loss = step(x, y)
    assert torch.float64 not in mode.seen, _names(mode.seen)
    assert torch.float32 in mode.seen and loss.dtype == paddle.float32


def test_numpy_scalars_are_not_weak():
    for paddle in PKGS:
        x = paddle.ones([4], dtype="float32")
        s = np.float64(2.0)
        assert (x * s).dtype == paddle.float32
        assert (s * x).dtype == paddle.float32
        b = x.astype("bfloat16")
        assert (b * np.float64(2.0)).dtype != paddle.float64


def test_bool_and_int_division_promotion():
    for paddle in PKGS:
        mask = paddle.to_tensor(np.array([True, False]))
        assert (mask * 0.5).dtype == paddle.float32
        ints = paddle.ones([3], dtype="int64")
        assert (ints / 2).dtype == paddle.float32
        assert (ints / 2.0).dtype == paddle.float32
        assert paddle.divide(ints, paddle.to_tensor(
            np.array([2, 2, 2]))).dtype == paddle.float32
