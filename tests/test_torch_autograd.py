"""Twins of tests/test_autograd.py on the port's eager surface, on the
CPU.

Each case runs its body on `paddle_tpu` and on `paddle_tpu_torch` (the
same numpy inputs) and holds the port to the JAX package's results
(float32, 1e-6 unless a case says otherwise) as well as to the
original's assertions. `test_double_grad_under_jit` wraps the gradient
penalty in `paddle.jit.to_static`: the JAX package compiles it, the
port runs it eagerly (jit/__init__.py), with the same results.

One case differs by design: after an in-place `set_value` on a tensor a
graph saved, the JAX package differentiates with the forward-time
value, while the port, like Paddle's eager mode, refuses (torch's
version counter) instead of using the new value.
"""
import numpy as np
import pytest
import torch

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


def _np(t):
    return None if t is None else np.asarray(t.numpy())


def _twin(body, rtol=1e-6, atol=1e-6):
    """body(paddle) -> list of arrays (or None); the port's must match
    the JAX package's."""
    want, got = (body(p) for p in PKGS)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return got


def test_backward_matmul_chain():
    rng = np.random.RandomState(0)
    xn, wn = rng.randn(3, 4).astype("float32"), rng.randn(4, 5).astype(
        "float32")

    def body(paddle):
        x = paddle.to_tensor(xn, stop_gradient=False)
        w = paddle.to_tensor(wn, stop_gradient=False)
        loss = (paddle.matmul(x, w) * 2.0 + 1.0).sum()
        loss.backward()
        return [_np(w.grad), _np(x.grad)]
    wg, xg = _twin(body, rtol=1e-5)
    np.testing.assert_allclose(wg, 2 * xn.T @ np.ones((3, 5)), rtol=1e-5)
    np.testing.assert_allclose(xg, 2 * np.ones((3, 5)) @ wn.T, rtol=1e-5)


def test_grad_accumulation_across_backwards():
    def body(paddle):
        x = paddle.to_tensor([2.0], stop_gradient=False)
        (x * x).sum().backward()
        (x * x).sum().backward()
        g = _np(x.grad)
        x.clear_grad()
        assert x.grad is None
        return [g]
    (g,) = _twin(body)
    assert abs(g[0] - 8.0) < 1e-6


def test_stop_gradient_prunes_graph():
    def body(paddle):
        x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
        y = paddle.to_tensor([3.0, 4.0], stop_gradient=True)
        (x * y).sum().backward()
        assert y.grad is None
        return [_np(x.grad)]
    (g,) = _twin(body)
    np.testing.assert_allclose(g, [3.0, 4.0])


def test_detach_breaks_graph():
    for paddle in PKGS:
        x = paddle.to_tensor([1.0], stop_gradient=False)
        d = (x * 2).detach()
        assert d.stop_gradient
        assert (d * 3).stop_gradient


def test_second_backward_raises_without_retain():
    for paddle in PKGS:
        x = paddle.to_tensor([1.0], stop_gradient=False)
        loss = (x * x).sum()
        loss.backward()
        with pytest.raises(RuntimeError):
            loss.backward()


def test_retain_graph():
    def body(paddle):
        x = paddle.to_tensor([3.0], stop_gradient=False)
        loss = (x * x).sum()
        loss.backward(retain_graph=True)
        loss.backward()
        return [_np(x.grad)]
    (g,) = _twin(body)
    assert abs(g[0] - 12.0) < 1e-6


def test_paddle_grad_api():
    def body(paddle):
        x = paddle.to_tensor([2.0], stop_gradient=False)
        (g,) = paddle.grad(x * x * x, x)
        assert x.grad is None
        return [_np(g)]
    (g,) = _twin(body)
    assert abs(g[0] - 12.0) < 1e-5


def test_grad_unused_raises_and_allow_unused():
    for paddle in PKGS:
        x = paddle.to_tensor([1.0], stop_gradient=False)
        u = paddle.to_tensor([1.0], stop_gradient=False)
        with pytest.raises(RuntimeError):
            paddle.grad(x * 2, [u])
        assert paddle.grad(x * 2, [u], allow_unused=True)[0] is None


def test_no_grad_context():
    for paddle in PKGS:
        x = paddle.to_tensor([1.0], stop_gradient=False)
        with paddle.no_grad():
            y = x * 2
        assert y.stop_gradient
        assert paddle.is_grad_enabled()


def test_register_hook_scales_grad():
    def body(paddle):
        x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
        h = x.register_hook(lambda g: g * 2)
        (x * 3).sum().backward()
        h.remove()
        return [_np(x.grad)]
    (g,) = _twin(body)
    np.testing.assert_allclose(g, [6.0, 6.0])


def test_indexing_grad():
    def body(paddle):
        a = paddle.ones([4, 4])
        a.stop_gradient = False
        a[1:3, :2].sum().backward()
        return [_np(a.grad)]
    (g,) = _twin(body)
    expected = np.zeros((4, 4), np.float32)
    expected[1:3, :2] = 1
    np.testing.assert_allclose(g, expected)


def test_setitem_inplace_grad():
    def body(paddle):
        x = paddle.zeros([4])
        x.stop_gradient = False
        v = paddle.to_tensor([5.0], stop_gradient=False)
        y = x * 2
        y[1] = v * 3
        y.sum().backward()
        return [_np(v.grad), _np(x.grad)]
    vg, xg = _twin(body)
    assert abs(vg[0] - 3.0) < 1e-6
    np.testing.assert_allclose(xg, [2, 0, 2, 2])


def test_inplace_add_participates_in_autograd():
    def body(paddle):
        x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 2
        y.add_(paddle.to_tensor([10.0, 10.0]))
        y.sum().backward()
        return [_np(x.grad), _np(y)]
    xg, y = _twin(body)
    np.testing.assert_allclose(xg, [2.0, 2.0])
    np.testing.assert_allclose(y, [12.0, 14.0])


def test_multi_output_op_grad():
    def body(paddle):
        x = paddle.to_tensor(np.arange(6, dtype="float32").reshape(2, 3),
                             stop_gradient=False)
        a, b, c = paddle.split(x, 3, axis=1)
        (a.sum() * 1 + b.sum() * 2).backward()
        return [_np(x.grad)]
    (g,) = _twin(body)
    np.testing.assert_allclose(g, [[1, 2, 0], [1, 2, 0]])


def test_grad_through_concat_stack():
    def body(paddle):
        x = paddle.ones([2, 2])
        x.stop_gradient = False
        y = paddle.concat([x, x * 2], axis=0)
        z = paddle.stack([x, x * 3], axis=1)
        (y.sum() + z.sum()).backward()
        return [_np(x.grad), _np(z)]
    g, z = _twin(body)
    np.testing.assert_allclose(g, np.full((2, 2), 7.0))
    assert z.shape == (2, 2, 2)


def test_hooks_on_intermediate():
    def body(paddle):
        x = paddle.to_tensor([1.0], stop_gradient=False)
        mid = x * 2
        seen = []
        mid.register_hook(lambda g: seen.append(np.asarray(g)))
        (mid * 3).backward()
        return [seen[0], _np(x.grad)]
    seen, g = _twin(body)
    assert abs(seen[0] - 3.0) < 1e-6 and abs(g[0] - 6.0) < 1e-6


def test_check_nan_inf_flag():
    for paddle in PKGS:
        paddle.set_flags({"FLAGS_check_nan_inf": True})
        try:
            x = paddle.to_tensor([1.0])
            with pytest.raises(FloatingPointError):
                paddle.log(x - 2.0) * 0 + paddle.sqrt(x - 5.0)
        finally:
            paddle.set_flags({"FLAGS_check_nan_inf": False})
        assert paddle.get_flags("FLAGS_check_nan_inf") == {
            "FLAGS_check_nan_inf": False}


# ---------------------------------------------------------------- double grad
def test_double_grad_basic():
    def body(paddle):
        x = paddle.to_tensor(np.array([2.0, -1.5], np.float32),
                             stop_gradient=False)
        (gx,) = paddle.grad((x ** 3).sum(), [x], create_graph=True)
        assert not gx.stop_gradient
        (ggx,) = paddle.grad(gx.sum(), [x])
        return [_np(gx), _np(ggx)]
    gx, ggx = _twin(body, rtol=1e-5)
    np.testing.assert_allclose(gx, 3 * np.array([4.0, 2.25]), rtol=1e-5)
    np.testing.assert_allclose(ggx, 6 * np.array([2.0, -1.5]), rtol=1e-5)


def test_triple_grad():
    def body(paddle):
        x = paddle.to_tensor(np.array([1.3], np.float32),
                             stop_gradient=False)
        (g1,) = paddle.grad(x ** 4, [x], create_graph=True)
        (g2,) = paddle.grad(g1, [x], create_graph=True)
        (g3,) = paddle.grad(g2, [x])
        return [_np(g3)]
    (g3,) = _twin(body, rtol=1e-5)
    np.testing.assert_allclose(g3, [24 * 1.3], rtol=1e-5)


def test_double_grad_matches_torch():
    rng = np.random.RandomState(1)
    xn = rng.randn(3, 4).astype("float32")
    wn = rng.randn(4, 2).astype("float32")

    def body(paddle):
        x = paddle.to_tensor(xn, stop_gradient=False)
        w = paddle.to_tensor(wn, stop_gradient=False)
        out = paddle.tanh(paddle.matmul(x, w)).sum()
        (gx,) = paddle.grad(out, [x], create_graph=True)
        (gx ** 2).sum().backward()
        return [_np(w.grad)]
    (got,) = _twin(body, rtol=1e-4, atol=1e-5)
    xt = torch.tensor(xn, requires_grad=True)
    wt = torch.tensor(wn, requires_grad=True)
    (gxt,) = torch.autograd.grad(torch.tanh(xt @ wt).sum(), [xt],
                                 create_graph=True)
    (gxt ** 2).sum().backward()
    np.testing.assert_allclose(got, wt.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_gradient_penalty_wgan_gp_style():
    """WGAN-GP: the penalty on the critic's input-gradient norm reaches
    the critic's weights. The streams of paddle.seed differ, so the
    port's critic takes the JAX one's weights."""
    xn = np.random.RandomState(2).randn(8, 5).astype("float32")
    paddle_tpu.seed(0)
    jcritic = paddle_tpu.nn.Linear(5, 1)
    state = {k: v.numpy() for k, v in jcritic.state_dict().items()}

    def body(paddle):
        paddle.seed(0)
        critic = paddle.nn.Linear(5, 1)
        critic.set_state_dict(state)
        xs = paddle.to_tensor(xn, stop_gradient=False)
        (gx,) = paddle.grad(critic(xs).sum(), [xs], create_graph=True)
        gp = ((paddle.sqrt((gx ** 2).sum(axis=1) + 1e-12) - 1.0)
              ** 2).mean()
        gp.backward()
        return [_np(critic.weight.grad), _np(gp)]
    wg, _ = _twin(body, rtol=1e-5)
    assert np.linalg.norm(wg) > 0


def test_double_grad_allow_unused_and_no_grad_vars():
    def body(paddle):
        x = paddle.to_tensor(np.array([1.0], np.float32),
                             stop_gradient=False)
        z = paddle.to_tensor(np.array([2.0], np.float32),
                             stop_gradient=False)
        gx, gz = paddle.grad((x * 3.0).sum(), [x, z], create_graph=True,
                             allow_unused=True)
        assert gz is None
        with pytest.raises(RuntimeError):
            paddle.grad((x * 2).sum(), [z], create_graph=True)
        # no_grad_vars stops the gradient through y: only the direct
        # path from x counts
        y = x * 4.0
        (gx2,) = paddle.grad((y * x).sum(), [x], no_grad_vars=[y])
        return [_np(gx), _np(gx2)]
    gx, gx2 = _twin(body)
    np.testing.assert_allclose(gx, [3.0])
    np.testing.assert_allclose(gx2, [4.0])


def test_double_grad_under_jit():
    """Gradient penalty under paddle.jit.to_static: paddle.enable_grad()
    inside opts the tape back in, so paddle.grad(create_graph=True)
    composes; jit and eager agree in each package (1e-5 / 1e-4, the
    original's limits) and the packages agree (1e-5), from the same
    critic weights."""
    rng = np.random.RandomState(0)
    wn, bn = rng.randn(5, 1).astype("float32"), rng.randn(1).astype(
        "float32")
    xn = rng.randn(8, 5).astype("float32")

    def body(paddle):
        critic = paddle.nn.Linear(5, 1)
        critic.weight.set_value(wn)
        critic.bias.set_value(bn)

        def gp_fn(x):
            x.stop_gradient = False
            with paddle.enable_grad():
                score = critic(x).sum()
                (gx,) = paddle.grad(score, [x], create_graph=True)
                gp = ((((gx ** 2).sum(axis=1)) ** 0.5 - 1.0) ** 2).mean()
                (gw,) = paddle.grad(gp, [critic.weight])
            return gp, gw

        eager_gp, eager_gw = gp_fn(paddle.to_tensor(xn))
        jit_gp, jit_gw = paddle.jit.to_static(gp_fn)(paddle.to_tensor(xn))
        np.testing.assert_allclose(_np(jit_gp), _np(eager_gp), rtol=1e-5)
        np.testing.assert_allclose(_np(jit_gw), _np(eager_gw), rtol=1e-4,
                                   atol=1e-6)
        return [_np(jit_gp), _np(jit_gw)]
    _twin(body, rtol=1e-5, atol=1e-6)


def test_double_grad_uses_forward_time_values():
    """The JAX package differentiates with the forward-time value of a
    tensor that set_value later overwrote; the port, like Paddle's eager
    mode, refuses (the in-place write bumped the tensor's version)
    rather than use the new value."""
    results = []
    for paddle in PKGS:
        w = paddle.to_tensor(np.array([2.0], np.float32),
                             stop_gradient=False)
        x = paddle.to_tensor(np.array([3.0], np.float32),
                             stop_gradient=False)
        y = (w * x).sum()
        with paddle.no_grad():
            w.set_value(paddle.to_tensor(np.array([100.0], np.float32)))
        try:
            (gx,) = paddle.grad(y, [x], create_graph=True)
            results.append(_np(gx))
        except RuntimeError as e:
            assert "modified by an inplace operation" in str(e)
            results.append("refused")
        np.testing.assert_allclose(_np(w), [100.0])
    np.testing.assert_allclose(results[0], [2.0])
    assert results[1] == "refused"


def test_double_grad_duplicate_inputs():
    def body(paddle):
        x = paddle.to_tensor(np.array([2.0], np.float32),
                             stop_gradient=False)
        g1, g2 = paddle.grad((x ** 2).sum(), [x, x], create_graph=True)
        return [_np(g1), _np(g2)]
    g1, g2 = _twin(body)
    np.testing.assert_allclose(g1, [4.0])
    np.testing.assert_allclose(g2, [4.0])


def test_double_grad_stop_gradient_input_raises():
    for paddle in PKGS:
        s = paddle.to_tensor(np.array([1.0], np.float32))
        w = paddle.to_tensor(np.array([2.0], np.float32),
                             stop_gradient=False)
        z = (s * w).sum()
        with pytest.raises(RuntimeError):
            paddle.grad(z, [s], create_graph=True)
        (gs,) = paddle.grad(z, [s], create_graph=True, allow_unused=True)
        assert gs is None
