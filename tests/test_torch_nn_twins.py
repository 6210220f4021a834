"""Twins of tests in tests/test_nn.py and tests/test_optimizer.py, run
on the port (paddle_tpu_torch) on the CPU, with the same bodies and the
same torch oracles and tolerances as the originals.

test_nn.py: test_transformer_encoder_decoder, test_rnn_shapes_and_grads,
test_lstm_cell_matches_torch, test_losses_match_torch,
test_activations_match_torch, test_dropout_semantics,
test_clip_grad_by_global_norm, test_weight_norm. test_optimizer.py:
test_sgd, test_rmsprop, test_adagrad, test_momentum_nesterov,
test_lamb_trust_ratio_moves.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as tF

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
import paddle_tpu_torch.optimizer as opt
from paddle_tpu_torch.core import place as _place

_ATOL, _RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    paddle.set_device("cpu")
    yield
    _place._default = prev


# ------------------------------------------------------ tests/test_nn.py
def test_losses_match_torch():
    logits = np.random.randn(8, 5).astype("float32")
    labels = np.random.randint(0, 5, 8)
    np.testing.assert_allclose(
        F.cross_entropy(paddle.to_tensor(logits),
                        paddle.to_tensor(labels)).numpy(),
        tF.cross_entropy(torch.tensor(logits),
                         torch.tensor(labels)).numpy(), rtol=1e-5)
    x = np.random.rand(6).astype("float32")
    y = (np.random.rand(6) > 0.5).astype("float32")
    np.testing.assert_allclose(
        F.binary_cross_entropy(paddle.to_tensor(x),
                               paddle.to_tensor(y)).numpy(),
        tF.binary_cross_entropy(torch.tensor(x), torch.tensor(y)).numpy(),
        rtol=1e-4)
    lx = np.random.randn(6).astype("float32")
    np.testing.assert_allclose(
        F.binary_cross_entropy_with_logits(paddle.to_tensor(lx),
                                           paddle.to_tensor(y)).numpy(),
        tF.binary_cross_entropy_with_logits(torch.tensor(lx),
                                            torch.tensor(y)).numpy(),
        rtol=1e-5)
    a = np.random.randn(4, 7).astype("float32")
    b = np.random.randn(4, 7).astype("float32")
    np.testing.assert_allclose(
        F.smooth_l1_loss(paddle.to_tensor(a), paddle.to_tensor(b)).numpy(),
        tF.smooth_l1_loss(torch.tensor(a), torch.tensor(b)).numpy(),
        rtol=1e-5)
    np.testing.assert_allclose(
        F.kl_div(paddle.to_tensor(a), paddle.to_tensor(np.abs(b))).numpy(),
        tF.kl_div(torch.tensor(a), torch.tensor(np.abs(b))).numpy(),
        rtol=1e-4, atol=1e-5)


def test_activations_match_torch():
    x = np.random.randn(4, 8).astype("float32")
    cases = [
        (F.gelu, lambda t: tF.gelu(t)),
        (lambda v: F.gelu(v, approximate=True),
         lambda t: tF.gelu(t, approximate="tanh")),
        (F.silu, tF.silu),
        (F.softplus, tF.softplus),
        (F.elu, tF.elu),
        (F.selu, tF.selu),
        (F.hardswish, tF.hardswish),
        (F.mish, tF.mish),
        (lambda v: F.leaky_relu(v, 0.1),
         lambda t: tF.leaky_relu(t, 0.1)),
        (lambda v: F.log_softmax(v, -1),
         lambda t: tF.log_softmax(t, -1)),
    ]
    for mine, ref in cases:
        np.testing.assert_allclose(
            mine(paddle.to_tensor(x)).numpy(),
            ref(torch.tensor(x)).numpy(), rtol=_RTOL, atol=_ATOL)


def test_dropout_semantics():
    x = paddle.ones([1000])
    out = F.dropout(x, 0.5, training=True)
    kept = float((out.numpy() != 0).mean())
    assert 0.35 < kept < 0.65
    np.testing.assert_allclose(out.numpy()[out.numpy() != 0], 2.0)
    out_eval = F.dropout(x, 0.5, training=False)
    np.testing.assert_allclose(out_eval.numpy(), x.numpy())


def test_transformer_encoder_decoder():
    model = nn.Transformer(d_model=32, nhead=4, num_encoder_layers=2,
                           num_decoder_layers=2, dim_feedforward=64)
    src = paddle.randn([2, 6, 32])
    tgt = paddle.randn([2, 5, 32])
    out = model(src, tgt)
    assert out.shape == [2, 5, 32]
    out.mean().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_rnn_shapes_and_grads():
    for cls, states in [(nn.SimpleRNN, 1), (nn.GRU, 1), (nn.LSTM, 2)]:
        m = cls(5, 7, num_layers=2)
        x = paddle.randn([3, 6, 5])
        y, final = m(x)
        assert y.shape == [3, 6, 7]
        y.sum().backward()
        assert all(p.grad is not None for p in m.parameters())


def test_lstm_cell_matches_torch():
    cell = nn.LSTMCell(4, 6)
    tcell = torch.nn.LSTMCell(4, 6)
    # copy weights
    cell.weight_ih.set_value(tcell.weight_ih.detach().numpy())
    cell.weight_hh.set_value(tcell.weight_hh.detach().numpy())
    cell.bias_ih.set_value(tcell.bias_ih.detach().numpy())
    cell.bias_hh.set_value(tcell.bias_hh.detach().numpy())
    x = np.random.randn(2, 4).astype("float32")
    h0 = np.random.randn(2, 6).astype("float32")
    c0 = np.random.randn(2, 6).astype("float32")
    _, (h, c) = cell(paddle.to_tensor(x),
                     (paddle.to_tensor(h0), paddle.to_tensor(c0)))
    th, tc = tcell(torch.tensor(x), (torch.tensor(h0), torch.tensor(c0)))
    np.testing.assert_allclose(h.numpy(), th.detach().numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(c.numpy(), tc.detach().numpy(), rtol=1e-4,
                               atol=1e-5)


def test_clip_grad_by_global_norm():
    m = nn.Linear(3, 3)
    (m(paddle.ones([2, 3])) * 100).sum().backward()
    clip = nn.ClipGradByGlobalNorm(1.0)
    pg = clip([(p, p.grad) for p in m.parameters()])
    total = np.sqrt(sum((g.numpy() ** 2).sum() for _, g in pg))
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


def test_weight_norm():
    from paddle_tpu_torch.nn.utils import weight_norm, remove_weight_norm
    m = nn.Linear(4, 5)
    weight_norm(m, "weight")
    x = paddle.randn([2, 4])
    y1 = m(x).numpy()
    assert "weight_g" in dict(m.named_parameters())
    remove_weight_norm(m)
    y2 = m(x).numpy()
    np.testing.assert_allclose(y1, y2, rtol=1e-4, atol=1e-5)


# ------------------------------------------------ tests/test_optimizer.py
def _compare_with_torch(make_mine, make_torch, steps=15, rtol=1e-4,
                        atol=1e-5):
    w0 = np.random.randn(5, 3).astype("float32")
    X = np.random.randn(16, 5).astype("float32")
    Y = np.random.randn(16, 3).astype("float32")
    p = paddle.to_tensor(w0.copy(), stop_gradient=False)
    p.trainable = True
    o = make_mine([p])
    tp = torch.tensor(w0.copy(), requires_grad=True)
    to = make_torch([tp])
    for _ in range(steps):
        ((paddle.to_tensor(X) @ p - paddle.to_tensor(Y)) ** 2).mean() \
            .backward()
        o.step()
        o.clear_grad()
        to.zero_grad()
        ((torch.tensor(X) @ tp - torch.tensor(Y)) ** 2).mean().backward()
        to.step()
    np.testing.assert_allclose(p.numpy(), tp.detach().numpy(), rtol=rtol,
                               atol=atol)


def test_sgd():
    _compare_with_torch(lambda ps: opt.SGD(0.05, parameters=ps),
                        lambda ps: torch.optim.SGD(ps, lr=0.05))


def test_momentum_nesterov():
    _compare_with_torch(
        lambda ps: opt.Momentum(0.02, 0.9, parameters=ps,
                                use_nesterov=True),
        lambda ps: torch.optim.SGD(ps, lr=0.02, momentum=0.9,
                                   nesterov=True), rtol=1e-3, atol=1e-4)


def test_rmsprop():
    _compare_with_torch(
        lambda ps: opt.RMSProp(0.01, rho=0.9, epsilon=1e-8, parameters=ps),
        lambda ps: torch.optim.RMSprop(ps, lr=0.01, alpha=0.9, eps=1e-8),
        rtol=2e-3, atol=1e-3)


def test_adagrad():
    _compare_with_torch(
        lambda ps: opt.Adagrad(0.05, epsilon=1e-10, parameters=ps),
        lambda ps: torch.optim.Adagrad(ps, lr=0.05), rtol=2e-3, atol=1e-4)


def test_lamb_trust_ratio_moves():
    p = paddle.to_tensor(np.ones((4, 4), np.float32), stop_gradient=False)
    p.trainable = True
    o = opt.Lamb(0.01, parameters=[p])
    (p ** 2).sum().backward()
    o.step()
    assert not np.allclose(p.numpy(), 1.0)
