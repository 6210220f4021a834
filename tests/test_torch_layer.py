"""The port's Layer against the JAX package's, on the CPU: forward
hooks, parameter and state-dict names, create_parameter with ParamAttr,
the default initializers drawn at construction (ROADMAP Queue 3 item 1)
and Sequential's named forms (Queue 3 item 5); also paddle.seed's
generators and set_device.

The two packages draw from different random streams (threefry folded
counters against one torch.Generator per device), so weights drawn by
paddle.seed are compared as distributions, never as values; where a
case compares values, the port takes the JAX layer's weights.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import tensor as jtensor
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.core import tensor as ttensor

PKGS = (paddle_tpu, paddle_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    _place._default = prev


def _aligned(build_jax, build_port):
    """Build a JAX object and a port object with both packages'
    tensor-name counters started at the same value (past both), so
    parameters made in the same order get the same generated names. The
    counters are only ever advanced: names already given stay unique."""
    n = max(jtensor._tensor_name_counter[0], ttensor._tensor_name_counter[0])
    jtensor._tensor_name_counter[0] = n
    j = build_jax()
    ttensor._tensor_name_counter[0] = n
    t = build_port()
    n = max(jtensor._tensor_name_counter[0], ttensor._tensor_name_counter[0])
    jtensor._tensor_name_counter[0] = ttensor._tensor_name_counter[0] = n
    return j, t


def _mlp(paddle):
    class Block(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.Linear(4, 6)
            self.norm = paddle.nn.LayerNorm(6)

        def forward(self, x):
            return self.norm(self.fc(x))

    class Net(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = paddle.nn.LayerList([Block(), Block()])
            self.blocks[1].fc = paddle.nn.Linear(6, 6)
            self.head = paddle.nn.Linear(6, 3, bias_attr=False)

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return self.head(x)
    return Net()


def _copy_state(src, dst):
    dst.set_state_dict({k: v.numpy() for k, v in src.state_dict().items()})


# ------------------------------------------------------------ names
def test_named_parameters_and_state_dict_names_equal_jax():
    jm, tm = _aligned(lambda: _mlp(paddle_tpu),
                      lambda: _mlp(paddle_tpu_torch))
    jnames = [k for k, _ in jm.named_parameters()]
    assert [k for k, _ in tm.named_parameters()] == jnames
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [p.name for p in tm.parameters()] == \
        [p.name for p in jm.parameters()]
    assert [n for n, _ in tm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert isinstance(tm.parameters(), list)
    x = np.random.RandomState(0).randn(5, 4).astype("float32")
    _copy_state(jm, tm)
    np.testing.assert_allclose(tm(paddle_tpu_torch.to_tensor(x)).numpy(),
                               jm(paddle_tpu.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_set_state_dict_reports_missing_and_unexpected():
    for paddle in PKGS:
        m = paddle.nn.Linear(3, 2)
        state = {"weight": np.ones((3, 2), np.float32),
                 "extra": np.zeros(1, np.float32)}
        missing, unexpected = m.set_state_dict(state)
        assert (missing, unexpected) == (["bias"], ["extra"])
        np.testing.assert_array_equal(m.weight.numpy(), np.ones((3, 2)))
        with pytest.raises(ValueError):
            m.set_state_dict({"weight": np.ones((2, 2), np.float32)})


# ------------------------------------------------------------ hooks
def test_forward_hooks_and_their_removal():
    x = np.random.RandomState(1).randn(2, 4).astype("float32")
    outs = []
    for paddle in PKGS:
        paddle.seed(0)
        m = paddle.nn.Linear(4, 3)
        m.set_state_dict({"weight": np.full((4, 3), 0.5, np.float32),
                          "bias": np.arange(3, dtype=np.float32)})
        seen = []
        pre = m.register_forward_pre_hook(
            lambda layer, inp: (inp[0] * 2,))
        post = m.register_forward_post_hook(
            lambda layer, inp, out: seen.append(tuple(out.shape)) or
            out + 1.0)
        hooked = m(paddle.to_tensor(x)).numpy()
        pre.remove()
        post.remove()
        plain = m(paddle.to_tensor(x)).numpy()
        assert seen == [(2, 3)]
        outs.append((hooked, plain))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(outs[1][0], x @ np.full((4, 3), 1.0)
                               + np.arange(3) + 1.0, rtol=1e-5)


def test_layer_call_boundary_gives_tensors_outside_plain_inside():
    """At user level a Layer returns Tensors; its forward body sees plain
    torch tensors (the conversion happens once, at the boundary)."""
    seen = []

    class Probe(paddle_tpu_torch.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle_tpu_torch.nn.Linear(2, 2)

        def forward(self, x):
            seen.append(type(x))
            h = self.fc(x)
            seen.append(type(h))
            return h

    out = Probe()(paddle_tpu_torch.ones([1, 2]))
    assert type(out) is paddle_tpu_torch.Tensor
    assert seen == [torch.Tensor, torch.Tensor]
    assert type(Probe()(torch.ones(1, 2))) is torch.Tensor


# ------------------------------------------------------- ParamAttr
def test_create_parameter_with_param_attr_matches_jax():
    got = []
    for paddle in PKGS:
        class L(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.w = self.create_parameter(
                    [3, 4], attr=paddle.ParamAttr(
                        name="pa_w",
                        initializer=paddle.nn.initializer.Constant(0.25),
                        learning_rate=0.5, trainable=False,
                        regularizer=paddle.regularizer.L1Decay(0.1),
                        need_clip=False))
                self.b = self.create_parameter([4], is_bias=True)
                self.v = self.create_parameter([2, 3], dtype="float64")
        m = L()
        got.append([(p.name, p.shape, p.stop_gradient, p.trainable,
                     p.optimize_attr, p.need_clip, str(p.dtype)[-7:])
                    for p in (m.w, m.b, m.v)][:1]
                   + [m.w.numpy(), m.b.numpy(), str(m.v.dtype)[-7:]])
        assert type(m.w.regularizer).__name__ == "L1Decay"
    (jmeta, jw, jb, jv), (tmeta, tw, tb, tv) = got
    assert tmeta[0][:6] == jmeta[0][:6]
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tb, jb)
    assert tv == jv == "float64"


# ------------------------------------- Queue 3 item 1: initializers
def _stats_ok(w, mean, std, lo=None, hi=None):
    """Finite, and mean and std within 6 standard errors of the
    distribution's (std's error sqrt(1/(2n)) relative, for a normal)."""
    w = np.asarray(w, np.float64).ravel()
    n = w.size
    assert np.isfinite(w).all()
    assert abs(w.mean() - mean) < 6 * std / math.sqrt(n), (w.mean(), mean)
    assert abs(w.std() / std - 1) < 6 * math.sqrt(1 / (2 * n)) + 0.01, \
        (w.std(), std)
    if lo is not None:
        assert w.min() >= lo and w.max() <= hi


@pytest.mark.parametrize("layer", ["Linear", "Embedding", "Conv2D"])
def test_default_initializers_drawn_at_construction(layer):
    """Each package's layer draws the reference's default at
    construction: XavierNormal for Linear's weight (zero bias),
    Normal(0, 1) for Embedding, KaimingUniform(fan_in) for Conv2D (zero
    bias). Checked over three seeds in the port (different draws) and
    once in the JAX package."""
    spec = {
        "Linear": (lambda nn: nn.Linear(256, 192),
                   dict(mean=0.0, std=math.sqrt(2.0 / (256 + 192)))),
        "Embedding": (lambda nn: nn.Embedding(512, 64),
                      dict(mean=0.0, std=1.0)),
        "Conv2D": (lambda nn: nn.Conv2D(16, 32, 3),
                   dict(mean=0.0, std=math.sqrt(6.0 / 144) / math.sqrt(3),
                        lo=-math.sqrt(6.0 / 144), hi=math.sqrt(6.0 / 144))),
    }[layer]
    make, dist = spec
    paddle_tpu.seed(0)
    _stats_ok(make(paddle_tpu.nn).weight.numpy(), **dist)
    draws = []
    for s in (0, 1, 2):
        paddle_tpu_torch.seed(s)
        m = make(paddle_tpu_torch.nn)
        _stats_ok(m.weight.numpy(), **dist)
        if getattr(m, "bias", None) is not None:
            assert not m.bias.numpy().any()
        draws.append(m.weight.numpy())
    assert not np.array_equal(draws[0], draws[1])
    paddle_tpu_torch.seed(1)
    np.testing.assert_array_equal(make(paddle_tpu_torch.nn).weight.numpy(),
                                  draws[1])


def test_embedding_padding_idx_matches_jax():
    ids = np.array([[0, 3, 9], [9, 9, 1]])
    outs = []
    for paddle in PKGS:
        paddle.seed(0)
        e = paddle.nn.Embedding(10, 4, padding_idx=-1)
        assert not e.weight.numpy()[9].any()
        e.set_state_dict({"weight": np.arange(40, dtype=np.float32)
                          .reshape(10, 4)})
        outs.append(e(paddle.to_tensor(ids)).numpy())
        outs.append(paddle.nn.functional.embedding(
            paddle.to_tensor(ids), e.weight, padding_idx=3).numpy())
    np.testing.assert_array_equal(outs[2], outs[0])
    np.testing.assert_array_equal(outs[3], outs[1])
    assert not outs[2][0, 1].any() is False and not outs[3][0, 1].any()


def test_seed_fixes_the_port_draws_whatever_torch_global_does():
    paddle_tpu_torch.seed(5)
    a = paddle_tpu_torch.nn.Linear(8, 8).weight.numpy()
    r1 = paddle_tpu_torch.rand([3]).numpy()
    state = trandom.get_rng_state()
    r2 = paddle_tpu_torch.randn([4]).numpy()
    trandom.set_rng_state(state)
    np.testing.assert_array_equal(paddle_tpu_torch.randn([4]).numpy(), r2)
    paddle_tpu_torch.seed(5)
    torch.manual_seed(123)
    torch.rand(10)
    np.testing.assert_array_equal(
        paddle_tpu_torch.nn.Linear(8, 8).weight.numpy(), a)
    np.testing.assert_array_equal(paddle_tpu_torch.rand([3]).numpy(), r1)
    ints = paddle_tpu_torch.randint(0, 5, [100]).numpy()
    assert ints.dtype == np.int64 and 0 <= ints.min() and ints.max() < 5


# ------------------------------------- Queue 3 item 5: Sequential
@pytest.mark.parametrize("form", ["tuples", "list", "plain"])
def test_sequential_forms_match_jax(form):
    x = np.random.RandomState(3).randn(2, 2).astype("float32")
    got = []
    for paddle in PKGS:
        nn = paddle.nn
        layers = [("fc", nn.Linear(2, 3)), ("act", nn.ReLU()),
                  ("out", nn.Linear(3, 1))]
        if form == "tuples":
            m = nn.Sequential(*layers)
        elif form == "list":
            m = nn.Sequential(layers)
        else:
            m = nn.Sequential(*(l for _, l in layers))
        got.append((list(m.state_dict()), m, len(m)))
    (jnames, jm, jn), (tnames, tm, tn) = got
    assert tnames == jnames and tn == jn == 3
    want = {"tuples": ["fc.weight", "fc.bias", "out.weight", "out.bias"],
            "list": ["fc.weight", "fc.bias", "out.weight", "out.bias"],
            "plain": ["0.weight", "0.bias", "2.weight", "2.bias"]}[form]
    assert tnames == want
    _copy_state(jm, tm)
    np.testing.assert_allclose(tm(paddle_tpu_torch.to_tensor(x)).numpy(),
                               jm(paddle_tpu.to_tensor(x)).numpy(),
                               rtol=1e-6)
    assert isinstance(tm[1], paddle_tpu_torch.nn.ReLU)


# ------------------------------------------------------- devices
def test_set_device_and_places():
    p = paddle_tpu_torch
    assert p.get_device() == "cpu"
    assert p.to_tensor([1.0]).place == p.CPUPlace()
    assert p.in_dygraph_mode() and p.device_count() >= 0
    assert p.is_compiled_with_cuda() == (torch.version.cuda is not None)
    with pytest.raises(ValueError):
        p.set_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            p.set_device("gpu")
        with pytest.raises(RuntimeError):
            p.to_tensor([1.0], place=p.CUDAPlace(0))
    assert p.get_device() == "cpu"
    p.disable_dygraph()   # static mode (slice 10a), left again below
    try:
        assert not p.in_dygraph_mode()
    finally:
        p.enable_dygraph()
    assert p.in_dygraph_mode()


def test_layers_follow_the_default_device():
    """A bare Layer makes its parameters on the default device, as
    to_tensor does: CUDA when set_device was not called (so without a
    GPU it raises, as to_tensor does), the CPU after set_device("cpu").
    `default_device` sets it for a block and restores it; a model given
    device="cpu" builds every layer there whatever the default."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    p = paddle_tpu_torch
    assert p.nn.Linear(3, 1).weight.device.type == "cpu"
    _place._default = None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            p.nn.Linear(3, 1)
        with pytest.raises(RuntimeError):
            p.to_tensor([1.0])
    with _place.default_device("cpu") as dev:
        assert dev == torch.device("cpu")
        bn = p.nn.BatchNorm2D(4, weight_attr=False, bias_attr=False)
        assert bn._mean.device == dev
    assert _place._default is None
    m = GPT(GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                      num_heads=2, max_seq_len=8), device="cpu")
    assert {q.device.type for q in m.parameters()} == {"cpu"}
    assert _place._default is None


def test_tensor_surface():
    p = paddle_tpu_torch
    t = p.to_tensor([[1.5, 2.0]])
    assert t.shape == [1, 2] and isinstance(t.shape, list)
    assert t.dtype == p.float32 and t.stop_gradient
    assert p.to_tensor(np.zeros(2)).dtype == p.float64
    assert t.astype("int32").dtype == p.int32
    assert t.cast("bfloat16").numpy().dtype == np.float32
    assert t.transpose([1, 0]).shape == [2, 1]
    assert t.item(1) if False else t.tolist() == [[1.5, 2.0]]
    assert float(p.sum(t)) == 3.5 and p.mean(t, axis=1).shape == [1]
    assert p.reshape(p.zeros([2, 3]), [0, 3, 1]).shape == [2, 3, 1]
    assert p.unsqueeze(t, [0, 3]).shape == [1, 1, 2, 1]
    assert p.squeeze(p.zeros([1, 3, 1]), axis=[0, 2]).shape == [3]
    assert p.flatten(p.zeros([2, 3, 4]), 1).shape == [2, 12]
    assert p.full([2], 7).numpy().tolist() == [7.0, 7.0]
    assert p.zeros_like(t).shape == [1, 2]
    assert p.bmm(p.ones([2, 3, 4]), p.ones([2, 4, 5])).shape == [2, 3, 5]
    assert p.matmul(p.ones([3, 4]), p.ones([5, 4]),
                    transpose_y=True).shape == [3, 5]
    assert p.clip(p.to_tensor([-2.0, 0.5, 3.0]), -1.0, 1.0).tolist() == \
        [-1.0, 0.5, 1.0]
    w = p.to_tensor([1.0, 2.0], stop_gradient=False)
    w.set_value(np.array([3.0, 4.0], np.float32))
    assert w.tolist() == [3.0, 4.0] and not w.stop_gradient
