"""The port's vision models (paddle_tpu_torch.vision.models: MobileNetV1/
V2, VGG, channel-last ResNet and the space-to-depth stem) against the
JAX package, on the CPU.

Both packages get the same weights and the same numpy inputs, in
float32. The names-and-shapes test builds the JAX models with a zero
initializer (the names, shapes and dtypes are what it reads; the JAX
package's random draws take a compile per shape) and loads the JAX
state into the port with `load_jax_params` (nn/layer/layers.py
`load_jax_state`). The numeric tests do the reverse, for the same
reason: the port draws the weights from a seed and the JAX model,
built with the zero initializer, takes them with set_state_dict.
Each step runs the JAX package's jit.TrainStep, which also returns the
training-mode logits (return_outputs), against the port's TrainStep
and a training-mode forward.

Tolerances: logits within 1e-4 of the largest logit (training mode:
batch statistics amplify the summation order with depth); after one
Momentum step the loss within 1e-5 relative, every gradient and every
parameter within 1e-4 of its tensor's largest entry, every running
stat within 1e-4. A tensor that is zero in exact arithmetic (a conv
bias under batch norm has a zero gradient, and after the step from a
zero start stays at rounding noise, as does the running mean of a
conv's output over an input batch norm left at zero mean) is held
within the limit times 5 % of the largest gradient, parameter or
running stat of its model instead. Dropout layers are in eval
mode for the steps (the two packages draw different masks).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as jmodels
from paddle_tpu.vision.models import resnet as jres

import paddle_tpu_torch
from paddle_tpu_torch import jit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models import resnet as tres


@pytest.fixture(autouse=True)
def _cpu_device():
    """The CPU as the default device, and one torch thread: these models'
    convolutions (f64 depthwise ones above all) split across every core
    stall behind the other test workers (MobileNetV2's f64 step took
    230 s that way in a full run, 15 s on one thread)."""
    from paddle_tpu_torch.core import place
    prev, threads = place._default, torch.get_num_threads()
    paddle_tpu_torch.set_device("cpu")
    torch.set_num_threads(1)
    yield
    place._default = prev
    torch.set_num_threads(threads)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


@pytest.fixture
def zero_init(monkeypatch):
    """The JAX package's initializers draw zeros while the test runs."""
    import inspect
    from paddle_tpu.nn import initializer as I
    for c in vars(I).values():
        if inspect.isclass(c) and issubclass(c, I.Initializer) and \
                "__call__" in vars(c):
            monkeypatch.setattr(c, "__call__", lambda self, shape, dtype=None:
                                jnp.zeros(tuple(shape), jnp.float32))


def _pair(ctor, seed=0, **kw):
    """The JAX model (zero initializer in force) on the port model's
    weights, drawn from seed."""
    tm = getattr(tmodels, ctor)(device="cpu", seed=seed, **kw)
    jm = getattr(jmodels, ctor)(**kw)
    jm.set_state_dict({k: v.numpy() for k, v in tm.state_dict().items()})
    return jm, tm


def _images(b, size, classes=10, seed=1, nhwc=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3, size, size).astype(np.float32)
    if nhwc:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, rng.randint(0, classes, (b, 1)).astype(np.int64)


def _no_dropout(*models):
    for m in models:
        for sub in m.sublayers():
            if type(sub).__name__ == "Dropout":
                sub.eval()


def _jloss(m, x, y):
    return JF.cross_entropy(m(x), y)


def _tloss(m, x, y):
    return F.cross_entropy(m(x), y)


def _close_all(got, want, tol):
    """Each tensor within tol of its largest entry, or of the largest
    entry of all of them for a tensor that is zero in exact arithmetic
    (its own largest entry is rounding noise)."""
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        err = np.abs(np.asarray(got[k], np.float64) - want[k]).max()
        assert err <= tol * max(np.abs(want[k]).max(), 0.05 * top), k


def _check_step(jm, tm, args, jloss_fn=_jloss, tloss_fn=_tloss, lr=0.01,
                logits=True, tol=1e-4):
    """One Momentum TrainStep in each package on the same weights: the
    training-mode logits (when the loss function is _jloss), the loss,
    the gradients (the first velocity from zero is the gradient), the
    parameters and the running stats."""
    jm.train()
    tm.train()
    _no_dropout(jm, tm)
    if logits:
        want = None

        def jloss_fn(m, x, y):  # noqa: F811 - returns the logits too
            out = m(x)
            return JF.cross_entropy(out, y), out
        with torch.no_grad():
            saved = {k: b.clone() for k, b in tm.named_buffers()}
            got = tm(torch.from_numpy(args[0])).numpy()
            for k, b in tm.named_buffers():
                b.copy_(saved[k])
    jstep = paddle.jit.TrainStep(jm, jloss_fn, jopt.Momentum(
        lr, parameters=jm.parameters()), return_outputs=logits)
    tstep = jit.TrainStep(tm, tloss_fn, Momentum(lr,
                                                 parameters=tm.parameters()))
    jout = jstep(*[paddle.to_tensor(a) for a in args])
    if logits:
        jout, (_, want) = jout
        assert _rel(got, want.numpy()) <= tol
    jl = float(jout.numpy())
    tl = tstep(*[torch.from_numpy(a) for a in args]).item()
    assert abs(tl - jl) <= min(tol, 1e-5) * abs(jl), (tl, jl)
    jg = {k: np.asarray(s["velocity"]) for k, s in jstep._opt_state.items()}
    tg = {k: s["velocity"].numpy() for k, s in tstep._opt_state.items()}
    assert set(jg) == set(tg)
    _close_all(tg, jg, tol)
    state = _state(jm)
    _close_all({k: p.detach().numpy() for k, p in tm.named_parameters()},
               {k: state[k] for k, _ in tm.named_parameters()}, tol)
    _close_all({k: b.numpy() for k, b in tm.named_buffers()},
               {k: state[k] for k, _ in tm.named_buffers()}, tol)
    return tl


# --------------------------------------------------- names and shapes
@pytest.mark.parametrize("ctor,kw", [
    ("mobilenet_v1", {}), ("mobilenet_v2", {}),
    ("vgg16", dict(batch_norm=True)), ("resnet50", dict(data_format="NHWC"))])
def test_full_width_state_dicts_match_jax(ctor, kw, zero_init):
    """The full-width models' state dicts (parameters and BN buffers):
    the JAX model's names, shapes and dtypes, and load_jax_params takes
    the JAX state as it is."""
    jm = getattr(jmodels, ctor)(**kw)
    js = _state(jm)
    del jm
    tm = getattr(tmodels, ctor)(device="cpu", **kw)
    ts = tm.state_dict()
    assert list(ts) == list(js)
    for k, v in js.items():
        assert tuple(ts[k].shape) == v.shape and \
            str(ts[k].dtype).endswith(str(v.dtype)), k
    tm.load_jax_params(js)
    name = next(k for k in js if k.endswith("weight"))
    np.testing.assert_array_equal(tm.state_dict()[name].numpy(), js[name])
    js.pop(name)
    with pytest.raises(ValueError, match=name):
        tm.load_jax_params(js)


# ------------------------------------------------------------- MobileNet
@pytest.mark.parametrize("ctor", ["mobilenet_v1", "mobilenet_v2"])
def test_mobilenet_logits_and_step_match_jax(ctor, zero_init):
    """scale 0.25 at 32x32, batch 8: training-mode logits and one
    Momentum step (depthwise convolutions, ReLU6, BN), in float64 in both
    packages, every quantity within 1e-7. At 32x32 the last blocks' maps
    are 1x1, so batch norm there normalises 8 values, and in float32 the
    packages' gradients part by up to 1.6e-4 of a tensor's largest entry
    (measured on the CPU), the summation order amplified as in ResNet-50
    (tests/test_torch_resnet.py)."""
    jm, tm = _pair(ctor, seed=1, scale=0.25, num_classes=10)
    jm.to(dtype="float64")
    tm.double()
    x, y = _images(8, 32, seed=2)
    _check_step(jm, tm, (x.astype(np.float64), y), tol=1e-7)


def test_mobilenet_v2_depthwise_layers_are_grouped_convs():
    tm = tmodels.mobilenet_v2(scale=1.0, device="cpu")
    dw = tm.features[3].conv[1].conv
    assert dw._groups == dw._in_channels == 144
    assert list(dw.weight.shape) == [144, 1, 3, 3]
    assert isinstance(tm.classifier[0], tnn.Dropout)
    assert tm.last_channel == 1280


# ------------------------------------------------------------------- VGG
def test_vgg11_bn_forward_matches_jax(zero_init):
    """vgg11(batch_norm=True, num_classes=10): one forward of the whole
    model (the 7x7 adaptive pool and the 25088 x 4096 classifier) in
    eval mode."""
    jm, tm = _pair("vgg11", seed=3, batch_norm=True, num_classes=10)
    x, _ = _images(2, 32, seed=4)
    jm.eval()
    tm.eval()
    want = jm(paddle.to_tensor(x)).numpy()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, want) <= 1e-5


def test_vgg11_bn_features_step_matches_jax(zero_init):
    """One Momentum step on the features (with_pool=False,
    num_classes=0, so the classifier stays out of the CPU step), loss the
    mean square of the 1x1 feature map."""
    jm, tm = _pair("vgg11", seed=5, batch_norm=True, with_pool=False,
                   num_classes=0)
    x, _ = _images(4, 32, seed=6)

    def jl(m, a):
        return (m(a) ** 2).mean()

    def tl(m, a):
        return (m(a) ** 2).mean()
    _check_step(jm, tm, (x,), jl, tl, logits=False)


# ------------------------------------------------- channel-last ResNet
@pytest.mark.parametrize("layout,s2d", [("NHWC", False), ("NCHW", True)])
def test_resnet18_nhwc_and_s2d_logits_and_step_match_jax(layout, s2d,
                                                         zero_init):
    """resnet18(data_format="NHWC") and resnet18(stem_space_to_depth=True)
    against the JAX package's, batch 2 at 64x64: training-mode logits
    and one Momentum step."""
    jm, tm = _pair("resnet18", seed=2, num_classes=10, data_format=layout,
                   stem_space_to_depth=s2d)
    x, y = _images(2, 64, seed=7, nhwc=layout == "NHWC")
    _check_step(jm, tm, (x, y))


def test_resnet18_nhwc_equals_nchw_in_the_port():
    """The port's NHWC ResNet-18 on the NCHW model's weights and the
    permuted batch: the same loss and gradients (f32, 1e-5 / 1e-4)."""
    a = tres.resnet18(num_classes=10, device="cpu", seed=4)
    b = tres.resnet18(num_classes=10, device="cpu", seed=9,
                      data_format="NHWC")
    b.load_jax_params({k: v.numpy() for k, v in a.state_dict().items()})
    x, y = _images(2, 64, seed=3)
    xt = torch.from_numpy(x)
    la = F.cross_entropy(a(xt), torch.from_numpy(y))
    lb = F.cross_entropy(b(xt.permute(0, 2, 3, 1).contiguous()),
                         torch.from_numpy(y))
    assert abs(la.item() - lb.item()) <= 1e-5 * abs(la.item())
    ga = torch.autograd.grad(la, list(a.parameters()))
    gb = torch.autograd.grad(lb, list(b.parameters()))
    for u, v in zip(gb, ga):
        assert ((u - v).norm() / v.norm()).item() <= 1e-4


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet_space_to_depth_stem_parity(layout, zero_init):
    """tests/test_round4_fixes.py::test_resnet_space_to_depth_stem_parity
    on both packages (both layouts): the folded 4x4/s1 stem equals the
    7x7/s2 one (rtol 1e-4, atol 1e-5 as there; the port also within 1e-5
    of the JAX package's folded stem), the port's s2d model's logits
    equal its plain stem's, gradients reach conv1's weight, and an odd
    input takes the plain stem."""
    nhwc = layout == "NHWC"
    jm, tm = _pair("resnet18", seed=3, num_classes=8, data_format=layout)
    x, _ = _images(2, 64, seed=5, nhwc=nhwc)
    jm.eval()
    tm.eval()
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    ja, jb = jm.conv1(jx).numpy(), jm._stem_s2d(jx).numpy()
    ta, tb = tm.conv1(tx).detach().numpy(), tm._stem_s2d(tx).detach().numpy()
    np.testing.assert_allclose(ja, jb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta, tb, rtol=1e-4, atol=1e-5)
    assert _rel(tb, jb) <= 1e-5
    plain = tm(tx).detach().numpy()
    tm.stem_space_to_depth = True
    assert _rel(tm(tx).detach().numpy(), plain) <= 1e-5
    tm.train()
    loss = (tm(tx) ** 2).mean()
    g = torch.autograd.grad(loss, tm.conv1.weight)[0]
    assert float(g.abs().max()) > 0
    # odd sizes take the plain stem
    odd = torch.from_numpy(_images(1, 63, seed=6, nhwc=nhwc)[0])
    tm.eval()
    out = tm(odd)
    tm.stem_space_to_depth = False
    assert torch.equal(out, tm(odd))


def test_resnet_blocks_custom_norm_and_frozen_stats(zero_init):
    """tests/test_nn.py::test_resnet_blocks_custom_norm_and_frozen_stats
    on both packages: GroupNorm as norm_layer keeps its own path (the
    port's block output equals the JAX block's on the same weights), and
    a use_global_stats=True BatchNorm leaves its running stats untouched
    in a training-mode forward."""
    jb = jres.BottleneckBlock(64, 16,
                              norm_layer=lambda c: paddle.nn.GroupNorm(4, c))
    tb = tres.BottleneckBlock(64, 16, norm_layer=lambda c: tnn.GroupNorm(4, c))
    jb.set_state_dict({k: v.numpy() for k, v in tb.state_dict().items()})
    x = np.random.RandomState(0).randn(2, 64, 8, 8).astype(np.float32)
    jo = jb(paddle.to_tensor(x))
    to = tb(torch.from_numpy(x))
    assert list(to.shape) == [2, 64, 8, 8] == list(jo.shape)
    assert _rel(to.detach().numpy(), jo.numpy()) <= 1e-5
    for blk_cls, bn in ((jres.BottleneckBlock, paddle.nn.BatchNorm2D),
                        (tres.BottleneckBlock, tnn.BatchNorm2D)):
        blk = blk_cls(64, 16, norm_layer=functools.partial(
            bn, use_global_stats=True))
        before = np.array(blk.bn1._mean.numpy()).copy()
        blk.train()
        arr = paddle.to_tensor(x) if blk_cls is jres.BottleneckBlock \
            else torch.from_numpy(x)
        blk(arr)
        np.testing.assert_array_equal(np.asarray(blk.bn1._mean.numpy()),
                                      before)


@pytest.mark.parametrize("last_axis", [3, -1])
def test_nhwc_bn_act_backward_on_the_last_axis(last_axis):
    """The fused BN + ReLU Function's backward with the channel axis last
    (given as 3, as data_format="NHWC" resolves it, or as -1) equals the
    NCHW one on the permuted tensors."""
    from paddle_tpu_torch.nn.functional.norm import _BNActCore
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 6, 5, 3) * 2 + 0.5).astype(np.float32)
    z = rng.randn(4, 6, 5, 3).astype(np.float32)
    w = (rng.rand(6) + 0.5).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    gy = rng.randn(4, 6, 5, 3).astype(np.float32)
    outs = []
    for perm, axis in (((0, 1, 2, 3), 1), ((0, 2, 3, 1), last_axis)):
        leaves = [torch.from_numpy(np.ascontiguousarray(
            a.transpose(perm))).requires_grad_(True) for a in (x, z)] + \
            [torch.from_numpy(a).requires_grad_(True) for a in (w, b)]
        out = _BNActCore.apply(leaves[0], leaves[1], leaves[2], leaves[3],
                               1e-5, axis)[0]
        g = torch.autograd.grad(out, leaves, torch.from_numpy(
            np.ascontiguousarray(gy.transpose(perm))))
        inv = np.argsort(perm)
        outs.append([out.detach().numpy().transpose(inv),
                     g[0].numpy().transpose(inv), g[1].numpy().transpose(inv),
                     g[2].numpy(), g[3].numpy()])
    for a, e in zip(outs[1], outs[0]):
        assert _rel(a, e) <= 1e-5


@pytest.mark.parametrize("ctor,kw", [
    ("mobilenet_v2", dict(scale=0.25)), ("mobilenet_v1", dict(scale=0.25)),
    ("vgg11", {}), ("resnet18", dict(data_format="NHWC"))])
def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(ctor, kw):
    """Without device="cpu" (and no set_device) a model is built on CUDA,
    so without a GPU it raises instead of falling back to the CPU."""
    from paddle_tpu_torch.core import place
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    place._default = None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tmodels, ctor)(**kw)
    assert getattr(tmodels, ctor)(device="cpu", **kw).device.type == "cpu"
