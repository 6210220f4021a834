"""The port's ResNet train step (paddle_tpu_torch: conv2d, pooling, the
batch-norm autograd Functions, BatchNorm2D, the ResNet family, Momentum,
TrainStep and amp.decorate with BN buffers) against the JAX package, on
the CPU.

Both packages get the same weights (`ResNet.load_jax_params` takes the
JAX model's whole state dict, parameters and BN buffers) and the same
numpy inputs. Tolerances, float32 on both sides unless a test says
otherwise (the frameworks sum their reductions and convolutions in
different orders):
- conv2d, pooling and the BN Functions' outputs and VJPs within 1e-5 of
  each tensor's largest entry (1e-4 for a VJP through batch statistics
  of 12 values, whose 1/sqrt(var) amplifies the summation order);
- ResNet-50 logits within 1e-5 (eval) and 1e-4 (train) relative to the
  largest logit: with batch statistics over 2 images the network's own
  f32 rounding noise grows with depth, and the JAX package's f32 logits
  lie 9.5e-5 from a float64 evaluation (measured; the port 6.8e-5);
- after one Momentum TrainStep (ResNet-18 in f32, ResNet-50 in f64, see
  the tests): the loss, every gradient, every parameter and every running
  stat, within the limits each test states;
- a 5-step loss curve (ResNet-18, batch 4, 64x64, lr 0.01) within 1e-4
  relative;
- under AMP O2 (bf16) only the dtypes are held to JAX's exactly; the
  loss is held within 2e-2 relative, because the two CPU backends round
  bf16 convolutions differently;
- the cross-entropy at bench_resnet's shape ([128, 1000] logits,
  [128, 1] int64 labels): the loss within 1e-6 relative, its gradient
  within 1e-5 of the largest entry;
- Momentum.apply_updates within 2 f32 ulps of JAX (exact in bf16).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.core import flags as jflags
from paddle_tpu.jit import _FunctionalizedLayer
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.norm import _bn_act_core, _bn_core
from paddle_tpu.vision.models import resnet as jres

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.norm import _BNActCore, _BNCore
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet as tres

EPS = 1e-5


def _jloss(m, x, y):
    return JF.cross_entropy(m(x), y)


def _tloss(m, x, y):
    return F.cross_entropy(m(x), y)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _pair(ctor, seed=0, **kw):
    paddle.seed(seed)
    jm = getattr(jres, ctor)(**kw)
    tm = getattr(tres, ctor)(device="cpu", **kw).load_jax_params(_state(jm))
    return jm, tm


@pytest.fixture(scope="module")
def r50():
    """One JAX ResNet-50 (10 classes) and its state; each test resets
    both models from that state."""
    paddle.seed(0)
    jm = jres.resnet50(num_classes=10)
    return jm, _state(jm)


def _fresh(r50):
    jm, state = r50
    jm.to(dtype="float32")
    jm.set_state_dict(state)
    jm.train()
    return jm, tres.resnet50(num_classes=10, device="cpu").load_jax_params(
        state)


def _images(b, size, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 3, size, size).astype(np.float32),
            rng.randint(0, 10, (b, 1)).astype(np.int64))


# ------------------------------------------------------------- functionals
@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1), (2, 3, 1, 1), (2, [1, 2], 1, 1), (1, [0, 1, 2, 1], 1, 1),
    (1, "SAME", 2, 2), (2, "SAME", 1, 4), (2, "VALID", 1, 1)])
def test_conv2d_matches_jax(stride, padding, dilation, groups):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 11, 13).astype(np.float32)
    w = rng.randn(8, 8 // groups, 3, 3).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    want = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                     paddle.to_tensor(b), stride=stride, padding=padding,
                     dilation=dilation, groups=groups).numpy()
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), stride=stride, padding=padding,
                   dilation=dilation, groups=groups)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


def test_pooling_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 9, 11).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    np.testing.assert_array_equal(
        F.max_pool2d(tx, 3, 2, 1).numpy(),
        JF.max_pool2d(jx, 3, 2, 1).numpy())
    for size in ((1, 1), (3, 4), (None, 2)):
        want = JF.adaptive_avg_pool2d(jx, size).numpy()
        got = F.adaptive_avg_pool2d(tx, size).numpy()
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-6


# ------------------------------------------------------ batch-norm cores
def _bn_inputs(z_shape=None, seed=2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 6, 5, 3) * 2 + 0.5).astype(np.float32)
    w = (rng.rand(6) + 0.5).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    gy = rng.randn(4, 6, 5, 3).astype(np.float32)
    z = None if z_shape is None else rng.randn(*z_shape).astype(np.float32)
    return x, z, w, b, gy


def _t(a):
    return None if a is None else torch.from_numpy(a).requires_grad_(True)


@pytest.mark.parametrize("stat_cts", [False, True])
def test_bn_core_forward_and_vjp_match_jax(stat_cts):
    x, _, w, b, gy = _bn_inputs()
    rng = np.random.RandomState(3)
    gm = rng.randn(6).astype(np.float32) if stat_cts else np.zeros(6, np.float32)
    gv = rng.randn(6).astype(np.float32) if stat_cts else np.zeros(6, np.float32)
    outs, vjp = jax.vjp(lambda a, c, d: _bn_core(a, c, d, EPS, 1),
                        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gm), jnp.asarray(gv)))
    tx, tw, tb = _t(x), _t(w), _t(b)
    touts = _BNCore.apply(tx, tw, tb, EPS, 1)
    cts = [torch.from_numpy(gy)]
    used = [touts[0]]
    if stat_cts:
        used += list(touts[1:])
        cts += [torch.from_numpy(gm), torch.from_numpy(gv)]
    tgrads = torch.autograd.grad(used, (tx, tw, tb), cts)
    for a, e in zip(touts, outs):
        assert _rel(a.detach().numpy(), e) <= 1e-5
    for a, e in zip(tgrads, jgrads):
        assert _rel(a.numpy(), e) <= 1e-5


@pytest.mark.parametrize("z_shape", [None, (4, 6, 5, 3), (1, 6, 1, 1)])
def test_bn_act_core_forward_and_vjp_match_jax(z_shape):
    x, z, w, b, gy = _bn_inputs(z_shape)
    if z is None:
        fn = lambda a, c, d: _bn_act_core(a, None, c, d, EPS, 1)  # noqa
        prim = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    else:
        fn = lambda a, zz, c, d: _bn_act_core(a, zz, c, d, EPS, 1)  # noqa
        prim = (jnp.asarray(x), jnp.asarray(z), jnp.asarray(w),
                jnp.asarray(b))
    (jout, jmean, jvar), vjp = jax.vjp(fn, *prim)
    jgrads = vjp((jnp.asarray(gy), jnp.zeros(6, jnp.float32),
                   jnp.zeros(6, jnp.float32)))
    tx, tz, tw, tb = _t(x), _t(z), _t(w), _t(b)
    out, mean, var = _BNActCore.apply(tx, tz, tw, tb, EPS, 1)
    leaves = [t for t in (tx, tz, tw, tb) if t is not None]
    tgrads = torch.autograd.grad(out, leaves, torch.from_numpy(gy))
    assert _rel(out.detach().numpy(), jout) <= 1e-5
    assert _rel(mean.detach().numpy(), jmean) <= 1e-6
    assert _rel(var.detach().numpy(), jvar) <= 1e-5
    assert (out.detach().numpy() == 0).mean() > 0.2     # the mask matters
    for a, e in zip(tgrads, jgrads):
        assert a.shape == e.shape
        assert _rel(a.numpy(), e) <= 1e-4


@pytest.mark.parametrize("fused", [False, True])
def test_running_stats_match_jax(fused):
    x, z, w, b, _ = _bn_inputs((4, 6, 5, 3))
    jrm = paddle.to_tensor(np.zeros(6, np.float32)).astype("bfloat16")
    jrv = paddle.to_tensor(np.ones(6, np.float32)).astype("bfloat16")
    trm = torch.zeros(6, dtype=torch.bfloat16)
    trv = torch.ones(6, dtype=torch.bfloat16)
    for _ in range(2):
        if fused:
            JF.batch_norm_act(paddle.to_tensor(x), jrm, jrv,
                              paddle.to_tensor(w), paddle.to_tensor(b),
                              training=True, add=paddle.to_tensor(z))
            F.batch_norm_act(torch.from_numpy(x), trm, trv,
                             torch.from_numpy(w), torch.from_numpy(b),
                             training=True, add=torch.from_numpy(z))
        else:
            JF.batch_norm(paddle.to_tensor(x), jrm, jrv, paddle.to_tensor(w),
                          paddle.to_tensor(b), training=True)
            F.batch_norm(torch.from_numpy(x), trm, trv, torch.from_numpy(w),
                         torch.from_numpy(b), training=True)
        # bf16 buffers are rebound to f32 by the first update, in both
        assert str(jrm.numpy().dtype) == "float32"
        assert trm.dtype == torch.float32 and trv.dtype == torch.float32
        assert _rel(trm.numpy(), jrm.numpy()) <= 1e-6
        assert _rel(trv.numpy(), jrv.numpy()) <= 1e-6
    # eval: the running stats, no update
    before = trm.clone()
    want = JF.batch_norm(paddle.to_tensor(x), jrm, jrv, paddle.to_tensor(w),
                         paddle.to_tensor(b), training=False).numpy()
    got = F.batch_norm(torch.from_numpy(x), trm, trv, torch.from_numpy(w),
                       torch.from_numpy(b), training=False).numpy()
    assert _rel(got, want) <= 1e-6
    assert torch.equal(trm, before)


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("block,fuse", [("BasicBlock", True),
                                        ("BottleneckBlock", True),
                                        ("BottleneckBlock", False)])
def test_block_matches_jax(block, fuse):
    """Forward, running stats and every gradient of a block with a
    downsample branch; fuse=False runs the port's composed route (BN, add,
    relu) against the JAX package's fused one."""
    cin, planes = 16, 8
    out_c = planes * getattr(jres, block).expansion
    paddle.seed(5)
    jds = paddle.nn.Sequential(paddle.nn.Conv2D(cin, out_c, 1, stride=2,
                                                bias_attr=False),
                               paddle.nn.BatchNorm2D(out_c))
    jb = getattr(jres, block)(cin, planes, stride=2, downsample=jds)
    state = _state(jb)
    from paddle_tpu_torch import nn as tnn
    tds = tnn.Sequential(tnn.Conv2D(cin, out_c, 1, stride=2,
                                    bias_attr=False), tnn.BatchNorm2D(out_c))
    tb = getattr(tres, block)(cin, planes, stride=2, downsample=tds)
    tb.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    x = np.random.RandomState(6).randn(2, cin, 8, 8).astype(np.float32)

    def jfn(a):
        y = jb(a)
        return (y * y).sum()

    inner = _FunctionalizedLayer(jfn, jb)
    params, buffers = inner.collect_state()
    (jl, jbuf), jg = jax.value_and_grad(
        lambda p: inner.pure_call(p, buffers, jax.random.PRNGKey(0),
                                  (jnp.asarray(x),), {}), has_aux=True)(
        params)
    prev = flags.flag("fuse_bn_act")
    flags.set_flags({"FLAGS_fuse_bn_act": fuse})
    try:
        tx = torch.from_numpy(x).requires_grad_(True)
        y = tb(tx)
        tl = (y * y).sum()
    finally:
        flags.set_flags({"FLAGS_fuse_bn_act": prev})
    names = [k for k, _ in tb.named_parameters()]
    tg = torch.autograd.grad(tl, [p for _, p in tb.named_parameters()])
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(names) == set(jg)
    for k, g in zip(names, tg):
        assert _rel(g.numpy(), jg[k]) <= 1e-4, k
    # each BN ran once in the port's forward and once in the JAX pure call
    for k, b in tb.named_buffers():
        assert _rel(b.numpy(), jbuf[k]) <= 1e-5, k


# ---------------------------------------------------------------- ResNet
def test_resnet50_state_and_logits_match_jax(r50):
    jm, tm = _fresh(r50)
    own = dict(tm.named_parameters())
    assert len(own) == 161 and len(dict(tm.named_buffers())) == 106
    assert tuple(tm.fc.weight.shape) == (2048, 10)
    x, _ = _images(2, 64)
    jm.eval()
    tm.eval()
    want = jm(paddle.to_tensor(x)).numpy()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, want) <= 1e-5
    jm.train()
    tm.train()
    want = jm(paddle.to_tensor(x)).numpy()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, want) <= 1e-4
    state = _state(jm)
    for k, b in tm.named_buffers():
        assert _rel(b.numpy(), state[k]) <= 1e-4, k


def _one_step(jm, tm, x, y, lr=0.01):
    """One Momentum TrainStep in each package. Returns the two losses, the
    gradients (the velocity after a first step from zero velocity is the
    gradient itself) and the JAX model's state after the step."""
    jstep = paddle.jit.TrainStep(jm, _jloss, jopt.Momentum(
        lr, parameters=jm.parameters()))
    tstep = jit.TrainStep(tm, _tloss, Momentum(lr, parameters=tm.parameters()))
    jloss = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
    tloss = tstep(torch.from_numpy(x), torch.from_numpy(y)).item()
    jgrad = {k: np.asarray(s["velocity"]) for k, s in jstep._opt_state.items()}
    tgrad = {k: s["velocity"].numpy() for k, s in tstep._opt_state.items()}
    return jloss, tloss, jgrad, tgrad, _state(jm)


def _check_step(jm, tm, x, y, tol):
    p0 = {k: p.detach().clone() for k, p in tm.named_parameters()}
    b0 = {k: b.clone() for k, b in tm.named_buffers()}
    jloss, tloss, jgrad, tgrad, state = _one_step(jm, tm, x, y)
    assert abs(tloss - jloss) <= tol["loss"] * abs(jloss)
    assert set(tgrad) == set(jgrad) == set(p0)
    for k in tgrad:
        assert _rel(tgrad[k], jgrad[k]) <= tol["grad"], k
    for k, p in tm.named_parameters():
        assert not torch.equal(p, p0[k]), k
        assert _rel(p.detach().numpy(), state[k]) <= tol["param"], k
    for k, b in tm.named_buffers():
        assert not torch.equal(b, b0[k]), k
        assert _rel(b.numpy(), state[k]) <= tol["stat"], k


def test_train_step_matches_jax():
    """ResNet-18 (10 classes), batch 2 at 64x64, f32: the loss within 1e-5
    relative, every gradient and every parameter within 1e-4 (a BN bias
    starts at 0, so after the step it is lr times its gradient) and every
    running stat within 1e-5 of its tensor's largest entry."""
    jm, tm = _pair("resnet18", seed=2, num_classes=10)
    x, y = _images(2, 64, seed=7)
    _check_step(jm, tm, x, y, dict(loss=1e-5, grad=1e-4, param=1e-4,
                                   stat=1e-5))


def test_resnet50_train_step_matches_jax_f64(r50):
    """ResNet-50's step in float64 in both packages (batch 2 at 64x64).
    At init a deep BN network's backward amplifies rounding noise: in f32
    the JAX package's own ResNet-50 gradients lie up to 14 % of their
    largest entry from a float64 evaluation at batch 2 (1.6 % in relative
    L2), so the f32 step is held at ResNet-18 above and ResNet-50's here,
    where every quantity agrees within 1e-7 of its tensor's largest
    entry (measured: 1.2e-12 for the gradients; the parameters read
    2.3e-8 because the JAX step passes lr as an f32 array, 0.01 rounded
    to f32, while the port's lr is the Python float)."""
    jm, tm = _fresh(r50)
    jm.to(dtype="float64")
    tm.double()
    x, y = _images(2, 64, seed=7)
    _check_step(jm, tm, x.astype(np.float64), y,
                dict(loss=1e-7, grad=1e-7, param=1e-7, stat=1e-7))


def test_loss_curve_matches_jax():
    jm, tm = _pair("resnet18", seed=3, num_classes=10)
    x, y = _images(4, 64, seed=8)
    jstep = paddle.jit.TrainStep(jm, _jloss, jopt.Momentum(
        0.01, parameters=jm.parameters()))
    tstep = jit.TrainStep(tm, _tloss, Momentum(0.01,
                                               parameters=tm.parameters()))
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
          for _ in range(5)]
    tl = [tstep(x, y).item() for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4 * jl[0])
    assert tl[-1] < 0.1 * tl[0]  # same batch every step: the loss falls


def test_o2_dtypes_match_jax():
    """bf16 parameters and inputs, f32 masters and velocities, running
    stats bf16 before the first step and f32 after it, as in JAX."""
    jm, tm = _pair("resnet18", seed=4, num_classes=10)
    jo = jopt.Momentum(0.01, parameters=jm.parameters())
    to = Momentum(0.01, parameters=tm.parameters())
    jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="bfloat16")
    tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16")
    assert all(b.dtype == torch.bfloat16 for b in tm.buffers())
    x, y = _images(2, 64, seed=9)
    jstep = paddle.jit.TrainStep(jm, _jloss, jo)
    tstep = jit.TrainStep(tm, _tloss, to)
    jloss = float(jstep(paddle.to_tensor(x).astype("bfloat16"),
                        paddle.to_tensor(y)).numpy())
    tloss = tstep(torch.from_numpy(x).bfloat16(), y).item()
    assert abs(tloss - jloss) <= 2e-2 * abs(jloss)
    jstate = jm.state_dict()
    for k, t in list(tm.named_parameters()) + list(tm.named_buffers()):
        assert str(t.dtype)[6:] == str(jstate[k].numpy().dtype), k
    for k, p in tm.named_parameters():
        st = tstep._opt_state[k]
        assert p.dtype == torch.bfloat16
        assert st["master"].dtype == torch.float32
        assert st["velocity"].dtype == torch.float32
        assert torch.equal(p, st["master"].to(torch.bfloat16))
    assert all(b.dtype == torch.float32 for b in tm.buffers())


def test_cross_entropy_bench_shape_matches_jax():
    """bench_resnet's loss: [128, 1000] logits, [128, 1] int64 labels."""
    rng = np.random.RandomState(11)
    logits = (rng.randn(128, 1000) * 3).astype(np.float32)
    labels = rng.randint(0, 1000, (128, 1)).astype(np.int64)
    z = paddle.to_tensor(logits, stop_gradient=False)
    jloss = JF.cross_entropy(z, paddle.to_tensor(labels))
    jloss.backward()
    jl, jg = float(jloss.numpy()), z.grad.numpy()
    t = torch.from_numpy(logits).requires_grad_(True)
    tl = F.cross_entropy(t, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(tl, t)
    assert abs(tl.item() - jl) <= 1e-6 * abs(jl)
    assert _rel(tg.numpy(), jg) <= 1e-5


# --------------------------------------------------------------- Momentum
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("weight_decay", [None, 1e-4])
def test_momentum_apply_updates_matches_jax(nesterov, master, weight_decay):
    rng = np.random.RandomState(10)
    shapes = {"a": (5, 7), "b": (11,)}
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if master else \
        (jnp.float32, torch.float32)
    kw = dict(momentum=0.9, use_nesterov=nesterov, weight_decay=weight_decay,
              rescale_grad=0.5)
    jo, to = jopt.Momentum(0.1, **kw), Momentum(0.1, **kw)
    jo._multi_precision = to._multi_precision = master
    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    js, ts = jo.init_opt_state(jp), to.init_opt_state(tp)
    lr = jnp.asarray(0.1, jnp.float32)      # as the JAX TrainStep passes it
    for g in grads:
        jp, js = jo.apply_updates(
            jp, {k: jnp.asarray(v, jdt) for k, v in g.items()}, js, lr)
        to.apply_updates(tp, {k: torch.from_numpy(v).to(tdt)
                              for k, v in g.items()}, ts)
    for k in shapes:
        want = np.asarray(jp[k].astype(jnp.float32))
        got = tp[k].float().numpy()
        if master:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(ts[k]["master"].numpy(),
                                       np.asarray(js[k]["master"]),
                                       rtol=2.4e-7, atol=1e-7)
        else:
            np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=1e-7)
        np.testing.assert_allclose(ts[k]["velocity"].float().numpy(),
                                   np.asarray(js[k]["velocity"],
                                              np.float32),
                                   rtol=2.4e-7, atol=1e-7)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tres.resnet18(device="cpu", data_format="NHWC")
    with pytest.raises(NotImplementedError):
        tres.resnet18(device="cpu", stem_space_to_depth=True)
    tm = tres.resnet18(num_classes=10, device="cpu")
    state = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    state.pop("bn1._mean")
    with pytest.raises(ValueError, match="bn1._mean"):
        tm.load_jax_params(state)
    assert jflags.flag("fuse_bn_act") and flags.flag("fuse_bn_act")
