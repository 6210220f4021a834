"""The vision half of the port's nn, its functionals (paddle_tpu_torch:
pooling, conv and transposed conv in 1-3 dims, instance/group/
local-response norm, batch norm on 2-D to 5-D inputs) against the JAX
package, on the CPU. tests/test_torch_vision_ops.py holds the rest of
slice 6c's functionals (resizing and the vision ops) and the layers,
with these helpers.

Both packages get the same numpy inputs (made from a seed), in float32.
Tolerances, unless a case says otherwise: outputs within 1e-5 of the
largest entry (the frameworks sum windows and convolutions in other
orders; max pooling and pure data movement are exact), gradients
within 1e-4 relative L2 (JAX's eager tape against torch autograd).
Where the JAX package drops an argument that changes Paddle's result
(instance_norm's and local_response_norm's data_format,
divisor_override, return_mask, output_size, padding_mode), the port
applies it and the case holds it to the JAX package on the equivalent
input, or to numpy.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as F

FWD, GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _cpu_device():
    """Bare port layers make their parameters on the default device
    (CUDA unless set_device says otherwise): ask for the CPU."""
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    place._default = prev


def _rel(got, want):
    """max |got - want| over max |want| on the finite entries; the
    non-finite ones (windows that lie wholly in a pool's ceil-mode
    padding: -inf for max, nan for an exclusive mean) must match
    exactly."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if not fin.any():
        return 0.0
    return np.abs(got[fin] - want[fin]).max() / max(
        np.abs(want[fin]).max(), 1e-30)


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(
        np.linalg.norm(want), 1e-30)


def _run_both(jfn, tfn, arrays, grads=True, seed=0, fwd=FWD, grad=GRAD):
    """jfn / tfn over the arrays as Tensors of each package: outputs within
    `fwd` of the largest entry, and, with grads, the gradients of
    sum(out * gy) for every array within `grad` relative L2."""
    jt = [paddle.to_tensor(a, stop_gradient=not grads) for a in arrays]
    tt = [torch.from_numpy(a.copy()).requires_grad_(grads) for a in arrays]
    jo, to = jfn(*jt), tfn(*tt)
    want, got = jo.numpy(), to.detach().numpy()
    assert _rel(got, want) <= fwd, _rel(got, want)
    if grads:
        gy = np.random.RandomState(seed + 100).randn(*want.shape).astype(
            np.float32)
        (jo * paddle.to_tensor(gy)).sum().backward()
        (to * torch.from_numpy(gy)).sum().backward()
        for j, t in zip(jt, tt):
            assert _rel_l2(t.grad.numpy(), j.grad.numpy()) <= grad
    return got


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


# ----------------------------------------------------------------- pooling
def test_ceil_mode_pads_the_high_side_as_paddle():
    """[1, 1, 5, 5], kernel 2, stride 2, padding 1, ceil mode: the JAX
    package pads the high side until the last window fits, Paddle's rule
    out = (5 - 2 + 2 + 2 - 1) / 2 + 1 = 4 (torch's own ceil_mode gives
    3); both pools agree with it, the last row and column too (windows
    wholly in the padding: -inf for max, nan for the exclusive mean, 0
    for the plain one, as in the JAX package)."""
    x = _x(1, 1, 5, 5, seed=3)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    want = JF.max_pool2d(jx, 2, 2, 1, ceil_mode=True).numpy()
    got = F.max_pool2d(tx, 2, 2, 1, ceil_mode=True).numpy()
    assert got.shape == want.shape == (1, 1, 4, 4)
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[0, 0, 3]).all() and np.isfinite(got[0, 0, :3,
                                                               :3]).all()
    for exclusive in (True, False):
        want = JF.avg_pool2d(jx, 2, 2, 1, ceil_mode=True,
                             exclusive=exclusive).numpy()
        got = F.avg_pool2d(tx, 2, 2, 1, ceil_mode=True,
                           exclusive=exclusive).numpy()
        assert got.shape == want.shape == (1, 1, 4, 4)
        assert _rel(got, want) <= FWD


POOL2D = [  # (h, w), kernel, stride, padding, ceil_mode
    ((5, 5), 2, 2, 1, True), ((5, 5), 2, 2, 1, False),
    ((7, 6), 3, 2, 1, True), ((7, 6), 3, 2, 1, False),
    ((6, 7), 3, 1, 0, False), ((6, 7), 3, 3, 0, True),
    ((9, 8), [3, 2], [2, 1], [1, 0], True), ((8, 9), 3, 2, "SAME", False),
    ((8, 9), 3, 2, "VALID", True), ((7, 7), 2, 2, [0, 1, 1, 0], False),
    ((7, 7), 3, 2, [[1, 2], [0, 1]], True), ((6, 6), 4, 1, 2, False)]


@pytest.mark.parametrize("case,layout", [
    (i, "NCHW") for i in range(len(POOL2D))] + [
    (i, "NHWC") for i in range(0, len(POOL2D), 2)])
def test_pool2d_matches_jax(case, layout):
    """max and average pooling (exclusive and not) over sizes, kernels,
    strides, every padding form and ceil mode (half the cases also
    channel-last): values and input gradients."""
    hw, k, s, p, ceil = POOL2D[case]
    x = _x(2, 3, *hw, seed=case)
    if layout == "NHWC":
        x = _nhwc(x)
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              data_format=layout)
    _run_both(lambda a: JF.max_pool2d(a, **kw),
              lambda a: F.max_pool2d(a, **kw), [x], fwd=0.0)
    for exclusive in (True, False):
        _run_both(lambda a: JF.avg_pool2d(a, exclusive=exclusive, **kw),
                  lambda a: F.avg_pool2d(a, exclusive=exclusive, **kw), [x])


@pytest.mark.parametrize("n,layout,k,s,p,ceil", [
    (1, "NCL", 3, 2, 1, True), (1, "NLC", 2, 2, 0, False),
    (1, "NCL", 3, 1, "SAME", False), (3, "NCDHW", 2, 2, 1, True),
    (3, "NDHWC", 3, 2, [1, 0, 1], False), (3, "NCDHW", 3, 2, "VALID", True)])
def test_pool1d_3d_match_jax(n, layout, k, s, p, ceil):
    spatial = (9,) if n == 1 else (5, 6, 7)
    x = _x(2, 3, *spatial, seed=n)
    if layout in ("NLC", "NDHWC"):
        x = _nhwc(x)
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              data_format=layout)
    jmax, tmax = getattr(JF, f"max_pool{n}d"), getattr(F, f"max_pool{n}d")
    javg, tavg = getattr(JF, f"avg_pool{n}d"), getattr(F, f"avg_pool{n}d")
    _run_both(lambda a: jmax(a, **kw), lambda a: tmax(a, **kw), [x],
              fwd=0.0)
    for exclusive in (True, False):
        _run_both(lambda a: javg(a, exclusive=exclusive, **kw),
                  lambda a: tavg(a, exclusive=exclusive, **kw), [x])


@pytest.mark.parametrize("n,size", [(1, 3), (2, (3, 4)), (2, (None, 2)),
                                    (3, (2, 3, 1))])
def test_adaptive_pools_match_jax(n, size):
    spatial = {1: (8,), 2: (6, 9), 3: (4, 6, 5)}[n]
    x = _x(2, 3, *spatial, seed=n)
    for mode in ("avg", "max"):
        jf = getattr(JF, f"adaptive_{mode}_pool{n}d")
        tf = getattr(F, f"adaptive_{mode}_pool{n}d")
        _run_both(lambda a: jf(a, size), lambda a: tf(a, size), [x],
                  fwd=0.0 if mode == "max" else FWD)
    if n > 1:
        layout = "NHWC" if n == 2 else "NDHWC"
        jf = getattr(JF, f"adaptive_avg_pool{n}d")
        tf = getattr(F, f"adaptive_avg_pool{n}d")
        _run_both(lambda a: jf(a, size, layout),
                  lambda a: tf(a, size, layout), [_nhwc(x)])


def test_divisor_override_divides_the_window_sums():
    """divisor_override (dropped by the JAX package): the window sums,
    the JAX package's non-exclusive mean times prod(kernel), over d."""
    x = _x(2, 3, 7, 7, seed=4)
    for n, shape in ((2, (2, 3, 7, 7)), (3, (2, 3, 5, 6, 7))):
        x = _x(*shape, seed=n)
        jf, tf = getattr(JF, f"avg_pool{n}d"), getattr(F, f"avg_pool{n}d")
        sums = jf(paddle.to_tensor(x), 3, 2, 1, exclusive=False,
                  ceil_mode=True).numpy() * 3 ** n
        got = tf(torch.from_numpy(x), 3, 2, 1, ceil_mode=True,
                 divisor_override=5).numpy()
        assert _rel(got, sums / 5) <= FWD


@pytest.mark.parametrize("fn,args,shape", [
    ("max_pool1d", (3, 2, 1), (2, 3, 9)),
    ("max_pool2d", (3, 2, [1, 0, 2, 1]), (2, 3, 8, 7)),
    ("max_pool3d", (2, 2, 0), (2, 3, 4, 6, 5)),
    ("adaptive_max_pool1d", (4,), (2, 3, 9)),
    ("adaptive_max_pool2d", ((3, 2),), (2, 3, 7, 5)),
    ("adaptive_max_pool3d", (2,), (2, 3, 4, 5, 6))])
def test_return_mask_indexes_each_input_plane(fn, args, shape):
    """return_mask (dropped by the JAX package): the values equal the
    JAX package's, and the mask is the flat index of each maximum inside
    its (N, C) input plane, Paddle's convention."""
    x = _x(*shape, seed=7)
    want = getattr(JF, fn)(paddle.to_tensor(x), *args).numpy()
    out, mask = getattr(F, fn)(torch.from_numpy(x), *args, return_mask=True)
    np.testing.assert_array_equal(out.numpy(), want)
    flat = x.reshape(shape[0], shape[1], -1)
    m = mask.numpy().reshape(shape[0], shape[1], -1)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, m, 2).reshape(want.shape), want)


# -------------------------------------------------------------- convolution
CONV = [  # n, stride, padding, dilation, groups, channel_last
    (1, 1, 0, 1, 1, False), (1, 2, [1, 2], 1, 2, True),
    (1, 1, "SAME", 2, 1, False), (2, 2, [1, 0, 2, 1], 1, 1, True),
    (2, 1, "SAME", 1, 4, True), (2, 2, "VALID", 2, 2, False),
    (2, [2, 1], [[0, 1], [2, 0]], 1, 1, False), (3, 1, 1, 1, 1, False),
    (3, 2, "SAME", 1, 2, True), (3, [1, 2, 1], [0, 1, 1, 0, 1, 1], 1, 1,
                                 False)]


@pytest.mark.parametrize("case", range(len(CONV)))
def test_conv_matches_jax(case):
    """conv1d/2d/3d with bias over strides, every padding form, dilation,
    groups and both layouts: output and the gradients of x, weight and
    bias."""
    n, s, p, d, g, last = CONV[case]
    spatial = {1: (11,), 2: (9, 10), 3: (5, 6, 7)}[n]
    x = _x(2, 4, *spatial, seed=case)
    w = _x(8, 4 // g, *([3] * n), seed=case + 1)
    b = _x(8, seed=case + 2)
    layout = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
              3: ("NCDHW", "NDHWC")}[n][last]
    if last:
        x = _nhwc(x)
    kw = dict(stride=s, padding=p, dilation=d, groups=g, data_format=layout)
    jf, tf = getattr(JF, f"conv{n}d"), getattr(F, f"conv{n}d")
    _run_both(lambda a, ww, bb: jf(a, ww, bb, **kw),
              lambda a, ww, bb: tf(a, ww, bb, **kw), [x, w, b], seed=case)


CONV_T = [  # n, stride, padding, output_padding, dilation, groups, last
    (2, 2, 1, 0, 1, 1, False), (2, 2, 1, 1, 1, 1, True),
    (2, 2, [1, 0, 0, 2], 0, 1, 2, False), (2, 1, "SAME", 0, 2, 1, True),
    (2, 2, "VALID", 0, 1, 2, False), (2, 3, [[2, 0], [0, 3]], [1, 2], 1, 1,
                                      False),
    (2, 2, 4, 0, 1, 1, False), (1, 2, 1, 1, 1, 2, True),
    (1, 3, "SAME", 0, 1, 1, False), (3, 2, 1, 1, 1, 1, False),
    (3, [1, 2, 2], [0, 1, 1], 0, 1, 2, True)]


@pytest.mark.parametrize("case", range(len(CONV_T)))
def test_conv_transpose_matches_jax(case):
    """Transposed convolutions over every padding form (strings go to
    the dilated conv as they stand), output_padding, dilation, groups > 1
    and both layouts: output and gradients. Padding 4 with a 3-wide
    kernel (d * (k - 1) - lo < 0) takes the crop-and-pad route."""
    n, s, p, op_, d, g, last = CONV_T[case]
    spatial = {1: (7,), 2: (5, 6), 3: (3, 4, 5)}[n]
    x = _x(2, 4, *spatial, seed=case)
    w = _x(4, 6 // g, *([3] * n), seed=case + 1)
    b = _x(6, seed=case + 2)
    layout = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
              3: ("NCDHW", "NDHWC")}[n][last]
    if last:
        x = _nhwc(x)
    kw = dict(stride=s, padding=p, output_padding=op_, dilation=d,
              groups=g, data_format=layout)
    jf = getattr(JF, f"conv{n}d_transpose")
    tf = getattr(F, f"conv{n}d_transpose")
    jkw = dict(kw)
    if isinstance(p, str) and s != 1:
        # lax refuses a string padding with lhs dilation: hold the port
        # to the JAX package with the explicit padding XLA would resolve
        # the string to on the dilated input ("VALID": no padding of the
        # dilated conv, lo = hi = d * (k - 1); "SAME": d * (k - 1) split
        # the odd pixel after)
        with pytest.raises(ValueError, match="String padding"):
            jf(paddle.to_tensor(x), paddle.to_tensor(w), **kw)
        f = d * 2
        jkw["padding"] = [f, f] * n if p == "VALID" else \
            [f - f // 2, f // 2] * n
    _run_both(lambda a, ww, bb: jf(a, ww, bb, **jkw),
              lambda a, ww, bb: tf(a, ww, bb, **kw), [x, w, b], seed=case)


def test_conv_transpose_output_size_sets_output_padding():
    """output_size (dropped by the JAX package) picks the output padding
    that reaches it, as Paddle does: equal to the JAX package with that
    output_padding; an unreachable size raises."""
    x, w = _x(2, 4, 5, 6), _x(4, 3, 3, 3, seed=1)
    want = JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                               stride=2, padding=1,
                               output_padding=[1, 0]).numpy()
    got = F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                             stride=2, padding=1, output_size=[10, 11])
    assert _rel(got.numpy(), want) <= FWD
    with pytest.raises(ValueError, match="output_size"):
        F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                           stride=2, padding=1, output_size=[13, 11])


@pytest.mark.parametrize("mode", ["reflect", "replicate", "circular"])
def test_conv_layer_padding_mode(mode):
    """Conv1D/2D/3D(padding_mode=...) pad the input that way before a
    convolution with none (Paddle's rule; the JAX package stores the
    mode nowhere): equal to the JAX conv on numpy's padded input."""
    np_mode = {"reflect": "reflect", "replicate": "edge",
               "circular": "wrap"}[mode]
    for n, cls in ((1, "Conv1D"), (2, "Conv2D"), (3, "Conv3D")):
        spatial = {1: (9,), 2: (7, 6), 3: (4, 5, 6)}[n]
        x = _x(2, 3, *spatial, seed=n)
        tl = getattr(tnn, cls)(3, 4, 3, padding=1, padding_mode=mode)
        w, b = tl.weight.detach().numpy(), tl.bias.detach().numpy()
        xp = np.pad(x, [(0, 0), (0, 0)] + [(1, 1)] * n, mode=np_mode)
        want = getattr(JF, f"conv{n}d")(paddle.to_tensor(xp),
                                        paddle.to_tensor(w),
                                        paddle.to_tensor(b)).numpy()
        got = tl(torch.from_numpy(x)).detach().numpy()
        assert _rel(got, want) <= FWD


def test_conv_transpose_matches_torch_twin():
    """tests/test_nn.py::test_conv_transpose_matches_torch on both
    packages: conv2d_transpose(stride 2, padding 1) against torch's
    conv_transpose2d, 1e-3 as there."""
    import torch.nn.functional as tF
    x = _x(2, 3, 8, 8)
    w = _x(3, 5, 4, 4, seed=1)
    ref = tF.conv_transpose2d(torch.tensor(x), torch.tensor(w), stride=2,
                              padding=1).numpy()
    for out in (JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                                    stride=2, padding=1).numpy(),
                F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                                   stride=2, padding=1).numpy()):
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


# -------------------------------------------------------------------- norms
def test_norms_match_torch_twin():
    """tests/test_nn.py::test_norms_match_torch on both packages:
    group_norm and instance_norm against torch's, 1e-3 / 1e-4 as there;
    then the port against the JAX package at FWD."""
    import torch.nn.functional as tF
    x = _x(4, 6, 5, 5)
    g = (np.random.RandomState(1).rand(6) + 0.5).astype(np.float32)
    b = _x(6, seed=2)
    refs = [tF.group_norm(torch.tensor(x), 3, torch.tensor(g),
                          torch.tensor(b)).numpy(),
            tF.instance_norm(torch.tensor(x), weight=torch.tensor(g),
                             bias=torch.tensor(b)).numpy()]
    jouts = [JF.group_norm(paddle.to_tensor(x), 3, 1e-5, paddle.to_tensor(g),
                           paddle.to_tensor(b)).numpy(),
             JF.instance_norm(paddle.to_tensor(x), weight=paddle.to_tensor(g),
                              bias=paddle.to_tensor(b)).numpy()]
    touts = [F.group_norm(torch.from_numpy(x), 3, 1e-5, torch.from_numpy(g),
                          torch.from_numpy(b)).numpy(),
             F.instance_norm(torch.from_numpy(x), weight=torch.from_numpy(g),
                             bias=torch.from_numpy(b)).numpy()]
    for ref, j, t in zip(refs, jouts, touts):
        np.testing.assert_allclose(j, ref, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(t, ref, rtol=1e-3, atol=1e-4)
        assert _rel(t, j) <= FWD


@pytest.mark.parametrize("shape", [(3, 6, 5, 4), (2, 6, 3, 4, 5)])
def test_instance_and_group_norm_match_jax(shape):
    """instance_norm and group_norm (with and without weight and bias,
    group_norm in both layouts) over 3-D to 5-D inputs: outputs and
    gradients."""
    x = (_x(*shape) * 2 + 0.5).astype(np.float32)
    g = (np.random.RandomState(1).rand(6) + 0.5).astype(np.float32)
    b = _x(6, seed=2)
    _run_both(lambda a, w, c: JF.instance_norm(a, weight=w, bias=c),
              lambda a, w, c: F.instance_norm(a, weight=w, bias=c),
              [x, g, b])
    _run_both(lambda a: JF.instance_norm(a), lambda a: F.instance_norm(a),
              [x])
    _run_both(lambda a, w, c: JF.group_norm(a, 3, 1e-5, w, c),
              lambda a, w, c: F.group_norm(a, 3, 1e-5, w, c), [x, g, b])
    last = {3: "NLC", 4: "NHWC", 5: "NDHWC"}[len(shape)]
    _run_both(lambda a, w, c: JF.group_norm(a, 2, 1e-5, w, c, last),
              lambda a, w, c: F.group_norm(a, 2, 1e-5, w, c, last),
              [_nhwc(x), g, b])


def test_instance_norm_data_format_and_running_stats():
    """Where the JAX package drops them: data_format="NHWC" normalises
    over the spatial dims of a channel-last input (the JAX result on the
    channel-first input, permuted), and use_input_stats=False normalises
    with the running stats (numpy)."""
    x = _x(3, 4, 5, 6)
    want = JF.instance_norm(paddle.to_tensor(x)).numpy()
    got = F.instance_norm(torch.from_numpy(_nhwc(x)), data_format="NHWC")
    assert _rel(got.numpy(), _nhwc(want)) <= FWD
    rm, rv = _x(4, seed=1), (np.random.RandomState(2).rand(4) + 0.5
                             ).astype(np.float32)
    got = F.instance_norm(torch.from_numpy(x), torch.from_numpy(rm),
                          torch.from_numpy(rv), use_input_stats=False)
    ref = (x - rm[None, :, None, None]) / np.sqrt(
        rv[None, :, None, None] + 1e-5)
    assert _rel(got.numpy(), ref) <= FWD


@pytest.mark.parametrize("size", [3, 4, 5])
def test_local_response_norm_matches_jax(size):
    x = _x(2, 7, 4, 5)
    _run_both(lambda a: JF.local_response_norm(a, size, 1e-2, 0.75, 2.0),
              lambda a: F.local_response_norm(a, size, 1e-2, 0.75, 2.0), [x])
    want = JF.local_response_norm(paddle.to_tensor(x), size).numpy()
    got = F.local_response_norm(torch.from_numpy(_nhwc(x)), size,
                                data_format="NHWC")
    assert _rel(got.numpy(), _nhwc(want)) <= FWD


@pytest.mark.parametrize("shape,layout", [((8, 5), "NCHW"),
                                          ((4, 5, 6), "NCL"),
                                          ((4, 6, 5), "NLC"),
                                          ((2, 5, 3, 4, 3), "NCDHW"),
                                          ((2, 3, 4, 3, 5), "NDHWC")])
def test_batch_norm_2d_3d_5d_match_jax(shape, layout):
    """batch_norm in training on 2-D, 3-D and 5-D inputs (channel axis
    from data_format): output, gradients, and the running stats."""
    x = (_x(*shape) * 1.5 + 0.3).astype(np.float32)
    c = shape[-1] if layout in ("NLC", "NDHWC") else shape[1]
    w = (np.random.RandomState(1).rand(c) + 0.5).astype(np.float32)
    b = _x(c, seed=2)
    jm, jv = paddle.to_tensor(np.zeros(c, np.float32)), paddle.to_tensor(
        np.ones(c, np.float32))
    tm, tv = torch.zeros(c), torch.ones(c)
    _run_both(lambda a, ww, bb: JF.batch_norm(a, jm, jv, ww, bb, True,
                                              data_format=layout),
              lambda a, ww, bb: F.batch_norm(a, tm, tv, ww, bb, True,
                                             data_format=layout),
              [x, w, b])
    assert _rel(tm.numpy(), jm.numpy()) <= FWD
    assert _rel(tv.numpy(), jv.numpy()) <= FWD


@pytest.mark.parametrize("with_add", [False, True])
def test_batch_norm_act_nhwc_matches_jax(with_add):
    """batch_norm_act (ResNet's fused BN + add + ReLU) in training on a
    channel-last input of odd sizes: output, the gradients of x, z,
    weight and bias, and the running stats."""
    x = (_x(3, 5, 7, 6) * 1.5 + 0.2).astype(np.float32)
    z = _x(3, 5, 7, 6, seed=1)
    w = (np.random.RandomState(2).rand(6) + 0.5).astype(np.float32)
    b = _x(6, seed=3)
    jm, jv = paddle.to_tensor(np.zeros(6, np.float32)), paddle.to_tensor(
        np.ones(6, np.float32))
    tm, tv = torch.zeros(6), torch.ones(6)
    arrays = [x, w, b] + ([z] if with_add else [])

    def jf(a, ww, bb, zz=None):
        return JF.batch_norm_act(a, jm, jv, ww, bb, True, data_format="NHWC",
                                 add=zz)

    def tf(a, ww, bb, zz=None):
        return F.batch_norm_act(a, tm, tv, ww, bb, True, data_format="NHWC",
                                add=zz)
    _run_both(jf, tf, arrays)
    assert _rel(tm.numpy(), jm.numpy()) <= FWD
    assert _rel(tv.numpy(), jv.numpy()) <= FWD


def test_sync_batch_norm_waits_for_the_distributed_slice():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        F.sync_batch_norm(torch.zeros(2, 3), torch.zeros(3), torch.ones(3))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tnn.SyncBatchNorm(3)
