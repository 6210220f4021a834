"""The vision half of the port's nn, continued (paddle_tpu_torch:
interpolate, unfold/fold, pixel (un)shuffle, grid_sample, affine_grid,
temporal_shift, pad, diag_embed, sigmoid_focal_loss, and every new
layer) against the JAX package, on the CPU, with the helpers and
tolerances of tests/test_torch_vision_nn.py: outputs within 1e-5 of the
largest entry (data movement exact), gradients within 1e-4 relative L2.
Where the JAX package drops an argument that changes Paddle's result
(pixel_unshuffle's data_format, grid_sample's "reflection"), the port
applies it and the case holds it to the JAX package on the equivalent
input.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as F
from test_torch_vision_nn import FWD, _nhwc, _rel, _run_both, _x


@pytest.fixture(autouse=True)
def _cpu_device():
    """Bare port layers make their parameters on the default device
    (CUDA unless set_device says otherwise): ask for the CPU."""
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    place._default = prev


# ---------------------------------------------------------------- resizing
INTERP = [  # mode, align_corners, in (h, w), out size
    ("nearest", False, (5, 7), (9, 4)), ("nearest", False, (6, 6), (3, 12)),
    ("bilinear", False, (5, 7), (9, 13)), ("bilinear", False, (9, 8), (4, 3)),
    ("bilinear", True, (5, 7), (9, 4)), ("bicubic", False, (5, 6), (11, 9)),
    ("bicubic", False, (10, 9), (4, 5)), ("bicubic", True, (5, 6), (8, 3)),
    ("area", False, (8, 8), (3, 5)), ("bilinear", True, (4, 5), (1, 5))]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", range(len(INTERP)))
def test_interpolate_matches_jax(case, layout):
    """interpolate by jax.image.resize's rules: half-pixel nearest,
    antialiased linear and Keys a = -0.5 cubic when shrinking, area as
    linear, align_corners by map_coordinates (order 0 for bicubic):
    values and input gradients, both layouts."""
    mode, ac, hw, size = INTERP[case]
    x = _x(2, 3, *hw, seed=case)
    if layout == "NHWC":
        x = _nhwc(x)
    kw = dict(size=list(size), mode=mode, align_corners=ac,
              data_format=layout)
    _run_both(lambda a: JF.interpolate(a, **kw),
              lambda a: F.interpolate(a, **kw), [x],
              fwd=0.0 if mode == "nearest" or (mode == "bicubic" and ac)
              else FWD)


@pytest.mark.parametrize("mode,size,scale", [
    ("linear", None, 2.5), ("nearest", [5], None),
    ("trilinear", [3, 7, 4], None), ("nearest", None, 1.5)])
def test_interpolate_1d_3d_and_scale_factor_match_jax(mode, size, scale):
    shape = (2, 3, 6) if mode == "linear" or size == [5] else (2, 3, 4, 5, 6)
    x = _x(*shape, seed=4)
    kw = dict(size=size, scale_factor=scale, mode=mode,
              data_format={3: "NCW", 5: "NCDHW"}[len(shape)])
    _run_both(lambda a: JF.interpolate(a, **kw),
              lambda a: F.interpolate(a, **kw), [x],
              fwd=0.0 if mode == "nearest" else FWD)


def test_interpolate_scale_factor_on_channel_last_scales_the_spatial_dims():
    """The JAX package scales x.shape[2:] even for NHWC (a fault: its
    size mixes W and C); the port scales H and W."""
    x = _x(1, 4, 6, 3)                       # NHWC: H 4, W 6, C 3
    jout = JF.interpolate(paddle.to_tensor(x), scale_factor=2,
                          data_format="NHWC")
    tout = F.interpolate(torch.from_numpy(x), scale_factor=2,
                         data_format="NHWC")
    assert list(jout.shape) == [1, 12, 6, 3]      # from (W, C) = (6, 3)
    assert list(tout.shape) == [1, 8, 12, 3]
    want = JF.interpolate(paddle.to_tensor(x), size=[8, 12],
                          data_format="NHWC").numpy()
    np.testing.assert_array_equal(tout.numpy(), want)


@pytest.mark.parametrize("paddings,strides,dilations", [
    (0, 1, 1), (1, 2, 1), ([1, 2], 1, 2), ([1, 0, 2, 1], [2, 1], 1)])
def test_unfold_and_fold_match_jax(paddings, strides, dilations):
    """unfold reads paddings as [top, left, bottom, right]; fold, its
    col2im inverse, takes the first two entries of a 4-list, as the JAX
    package does."""
    x = _x(2, 3, 7, 8)
    _run_both(lambda a: JF.unfold(a, [3, 2], strides, paddings, dilations),
              lambda a: F.unfold(a, [3, 2], strides, paddings, dilations),
              [x], fwd=0.0)
    if isinstance(paddings, list) and len(paddings) == 4:
        return
    cols = F.unfold(torch.from_numpy(x), [3, 2], strides, paddings,
                    dilations).numpy()
    _run_both(lambda a: JF.fold(a, [7, 8], [3, 2], strides, paddings,
                                dilations),
              lambda a: F.fold(a, [7, 8], [3, 2], strides, paddings,
                               dilations), [cols])


def test_pixel_shuffle_unshuffle_and_temporal_shift_match_jax():
    x = _x(2, 8, 3, 5)
    for layout, a in (("NCHW", x), ("NHWC", _nhwc(x))):
        _run_both(lambda t: JF.pixel_shuffle(t, 2, layout),
                  lambda t: F.pixel_shuffle(t, 2, layout), [a], fwd=0.0)
    y = _x(2, 3, 6, 4)
    _run_both(lambda t: JF.pixel_unshuffle(t, 2),
              lambda t: F.pixel_unshuffle(t, 2), [y], fwd=0.0)
    # pixel_unshuffle's data_format (dropped by the JAX package): the
    # channel-first result, permuted
    want = JF.pixel_unshuffle(paddle.to_tensor(y), 2).numpy()
    got = F.pixel_unshuffle(torch.from_numpy(_nhwc(y)), 2, "NHWC").numpy()
    np.testing.assert_array_equal(got, _nhwc(want))
    z = _x(6, 8, 3, 2)
    # the JAX package's NHWC route rebuilds Tensors off its tape (no
    # gradient there): its values only
    for layout, a in (("NCHW", z), ("NHWC", _nhwc(z))):
        _run_both(lambda t: JF.temporal_shift(t, 3, 0.25, layout),
                  lambda t: F.temporal_shift(t, 3, 0.25, layout), [a],
                  grads=layout == "NCHW", fwd=0.0)


@pytest.mark.parametrize("mode,padding_mode,align", [
    ("bilinear", "zeros", True), ("bilinear", "zeros", False),
    ("bilinear", "border", True), ("nearest", "zeros", False),
    ("nearest", "border", True)])
def test_affine_grid_and_grid_sample_match_jax(mode, padding_mode, align):
    rng = np.random.RandomState(5)
    theta = (np.array([[1.1, 0.2, 0.1], [-0.15, 0.9, -0.05]]) +
             rng.randn(2, 2, 3) * 0.1).astype(np.float32)
    x = _x(2, 3, 6, 7)
    grid = _run_both(lambda t: JF.affine_grid(t, [2, 3, 5, 4], align),
                     lambda t: F.affine_grid(t, [2, 3, 5, 4], align),
                     [theta])
    # points off the pixel grid, some outside [-1, 1]
    grid = (grid * 1.3 + 0.013).astype(np.float32)
    _run_both(lambda a, g: JF.grid_sample(a, g, mode, padding_mode, align),
              lambda a, g: F.grid_sample(a, g, mode, padding_mode, align),
              [x, grid], grads=mode == "bilinear")


def test_grid_sample_reflection_reflects():
    """padding_mode "reflection" reflects (Paddle's, torch's), where the
    JAX package clamps as for "border": inside [-1, 1] both agree."""
    x = _x(1, 2, 5, 6)
    inside = np.random.RandomState(3).uniform(-0.9, 0.9, (1, 4, 3, 2)
                                              ).astype(np.float32)
    want = JF.grid_sample(paddle.to_tensor(x), paddle.to_tensor(inside),
                          padding_mode="reflection").numpy()
    got = F.grid_sample(torch.from_numpy(x), torch.from_numpy(inside),
                        padding_mode="reflection").numpy()
    assert _rel(got, want) <= FWD
    out = np.array([[[[1.5, 0.0]]]], np.float32)      # x = 1.5 reflects to 0.5
    mirror = np.array([[[[0.5, 0.0]]]], np.float32)
    a = F.grid_sample(torch.from_numpy(x), torch.from_numpy(out),
                      padding_mode="reflection")
    b = F.grid_sample(torch.from_numpy(x), torch.from_numpy(mirror))
    assert _rel(a.numpy(), b.numpy()) <= FWD


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("pad,data_format", [
    ([1, 2], "NCL"), ([1, 0, 2, 1], "NCHW"), ([1, 0, 2, 1], "NHWC"),
    ([0, 1, 1, 2, 2, 0], "NCDHW"), ([1, 1, 0, 2, 1, 0, 0, 0], None)])
def test_pad_matches_jax(mode, pad, data_format):
    nd = {None: 4, "NCL": 3, "NCHW": 4, "NHWC": 4, "NCDHW": 5}[data_format]
    x = _x(*(2, 3, 4, 5, 6)[:nd])
    _run_both(lambda a: JF.pad(a, pad, mode, 0.5, data_format),
              lambda a: F.pad(a, pad, mode, 0.5, data_format), [x], fwd=0.0)


@pytest.mark.parametrize("offset,dim1,dim2", [(0, -2, -1), (1, -2, -1),
                                              (-2, 0, 2), (1, -1, -2)])
def test_diag_embed_matches_jax(offset, dim1, dim2):
    x = _x(3, 4)
    _run_both(lambda a: JF.diag_embed(a, offset, dim1, dim2),
              lambda a: F.diag_embed(a, offset, dim1, dim2), [x], fwd=0.0)


def test_sigmoid_focal_loss_matches_jax():
    logits = _x(6, 5, seed=3)
    label = (np.random.RandomState(1).rand(6, 5) > 0.7).astype(np.float32)
    _run_both(lambda a: JF.sigmoid_focal_loss(a, paddle.to_tensor(label),
                                              3.0, 0.3, 1.5),
              lambda a: F.sigmoid_focal_loss(a, torch.from_numpy(label),
                                             3.0, 0.3, 1.5), [logits])


# ------------------------------------------------------------------- layers
LAYERS = [  # (class, args, kwargs, input shape)
    ("Conv1D", (3, 4, 3), dict(padding=1), (2, 3, 9)),
    ("Conv2D", (3, 4, 3), dict(stride=2, data_format="NHWC"), (2, 7, 8, 3)),
    ("Conv3D", (3, 4, 2), dict(groups=1), (2, 3, 4, 5, 4)),
    ("Conv1DTranspose", (3, 4, 3), dict(stride=2), (2, 3, 6)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1, groups=2),
     (2, 4, 5, 5)),
    ("Conv3DTranspose", (3, 2, 2), dict(stride=2), (2, 3, 2, 3, 3)),
    ("MaxPool1D", (3, 2, 1), {}, (2, 3, 9)),
    ("MaxPool3D", (2,), dict(ceil_mode=True), (2, 3, 5, 4, 5)),
    ("AvgPool1D", (3, 2, 1), {}, (2, 3, 9)),
    ("AvgPool2D", (3, 2, 1), dict(ceil_mode=True, exclusive=False),
     (2, 3, 8, 7)),
    ("AvgPool3D", (2, 2), {}, (2, 3, 4, 4, 6)),
    ("AdaptiveAvgPool1D", (3,), {}, (2, 3, 8)),
    ("AdaptiveAvgPool3D", ((2, 1, 3),), {}, (2, 3, 4, 5, 6)),
    ("AdaptiveMaxPool1D", (4,), {}, (2, 3, 9)),
    ("AdaptiveMaxPool2D", ((2, 3),), {}, (2, 3, 7, 7)),
    ("AdaptiveMaxPool3D", (2,), {}, (2, 3, 4, 5, 6)),
    ("BatchNorm", (3,), dict(act="relu"), (2, 3, 4, 5)),
    ("BatchNorm1D", (3,), {}, (4, 3, 5)),
    ("BatchNorm3D", (3,), {}, (2, 3, 2, 3, 4)),
    ("GroupNorm", (2, 4), {}, (2, 4, 3, 5)),
    ("InstanceNorm1D", (3,), {}, (2, 3, 7)),
    ("InstanceNorm2D", (3,), {}, (2, 3, 4, 5)),
    ("InstanceNorm3D", (3,), {}, (2, 3, 2, 3, 4)),
    ("LocalResponseNorm", (3,), {}, (2, 5, 3, 4)),
    ("Upsample", (), dict(scale_factor=2, mode="bilinear"), (2, 3, 4, 5)),
    ("UpsamplingNearest2D", (), dict(size=[7, 3]), (2, 3, 4, 5)),
    ("UpsamplingBilinear2D", (), dict(size=[7, 9]), (2, 3, 4, 5)),
    ("Pad1D", ([1, 2],), dict(mode="reflect"), (2, 3, 6)),
    ("Pad2D", (1,), dict(mode="replicate"), (2, 3, 4, 5)),
    ("Pad3D", ([1, 0, 0, 1, 2, 1],), dict(value=0.5), (2, 3, 3, 4, 5)),
    ("ZeroPad2D", ([1, 2, 0, 1],), {}, (2, 3, 4, 5)),
    ("PixelShuffle", (2,), {}, (2, 8, 3, 4))]


@pytest.mark.parametrize("case", range(len(LAYERS)))
def test_layer_state_and_forward_match_jax(case):
    """Each new layer: the same state-dict names, shapes and dtypes as the
    JAX layer (parameters and buffers), and, on the JAX layer's weights,
    the same output (layers with statistics in training mode; the
    functionals' tests above hold the gradients)."""
    name, args, kw, shape = LAYERS[case]
    paddle.seed(case)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    js = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    ts = tl.state_dict()
    assert sorted(js) == sorted(ts), (sorted(js), sorted(ts))
    for k, v in js.items():
        assert tuple(ts[k].shape) == v.shape and \
            str(ts[k].dtype).endswith(str(v.dtype)), k
    tl.set_state_dict(js)
    x = _x(*shape, seed=case)
    exact = name.startswith(("Max", "AdaptiveMax", "Pad", "Zero", "Pixel",
                             "UpsamplingNearest"))
    _run_both(jl, tl, [x], grads=False, fwd=0.0 if exact else FWD)


def test_default_initializers_drawn_at_construction():
    """Conv and transposed-conv weights in KaimingUniform over fan_in =
    in_channels * prod(kernel) (the JAX package's, also for the
    transposes' [in, out/groups, k...]): every value inside the bound,
    the spread of U(-b, b); biases zero; GroupNorm, InstanceNorm and the
    batch norms start at weight (scale) ones, bias zeros, running mean
    zeros and variance ones."""
    for cls, args, fan_in in (("Conv2D", (16, 32, 3), 16 * 9),
                              ("Conv1D", (8, 64, 5), 8 * 5),
                              ("Conv3D", (4, 32, 3), 4 * 27),
                              ("Conv2DTranspose", (32, 16, 3), 32 * 9),
                              ("Conv3DTranspose", (16, 8, 2), 16 * 8)):
        layer = getattr(tnn, cls)(*args)
        w = layer.weight.detach().numpy()
        bound = math.sqrt(6.0 / fan_in)
        assert np.abs(w).max() <= bound
        assert abs(w.std() - bound / math.sqrt(3)) < 0.1 * bound
        assert not layer.bias.detach().numpy().any()
    for layer, wname in ((tnn.GroupNorm(2, 6), "weight"),
                         (tnn.InstanceNorm2D(6), "scale"),
                         (tnn.BatchNorm3D(6), "weight"),
                         (tnn.BatchNorm(6), "weight")):
        np.testing.assert_array_equal(getattr(layer, wname).detach(),
                                      np.ones(6, np.float32))
        np.testing.assert_array_equal(layer.bias.detach(),
                                      np.zeros(6, np.float32))
    bn = tnn.BatchNorm1D(6)
    np.testing.assert_array_equal(bn._mean, np.zeros(6))
    np.testing.assert_array_equal(bn._variance, np.ones(6))
    assert tnn.InstanceNorm1D(3, weight_attr=False).scale is None


def test_channel_last_conv_weight_keeps_its_logical_shape():
    """A channel-last Conv2D/3D keeps its weight in channels_last memory
    (the logical [out, in, k...] shape and the state dict unchanged)."""
    layer = tnn.Conv2D(3, 8, 3, data_format="NHWC")
    assert list(layer.weight.shape) == [8, 3, 3, 3]
    assert layer.weight.is_contiguous(memory_format=torch.channels_last)
    assert tuple(layer.state_dict()["weight"].shape) == (8, 3, 3, 3)
    layer3 = tnn.Conv3D(3, 8, 3, data_format="NDHWC")
    assert layer3.weight.is_contiguous(
        memory_format=torch.channels_last_3d)


def test_module_aliases():
    """nn.vision (layer.common, PixelShuffle's home), nn.conv and
    nn.extension, as in the JAX package."""
    assert tnn.vision.PixelShuffle is tnn.PixelShuffle
    assert tnn.conv.Conv3DTranspose is tnn.Conv3DTranspose
    assert tnn.extension.temporal_shift is F.temporal_shift
    assert set(jnn.extension.__all__) == set(tnn.extension.__all__)


def test_chip_smoke_phase_22_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py phase 22's cases, layers and wrapper run at their
    shapes with the CPU standing in for the card (every reading 0: the
    same device both ways; the bf16 half needs the card), on one torch
    thread (its moderate shapes split across every core stall behind
    the other test workers)."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "_vision_cases", lambda cases=(
        chip_smoke._vision_cases()): [(n, s, f, False) for n, s, f, _
                                      in cases])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        readings = chip_smoke.check_vision_ops(torch.device("cpu"), 0)
    finally:
        torch.set_num_threads(threads)
    assert len(readings["float32"]) >= 70
    assert not any(readings["float32"].values())


def test_chip_smoke_wrapper_cases_f32_against_f64():
    """Phase 22's optimizer-wrapper cases, the combined Lookahead +
    ModelAverage among them, drift from their float64 run by f32
    rounding only (within 1e-6 of the largest weight), and two runs on
    the CPU agree bitwise (no run starts from another's trained
    weights)."""
    import chip_smoke
    f32 = chip_smoke._wrapper_runs("cpu", 0)
    f64 = chip_smoke._wrapper_runs("cpu", 0, torch.float64)
    again = chip_smoke._wrapper_runs("cpu", 0)
    assert set(f32) == set(chip_smoke.WRAPPER_KINDS)
    for kind in chip_smoke.WRAPPER_KINDS:
        for a, w, b in zip(f32[kind], f64[kind], again[kind]):
            assert a.dtype == torch.float32 and w.dtype == torch.float64
            assert chip_smoke._vs_cpu(a, w) < 1e-6, kind
            assert torch.equal(a, b), kind
