"""MobileNetV1 and MobileNetV2 as torch.nn.Modules (port of paddle_tpu/
vision/models/mobilenet.py).

Names and layouts are the JAX package's: ConvBNLayer's `conv` (no bias)
and `bn` (BatchNorm2D: `weight`, `bias`, `_mean`, `_variance`) with
ReLU6 after it unless act=False; MobileNetV1's `conv1`, `blocks.i.dw` /
`.pw` and `fc`; MobileNetV2's `features.i` (InvertedResidual's `conv`
Sequential) and `classifier` (Dropout(0.2), Linear). A state dict moves
between the packages unchanged (`load_jax_params`). Depthwise layers are
grouped convolutions (groups = channels), which cuDNN runs as its
depthwise kernels. Weights are drawn on the CPU from `seed` (resnet.py
`draw_weights`) and copied into layers built on `device`."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...core.place import DeviceLike, default_device
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                         Linear, ReLU6, Sequential)
from ...nn.layer.layers import Layer, load_jax_state
from .resnet import draw_weights

__all__ = ["ConvBNLayer", "DepthwiseSeparable", "MobileNetV1",
           "InvertedResidual", "MobileNetV2", "mobilenet_v1",
           "mobilenet_v2"]


class ConvBNLayer(Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act=True):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, kernel, stride=stride,
                           padding=padding, groups=groups, bias_attr=False)
        self.bn = BatchNorm2D(out_c)
        self.act = ReLU6() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act is not None:
            x = self.act(x)
        return x


class DepthwiseSeparable(Layer):
    def __init__(self, in_c, out_c1, out_c2, num_groups, stride, scale):
        super().__init__()
        self.dw = ConvBNLayer(in_c, int(out_c1 * scale), 3, stride, 1,
                              groups=int(num_groups * scale))
        self.pw = ConvBNLayer(int(out_c1 * scale), int(out_c2 * scale), 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class _Classifier(Layer):
    """device and weight loading, shared by the two models."""

    @property
    def device(self) -> torch.device:
        return next(iter(self.parameters())).device

    def load_jax_params(self, state: Dict[str, np.ndarray]):
        """Copy the numpy form of the JAX model's `state_dict()` (every
        parameter and BN buffer) into this model; names and shapes must
        match exactly. Returns self."""
        return load_jax_state(self, state)


class MobileNetV1(_Classifier):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
               (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
               (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
               (1024, 1024, 1024, 1024, 1)]
        with default_device(device):
            self.conv1 = ConvBNLayer(3, int(32 * scale), 3, 2, 1)
            self.blocks = Sequential(*[
                DepthwiseSeparable(int(in_c * scale), c1, c2, g, s, scale)
                for in_c, c1, c2, g, s in cfg])
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = Linear(int(1024 * scale), num_classes)
        draw_weights(self, seed)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1))
        layers += [ConvBNLayer(hidden, hidden, 3, stride, 1, groups=hidden),
                   ConvBNLayer(hidden, oup, 1, act=False)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(_Classifier):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        with default_device(device):
            input_channel = int(32 * scale)
            features = [ConvBNLayer(3, input_channel, 3, 2, 1)]
            for t, c, n, s in cfg:
                out_c = int(c * scale)
                for i in range(n):
                    features.append(InvertedResidual(
                        input_channel, out_c, s if i == 0 else 1, t))
                    input_channel = out_c
            self.last_channel = int(1280 * max(1.0, scale))
            features.append(ConvBNLayer(input_channel, self.last_channel, 1))
            self.features = Sequential(*features)
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = Sequential(
                    Dropout(0.2), Linear(self.last_channel, num_classes))
        draw_weights(self, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no downloads); load a "
            "state with load_jax_params")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no downloads); load a "
            "state with load_jax_params")
    return MobileNetV2(scale=scale, **kwargs)
