"""The ResNet family as torch.nn.Modules (port of paddle_tpu/vision/
models/resnet.py).

Names and layouts are the JAX package's: conv weights [out, in/groups,
kh, kw], BN parameters `weight`/`bias` and buffers `_mean`/`_variance`,
downsample branches `Sequential` children `0` (conv) and `1` (BN), and
`fc.weight` [in, out]. A state dict therefore moves between the
packages unchanged (`ResNet.load_jax_params`, parameters and buffers).

Every BN-ReLU site goes through `_bn_relu`: with FLAGS_fuse_bn_act on
(the default) a plain BatchNorm layer runs the fused residual-light
batch_norm_act, else BN, the residual add and ReLU are separate ops.
Tensors are NCHW; data_format="NHWC" and stem_space_to_depth (TPU
layout recipes) are not ported yet and raise.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ...core import flags
from ...core.place import DeviceLike, default_device
from ...nn import functional as F
from ...nn.functional.conv import _require_nchw
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                         MaxPool2D, ReLU, Sequential)
from ...nn.layer.layers import Layer, load_jax_state
from ...nn.layer.norm import _BatchNormBase

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "resnext50_32x4d"]


def _bn_relu(bn, x, add=None):
    """relu(bn(x) (+ add)): the fused path for a plain BatchNorm layer when
    FLAGS_fuse_bn_act is on; any other norm layer (or the flag off) runs
    its own forward, the add and the relu."""
    if (flags.flag("fuse_bn_act") and isinstance(bn, _BatchNormBase)
            and type(bn).forward is _BatchNormBase.forward):
        return F.batch_norm_act(
            x, bn._mean, bn._variance, bn.weight, bn.bias,
            training=bn.training, momentum=bn._momentum,
            epsilon=bn._epsilon, data_format=bn._data_format, add=add,
            use_global_stats=bn._use_global_stats)
    out = bn(x)
    if add is not None:
        out = out + add
    return F.relu(out)


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        _require_nchw(data_format)
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = _bn_relu(self.bn1, self.conv1(x))
        out = self.conv2(out)
        if self.downsample is not None:
            identity = self.downsample(x)
        return _bn_relu(self.bn2, out, add=identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        _require_nchw(data_format)
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = _bn_relu(self.bn1, self.conv1(x))
        out = _bn_relu(self.bn2, self.conv2(out))
        out = self.conv3(out)
        if self.downsample is not None:
            identity = self.downsample(x)
        return _bn_relu(self.bn3, out, add=identity)


class ResNet(Layer):
    """ResNet over an explicit device. Weights are drawn on the CPU from
    `seed` in the JAX package's initializer families (convs
    KaimingUniform over fan_in = in_channels * kh * kw, fc XavierNormal,
    BN weight ones, biases zeros) and copied into layers built on
    `device`, so one seed gives the same model on the CPU and the GPU."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW",
                 stem_space_to_depth=False, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        _require_nchw(data_format)
        if stem_space_to_depth:
            raise NotImplementedError(
                "stem_space_to_depth (a TPU layout recipe) is not ported yet")
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        with default_device(device):
            self.groups = groups
            self.base_width = width
            self.num_classes = num_classes
            self.with_pool = with_pool
            self.inplanes = 64
            self.dilation = 1
            self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                bias_attr=False)
            self.bn1 = BatchNorm2D(self.inplanes)
            self.relu = ReLU()
            self.maxpool = MaxPool2D(3, 2, 1)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = Linear(512 * block.expansion, num_classes)
        self._init_weights(seed)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False),
                BatchNorm2D(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width))
        return Sequential(*layers)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv2D):
                lim = math.sqrt(6.0 / m.fan_in)
                m.weight.copy_(torch.empty(m.weight.shape).uniform_(
                    -lim, lim, generator=g))
            elif isinstance(m, Linear):
                fi, fo = m.weight.shape
                m.weight.copy_(torch.empty(fi, fo).normal_(
                    0.0, math.sqrt(2.0 / (fi + fo)), generator=g))

    @property
    def device(self) -> torch.device:
        return self.conv1.weight.device

    def forward(self, x):
        x = _bn_relu(self.bn1, self.conv1(x))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x

    def load_jax_params(self, state: Dict[str, np.ndarray]) -> "ResNet":
        """Copy the numpy form of the JAX model's `state_dict()` (every
        parameter and BN buffer) into this model; names and shapes must
        match exactly, and each tensor keeps its own dtype (as the JAX
        package's set_state_dict does). Returns self."""
        return load_jax_state(self, state)


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no downloads); load a "
            "state with ResNet.load_jax_params")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)
