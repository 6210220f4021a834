"""VGG as torch.nn.Modules (port of paddle_tpu/vision/models/vgg.py):
`cfgs` A/B/D/E (vgg11/13/16/19), `make_layers` (3x3 convolutions with a
bias, optional BatchNorm2D, ReLU, 2x2 max pools) and VGG with the 7x7
adaptive pool and the 25088 -> 4096 -> 4096 -> classes classifier with
dropout 0.5. Names are the JAX package's (`features.i`,
`classifier.0/3/6`). `vgg*(device=..., seed=...)` builds the features
and the classifier on `device` with weights drawn on the CPU from
`seed` (resnet.py `draw_weights`); VGG(features) draws the classifier's
and the given features' weights itself."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...core.place import DeviceLike, default_device
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                         Linear, MaxPool2D, ReLU, Sequential)
from ...nn.layer.layers import Layer, load_jax_state
from .resnet import draw_weights

__all__ = ["cfgs", "make_layers", "VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            conv = Conv2D(in_channels, v, 3, padding=1)
            layers += [conv, BatchNorm2D(v), ReLU()] if batch_norm \
                else [conv, ReLU()]
            in_channels = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        with default_device(device):
            self.features = features.to(device) if device is not None \
                else features
            self.num_classes = num_classes
            self.with_pool = with_pool
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = Sequential(
                    Linear(512 * 7 * 7, 4096), ReLU(), Dropout(),
                    Linear(4096, 4096), ReLU(), Dropout(),
                    Linear(4096, num_classes))
        draw_weights(self, seed)

    @property
    def device(self) -> torch.device:
        return next(iter(self.parameters())).device

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x

    def load_jax_params(self, state: Dict[str, np.ndarray]) -> "VGG":
        """Copy the numpy form of the JAX model's `state_dict()` into this
        model; names and shapes must match exactly. Returns self."""
        return load_jax_state(self, state)


def _vgg(arch, cfg, batch_norm, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no downloads); load a "
            "state with VGG.load_jax_params")
    with default_device(kwargs.get("device")):
        features = make_layers(cfgs[cfg], batch_norm)
    return VGG(features, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg11", "A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg13", "B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg16", "D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg19", "E", batch_norm, pretrained, **kwargs)
