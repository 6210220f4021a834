"""LeNet as a Layer (port of paddle_tpu/vision/models/lenet.py).

Names and layouts are the JAX package's: `features.0` and `features.3`
are the convolutions ([out, in, kh, kw]), `fc.0`-`fc.2` the linears
([in, out], no activation between them, as in the reference), so a
state dict moves between the packages unchanged (`load_jax_params`).
Inputs are NCHW [N, 1, 28, 28].
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ...core.place import DeviceLike, default_device
from ...nn.layer import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ...nn.layer.layers import Layer, load_jax_state

__all__ = ["LeNet"]


class LeNet(Layer):
    """Weights are drawn on the CPU from `seed` (the JAX package's
    families: Kaiming-uniform convolutions, Xavier-normal linears, zero
    biases) and copied into layers built on `device`."""

    def __init__(self, num_classes=10, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        with default_device(device):
            self.features = Sequential(
                Conv2D(1, 6, 3, stride=1, padding=1),
                ReLU(),
                MaxPool2D(2, 2),
                Conv2D(6, 16, 5, stride=1, padding=0),
                ReLU(),
                MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = Sequential(
                    Linear(400, 120),
                    Linear(120, 84),
                    Linear(84, num_classes))
        self._init_weights(seed)

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
        return self.features[0].weight.device

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x

    def load_jax_params(self, state: Dict[str, np.ndarray]) -> "LeNet":
        """Copy the numpy form of the JAX model's `state_dict()` into this
        model; names and shapes must match exactly. Returns self."""
        return load_jax_state(self, state)
