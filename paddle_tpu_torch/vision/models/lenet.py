"""LeNet as a torch.nn.Module (port of paddle_tpu/vision/models/lenet.py).

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
from torch import nn

from ...core.place import DeviceLike, resolve_device
from ...nn.layer import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ...nn.layer.layers import load_jax_state

__all__ = ["LeNet"]


class LeNet(nn.Module):
    """Weights are drawn on the CPU from `seed` (the JAX package's
    families: Kaiming-uniform convolutions, Xavier-normal linears, zero
    biases) and then moved to `device`."""

    def __init__(self, num_classes=10, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
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
        self.to(resolve_device(device))

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv2D):
                lim = math.sqrt(6.0 / m.fan_in)
                m.weight.uniform_(-lim, lim, generator=g)
            elif isinstance(m, Linear):
                fi, fo = m.weight.shape
                m.weight.normal_(0.0, math.sqrt(2.0 / (fi + fo)), generator=g)

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
