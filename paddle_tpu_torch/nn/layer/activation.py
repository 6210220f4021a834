"""ReLU and GELU (port of paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

from ..functional.activation import gelu, relu
from .layers import Layer

__all__ = ["ReLU", "GELU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return gelu(x, self._approximate)

