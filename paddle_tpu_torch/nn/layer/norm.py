"""LayerNorm (port of paddle_tpu/nn/layer/norm.py `LayerNorm`)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """Normalizes over the trailing `normalized_shape` dims; weight ones,
    bias zeros (Paddle's defaults)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._normalized_shape))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape))

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)
