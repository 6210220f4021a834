"""LayerNorm and BatchNorm2D (port of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import batch_norm, layer_norm

__all__ = ["LayerNorm", "BatchNorm2D"]


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


class _BatchNormBase(nn.Module):
    """Paddle's batch norm layer: weight ones, bias zeros, buffers `_mean`
    (zeros) and `_variance` (ones), running = momentum * running +
    (1 - momentum) * batch. weight_attr / bias_attr False drop the
    parameter. use_global_stats None follows train/eval mode."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass
