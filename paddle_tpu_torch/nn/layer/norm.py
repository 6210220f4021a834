"""LayerNorm and BatchNorm2D (port of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch

from ...core import place as _place
from .. import initializer as I
from ..functional.norm import batch_norm, layer_norm
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm2D"]


class LayerNorm(Layer):
    """Normalizes over the trailing `normalized_shape` dims; weight ones,
    bias zeros (Paddle's defaults); weight_attr / bias_attr False drop
    them."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(shape=self._normalized_shape,
                                  attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)


class _BatchNormBase(Layer):
    """Paddle's batch norm layer: weight ones, bias zeros, buffers `_mean`
    (zeros) and `_variance` (ones), running = momentum * running +
    (1 - momentum) * batch. weight_attr / bias_attr False drop the
    parameter. use_global_stats None follows train/eval mode."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            self.create_parameter(shape=[num_features], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)
        dev = self.weight.device if self.weight is not None else \
            _place.resolve_device(None)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        return batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass
