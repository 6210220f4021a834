"""Conv2D (port of paddle_tpu/nn/layer/conv.py `Conv2D`).

The weight is [out, in/groups, kh, kw], drawn at construction with the
JAX package's default, KaimingUniform with fan_in = in_channels * kh *
kw (or weight_attr's initializer); the bias starts at zero and
bias_attr=False drops it. padding_mode other than "zeros" is not ported
yet."""
from __future__ import annotations

import numpy as np

from ...core.unported import require_defaults
from .. import initializer as I
from ..functional.conv import _pair, _require_nchw, conv2d
from .layers import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW"):
        super().__init__()
        require_defaults("Conv2D", padding_mode=(padding_mode, "zeros"))
        _require_nchw(data_format)
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"channels {in_channels} -> {out_channels} "
                             f"are not divisible by groups {groups}")
        self._in_channels = in_channels
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        kernel = _pair(kernel_size)
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, *kernel],
            attr=weight_attr, default_initializer=I.KaimingUniform(
                fan_in=in_channels * int(np.prod(kernel))))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True)

    @property
    def fan_in(self) -> int:
        return self._in_channels * self.weight.shape[2] * self.weight.shape[3]

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups)
