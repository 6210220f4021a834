"""Conv2D (port of paddle_tpu/nn/layer/conv.py `Conv2D`).

The weight is [out, in/groups, kh, kw]; its default initializer is the
JAX package's KaimingUniform with fan_in = in_channels * kh * kw, drawn
by the model that owns the layer (vision/models/resnet.py). The bias
starts at zero; bias_attr=False drops it. padding_mode other than
"zeros" and a weight_attr are not ported yet."""
from __future__ import annotations

import torch
from torch import nn

from ...core.unported import require_defaults
from ..functional.conv import _pair, _require_nchw, conv2d

__all__ = ["Conv2D"]


class Conv2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW"):
        super().__init__()
        require_defaults("Conv2D", padding_mode=(padding_mode, "zeros"),
                         weight_attr=(weight_attr, None))
        _require_nchw(data_format)
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"channels {in_channels} -> {out_channels} "
                             f"are not divisible by groups {groups}")
        self._in_channels = in_channels
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *_pair(kernel_size)))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_channels))

    @property
    def fan_in(self) -> int:
        return self._in_channels * self.weight.shape[2] * self.weight.shape[3]

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups)
