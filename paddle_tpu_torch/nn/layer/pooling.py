"""MaxPool2D and AdaptiveAvgPool2D (port of paddle_tpu/nn/layer/
pooling.py)."""
from __future__ import annotations

from torch import nn

from ..functional.conv import _require_nchw
from ..functional.pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        _require_nchw(data_format)
        self._args = (kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return max_pool2d(x, *self._args)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        _require_nchw(data_format)
        self._output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool2d(x, self._output_size)
