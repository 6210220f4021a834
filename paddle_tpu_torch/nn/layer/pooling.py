"""MaxPool2D and AdaptiveAvgPool2D (port of paddle_tpu/nn/layer/
pooling.py)."""
from __future__ import annotations

from ...core.unported import require_defaults
from ..functional.conv import _require_nchw
from ..functional.pooling import adaptive_avg_pool2d, max_pool2d
from .layers import Layer

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        require_defaults("MaxPool2D", return_mask=(return_mask, False))
        _require_nchw(data_format)
        self._args = (kernel_size, stride, padding)
        self._ceil_mode = ceil_mode

    def forward(self, x):
        return max_pool2d(x, *self._args, ceil_mode=self._ceil_mode)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        _require_nchw(data_format)
        self._output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool2d(x, self._output_size)
