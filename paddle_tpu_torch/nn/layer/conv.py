"""Conv1D/2D/3D and Conv1D/2D/3DTranspose (port of paddle_tpu/nn/layer/
conv.py).

The weight is [out, in/groups, k...] and, transposed, [in, out/groups,
k...] (conv.py:12-41), drawn at construction with the JAX package's
default, KaimingUniform with fan_in = in_channels * prod(kernel) (both
kinds), or weight_attr's initializer; the bias starts at zero and
bias_attr=False drops it. `padding_mode` ("reflect", "replicate",
"circular"), which the JAX package stores nowhere, pads that way before
the convolution, as Paddle does. A channel-last 2-D or 3-D layer keeps
its weight in torch's channels_last memory format (the logical shape
and the state dict are unchanged), so cuDNN's NHWC kernels read it
without a per-call transpose."""
from __future__ import annotations

import math

import torch

from .. import initializer as I
from ..functional.conv import _conv, _conv_transpose_nd
from ..functional.pooling import channel_last
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]

_MEMORY_FORMAT = {2: torch.channels_last, 3: torch.channels_last_3d}


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, dims, transposed=False,
                 output_padding=0):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"channels {in_channels} -> {out_channels} "
                             f"are not divisible by groups {groups}")
        if padding_mode not in ("zeros", "reflect", "replicate",
                                "circular"):
            raise ValueError(f"padding_mode {padding_mode!r}")
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * dims
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        self._dims = dims
        self._channel_last = channel_last(data_format, dims)
        self._transposed = transposed
        self._output_padding = output_padding
        if transposed:
            shape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            shape = [out_channels, in_channels // groups, *self._kernel_size]
        self.weight = self.create_parameter(
            shape=shape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=self.fan_in))
        if self._channel_last and dims in _MEMORY_FORMAT:
            self.weight.data = self.weight.data.contiguous(
                memory_format=_MEMORY_FORMAT[dims])
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True)

    @property
    def fan_in(self) -> int:
        return self._in_channels * math.prod(self._kernel_size)

    def forward(self, x):
        return _conv(x, self.weight, self.bias, self._stride, self._padding,
                     self._dilation, self._groups, self._dims,
                     self._channel_last, self._padding_mode)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}, padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 1)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 2)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 3)


class _ConvTransposeNd(_ConvNd):
    def forward(self, x, output_size=None):
        return _conv_transpose_nd(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, self._dims,
                                  self._data_format, output_size)


class Conv1DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 1, transposed=True,
                         output_padding=output_padding)


class Conv2DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 2, transposed=True,
                         output_padding=output_padding)


class Conv3DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 3, transposed=True,
                         output_padding=output_padding)
