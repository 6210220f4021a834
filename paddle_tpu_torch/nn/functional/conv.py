"""Convolutions (port of paddle_tpu/nn/functional/conv.py, :45-192):
conv1d/2d/3d and their transposes, channel-first and channel-last.

The JAX package lowers every convolution to XLA's
`conv_general_dilated`, not to a Pallas kernel, so the port hands it to
the library: torch's convolutions (cuDNN on the GPU). Weights keep
Paddle's layouts, [out, in/groups, k...] and, transposed, [in,
out/groups, k...] (torch's own). A channel-last tensor ([N, L, C],
[N, H, W, C], [N, D, H, W, C]; "NLC"/"NWC" as at conv.py:90-91) goes
through a permuted view: a contiguous NHWC tensor seen as NCHW has
channels_last strides, so cuDNN runs its NHWC kernels and the result,
permuted back, is contiguous channel-last; nothing is transposed in
memory.

Padding takes Paddle's forms: an int, one int per spatial dim, (lo, hi)
pairs flattened ([top, bottom, left, right]) or nested, and the strings
"SAME" (XLA's split: the odd pixel goes after) and "VALID". Asymmetric
padding is applied with F.pad before a convolution with none;
`padding_mode` ("reflect", "replicate", "circular"; the conv layers')
pads that way first.

A transposed convolution in the JAX package is a conv of the spatially
flipped kernel over the input dilated by the stride (conv.py:108-168),
with effective padding d * (k - 1) - lo before and d * (k - 1) - hi +
output_padding after; a string padding goes to that dilated conv as it
stands ("VALID": none, "SAME": d * (k - 1) split XLA's way). torch's
conv_transpose computes the same product for effective padding d *
(k - 1) on both sides; the port takes torch's padding and
output_padding where they express the JAX package's, else crops (or
zero-pads) torch's full result. `output_size` (which the JAX package
drops) sets the output padding so the result has that size, as Paddle
does."""
from __future__ import annotations

from typing import List, Tuple, Union

from torch.nn import functional as F

from ...core.dispatch import op
from .pooling import (channel_last, flat_pads, from_channel_first,
                      norm_padding, same_split, to_channel_first, tuple_n,
                      window_pads)

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@op("conv2d")
def _conv(x, weight, bias, stride, padding, dilation, groups, n, last,
          padding_mode="zeros"):
    strides, dilations = tuple_n(stride, n), tuple_n(dilation, n)
    x = to_channel_first(x, n, last)
    pads = window_pads(norm_padding(padding, n), tuple(x.shape[2:]),
                       tuple(weight.shape[2:]), strides, dilations)
    if padding_mode != "zeros":
        x = F.pad(x, flat_pads(pads), mode=padding_mode)
        pads = [(0, 0)] * n
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        x = F.pad(x, flat_pads(pads))
        sym = [0] * n
    out = _CONV[n](x, weight, bias, strides, sym, dilations, groups)
    return from_channel_first(out, n, last)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format, padding_mode="zeros"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, n,
                 channel_last(data_format, n), padding_mode)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution of x [N, C, L] ("NCL") or [N, L, C] ("NLC") with
    weight [out, in/groups, k]."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding: Union[int, str, list] = 0,
           dilation=1, groups=1, data_format="NCHW", name=None):
    """2-D convolution of NCHW (or NHWC) x with weight [out, in/groups,
    kh, kw] (op "conv2d", on the AMP white list)."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def transpose_pads(padding, spatial, kernel, strides, dilations,
                   output_padding, output_size=None
                   ) -> List[Tuple[int, int]]:
    """The JAX package's effective (lo, hi) padding of the dilated conv
    that a transposed convolution is; output_size, when given, sets the
    output padding so the result has that size."""
    pads = norm_padding(padding, len(spatial))
    full = [dl * (k - 1) for k, dl in zip(kernel, dilations)]
    if pads == "VALID":
        eff = [(0, 0)] * len(spatial)
    elif pads == "SAME":
        eff = [same_split(f) for f in full]
    else:
        eff = [(f - lo, f - hi + op_) for f, (lo, hi), op_ in
               zip(full, pads, output_padding)]
    if output_size is None:
        return eff
    out = []
    for (lo, hi), d, s, f, dl, want in zip(eff, spatial, strides, full,
                                           dilations, output_size):
        extra = int(want) - ((d - 1) * s + 1 + lo + hi - f)
        if not 0 <= extra < max(s, dl):
            raise ValueError(f"output_size {list(output_size)} is not "
                             f"reachable from input {list(spatial)}")
        out.append((lo, hi + extra))
    return out


@op("conv2d_transpose")
def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, last, output_size):
    strides, dilations = tuple_n(stride, n), tuple_n(dilation, n)
    x = to_channel_first(x, n, last)
    kernel = tuple(weight.shape[2:])
    eff = transpose_pads(padding, tuple(x.shape[2:]), kernel, strides,
                         dilations, tuple_n(output_padding, n), output_size)
    full = [dl * (k - 1) for k, dl in zip(kernel, dilations)]
    crop = [(f - lo, f - hi) for f, (lo, hi) in zip(full, eff)]
    if all(c_lo >= 0 and 0 <= c_lo - c_hi < max(s, dl)
           for (c_lo, c_hi), s, dl in zip(crop, strides, dilations)):
        out = _CONV_T[n](x, weight, bias, strides, [c for c, _ in crop],
                         [c_lo - c_hi for c_lo, c_hi in crop], groups,
                         dilations)
    else:
        out = _CONV_T[n](x, weight, None, strides, 0, 0, groups, dilations)
        out = F.pad(out, flat_pads([(-lo, -hi) for lo, hi in crop]))
        if bias is not None:
            out = out + bias.reshape(1, -1, *([1] * n))
    return from_channel_first(out, n, last)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       groups, dilation, n, data_format, output_size=None):
    if output_size is not None:
        output_size = tuple_n(output_size, n)
        output_padding = 0
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, n, channel_last(data_format, n),
                           output_size)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, 1,
                              data_format, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """Transposed 2-D convolution with weight [in, out/groups, kh, kw]
    (op "conv2d_transpose")."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, 2,
                              data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, 3,
                              data_format, output_size)
