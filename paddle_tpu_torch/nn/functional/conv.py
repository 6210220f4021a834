"""conv2d (port of paddle_tpu/nn/functional/conv.py `conv2d`, :55-100).

The JAX package lowers every convolution to XLA's
`conv_general_dilated`, not to a Pallas kernel, so the port hands it to
the library: torch.nn.functional.conv2d (cuDNN on the GPU). Weights keep
Paddle's layout, [out, in/groups, kh, kw] (torch's own), and tensors
stay contiguous NCHW, the JAX default; channel-last (NHWC) is not ported
yet and raises.

Padding takes Paddle's forms: an int, one int per spatial dim, (lo, hi)
pairs flattened ([top, bottom, left, right]) or nested, and the strings
"SAME" (XLA's split: the odd pixel goes after) and "VALID". Asymmetric
padding is applied with F.pad before a convolution with none.
"""
from __future__ import annotations

from typing import List, Tuple, Union

from torch.nn import functional as F

from ...core.dispatch import op

__all__ = ["conv2d"]


def _require_nchw(data_format) -> None:
    """Raise for a channel-last format: the port runs NCHW only."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"data_format {data_format!r}: only NCHW is ported yet")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return tuple(int(i) for i in v)


def _norm_padding(padding, x_hw, kernel, strides, dilations
                  ) -> List[Tuple[int, int]]:
    """(lo, hi) per spatial dim, strings resolved against the input."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0), (0, 0)]
        if mode != "SAME":
            raise ValueError(f"padding {padding!r}: expected 'SAME' or "
                             f"'VALID'")
        pads = []
        for d, k, s, dl in zip(x_hw, kernel, strides, dilations):
            out = -(-d // s)
            total = max((out - 1) * s + (k - 1) * dl + 1 - d, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * 2
    padding = list(padding)
    if len(padding) == 2 and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 4:
        return [(padding[0], padding[1]), (padding[2], padding[3])]
    return [tuple(p) for p in padding]


@op("conv2d")
def _conv2d(x, weight, bias, stride, padding, dilation, groups):
    strides, dilations = _pair(stride), _pair(dilation)
    kernel = tuple(weight.shape[2:])
    pads = _norm_padding(padding, tuple(x.shape[2:]), kernel, strides,
                         dilations)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        (t, b), (l, r) = pads
        x = F.pad(x, (l, r, t, b))
        sym = (0, 0)
    return F.conv2d(x, weight, bias, strides, sym, dilations, groups)


def conv2d(x, weight, bias=None, stride=1, padding: Union[int, str, list] = 0,
           dilation=1, groups=1, data_format="NCHW", name=None):
    """2-D convolution of NCHW x with weight [out, in/groups, kh, kw]
    (op "conv2d", on the AMP white list)."""
    _require_nchw(data_format)
    return _conv2d(x, weight, bias, stride, padding, dilation, groups)
