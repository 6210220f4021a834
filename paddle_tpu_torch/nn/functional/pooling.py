"""Pooling functionals (port of paddle_tpu/nn/functional/pooling.py): max
and average pooling over 1-3 spatial dims and the adaptive pools, in
channel-first (NCL, NCHW, NCDHW) and channel-last (NLC, NHWC, NDHWC)
layouts.

The JAX package lowers pooling to lax.reduce_window over explicitly
padded windows (`_full_padding`, pooling.py:81-110): "SAME" splits
XLA's way (the odd pixel after), and ceil_mode pads the high side until
the last window fits, Paddle's rule out = (H - k + 2p + s - 1) / s + 1.
torch's own ceil_mode drops a last window that would start in the
padding, so the port never hands ceil_mode to torch: it computes the
JAX package's padding and pools with ceil_mode off. Max pooling pads
with -inf (the dtype's minimum for integers); when the padding is
symmetric and at most half the window, torch's implicit -inf padding
does the same without a copy. Average pooling (`_avg_pool:59-72`)
divides by the count of real elements when `exclusive` and any padding
(the ceil extra included) is non-zero, else by prod(kernel).

Beyond the JAX package, which drops them: `return_mask` returns (out,
mask), mask holding the flat index of each maximum inside its (N, C)
input plane (Paddle's), and `divisor_override` divides the window sums
by that number. A channel-last tensor is pooled through a permuted view
(torch's channels_last kernels), never copied to channel-first.

The adaptive pools take bin i over [floor(i * in / out),
ceil((i + 1) * in / out)) (`_adaptive_pool:166-190`), which are torch's
bins; a None in output_size keeps that dim."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch.nn import functional as F

from ...core.dispatch import op

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

CHANNEL_LAST = ("NLC", "NWC", "NHWC", "NDHWC")
_FORMATS = {1: ("NCL", "NCW", "NLC", "NWC"), 2: ("NCHW", "NHWC"),
            3: ("NCDHW", "NDHWC")}


def channel_last(data_format, n: int) -> bool:
    """Whether `data_format` puts channels last; raises for a format that
    is not one of the n-d pooling and convolution formats."""
    if data_format not in _FORMATS[n]:
        raise ValueError(f"data_format {data_format!r}: expected one of "
                         f"{_FORMATS[n]}")
    return data_format in CHANNEL_LAST


def to_channel_first(x, n: int, last: bool):
    """[N, *spatial, C] as a [N, C, *spatial] view (no copy)."""
    return x.permute(0, n + 1, *range(1, n + 1)) if last else x


def from_channel_first(x, n: int, last: bool):
    """The inverse view of to_channel_first."""
    return x.permute(0, *range(2, n + 2), 1) if last else x


def tuple_n(v, n: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(i) for i in v)


def norm_padding(padding, n: int):
    """Paddle's padding forms (an int, one int per spatial dim, (lo, hi)
    pairs flat or nested) as (lo, hi) per spatial dim, or the string
    'SAME' / 'VALID' (`_pool_padding`, pooling.py:29-38)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: expected 'SAME' or "
                             f"'VALID'")
        return mode
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding]


def same_split(total: int) -> Tuple[int, int]:
    """XLA's split of a "SAME" padding: the odd pixel goes after."""
    return total // 2, total - total // 2


def window_pads(padding, spatial, kernel, strides, dilations=None
                ) -> List[Tuple[int, int]]:
    """(lo, hi) per spatial dim of a window (pool or convolution) over
    `spatial`, `padding` as norm_padding gives it, the strings resolved
    against the input as XLA does."""
    if padding == "VALID":
        return [(0, 0)] * len(spatial)
    if padding == "SAME":
        dilations = dilations or (1,) * len(spatial)
        return [same_split(max((-(-d // s) - 1) * s + (k - 1) * dl + 1 - d,
                               0))
                for d, k, s, dl in zip(spatial, kernel, strides, dilations)]
    return [(int(lo), int(hi)) for lo, hi in padding]


def full_padding(padding, spatial, kernel, stride, ceil_mode
                 ) -> List[Tuple[int, int]]:
    """window_pads, then ceil_mode's extra on the high side."""
    pads = window_pads(padding, spatial, kernel, stride)
    if ceil_mode:
        new = []
        for (lo, hi), d, k, s in zip(pads, spatial, kernel, stride):
            rem = (d + lo + hi - k) % s
            new.append((lo, hi + ((s - rem) % s if rem else 0)))
        pads = new
    return pads


def flat_pads(pads) -> List[int]:
    """F.pad's order: the last dim's (lo, hi) first."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _implicit(pads, kernel) -> bool:
    """torch pools with this padding itself: symmetric, at most half the
    window."""
    return all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel))


_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _mask_unpadded(mask, pads, spatial, padded):
    """Flat indices into the padded plane -> into the input plane."""
    coords, rest = [], mask
    for size in reversed(padded):
        coords.append(rest % size)
        rest = torch.div(rest, size, rounding_mode="floor")
    out = torch.zeros_like(mask)
    for c, (lo, _), size in zip(reversed(coords), pads, spatial):
        out = out * size + (c - lo)
    return out


@op("pool_max")
def _max_pool(x, kernel, stride, padding, n, last, ceil_mode, return_mask):
    x = to_channel_first(x, n, last)
    spatial = tuple(x.shape[2:])
    pads = full_padding(padding, spatial, kernel, stride, ceil_mode)
    if _implicit(pads, kernel):
        res = _MAX[n](x, kernel, stride, [lo for lo, _ in pads],
                      return_indices=return_mask)
    else:
        fill = -math.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        xp = F.pad(x, flat_pads(pads), value=fill)
        res = _MAX[n](xp, kernel, stride, 0, return_indices=return_mask)
        if return_mask:
            res = (res[0], _mask_unpadded(res[1], pads, spatial,
                                          tuple(xp.shape[2:])))
    if return_mask:
        return (from_channel_first(res[0], n, last),
                from_channel_first(res[1], n, last))
    return from_channel_first(res, n, last)


def _window_sum(x, kernel, stride, n):
    """Sums over each window of an already padded x."""
    if n == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1, *kernel), (1, *stride),
                            divisor_override=1).squeeze(2)
    return _AVG[n](x, kernel, stride, divisor_override=1)


@op("pool_avg")
def _avg_pool(x, kernel, stride, padding, n, last, exclusive, ceil_mode,
              divisor_override):
    x = to_channel_first(x, n, last)
    spatial = tuple(x.shape[2:])
    pads = full_padding(padding, spatial, kernel, stride, ceil_mode)
    padded = any(lo or hi for lo, hi in pads)
    if divisor_override is None and _implicit(pads, kernel):
        pool = F.avg_pool1d if n == 1 else _AVG[n]
        out = pool(x, kernel, stride, [lo for lo, _ in pads],
                   count_include_pad=not (exclusive and padded))
        return from_channel_first(out, n, last)
    xp = F.pad(x, flat_pads(pads)) if padded else x
    summed = _window_sum(xp, kernel, stride, n)
    if divisor_override is not None:
        out = summed / divisor_override
    elif exclusive and padded:
        ones = F.pad(torch.ones((1, 1, *spatial), dtype=x.dtype,
                                device=x.device), flat_pads(pads))
        out = summed / _window_sum(ones, kernel, stride, n)
    else:
        out = summed / float(math.prod(kernel))
    return from_channel_first(out, n, last)


def _pool_api(x, kernel_size, stride, padding, n, data_format, mode,
              exclusive=True, ceil_mode=False, return_mask=False,
              divisor_override=None):
    last = channel_last(data_format, n)
    k = tuple_n(kernel_size, n)
    s = tuple_n(kernel_size if stride is None else stride, n)
    pad = norm_padding(padding, n)
    if mode == "max":
        return _max_pool(x, k, s, pad, n, last, ceil_mode, return_mask)
    return _avg_pool(x, k, s, pad, n, last, exclusive, ceil_mode,
                     divisor_override)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_api(x, kernel_size, stride, padding, 1, data_format, "max",
                     ceil_mode=ceil_mode, return_mask=return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max pooling (op "pool_max"); with return_mask, (out, mask)."""
    return _pool_api(x, kernel_size, stride, padding, 2, data_format, "max",
                     ceil_mode=ceil_mode, return_mask=return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool_api(x, kernel_size, stride, padding, 3, data_format, "max",
                     ceil_mode=ceil_mode, return_mask=return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_api(x, kernel_size, stride, padding, 1, data_format, "avg",
                     exclusive, ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_api(x, kernel_size, stride, padding, 2, data_format, "avg",
                     exclusive, ceil_mode,
                     divisor_override=divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_api(x, kernel_size, stride, padding, 3, data_format, "avg",
                     exclusive, ceil_mode,
                     divisor_override=divisor_override)


_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 1): F.adaptive_max_pool1d,
             ("max", 2): F.adaptive_max_pool2d,
             ("max", 3): F.adaptive_max_pool3d}


@op("adaptive_pool")
def _adaptive_pool(x, output_size, n, last, mode, return_mask):
    x = to_channel_first(x, n, last)
    size = tuple(x.shape[2 + i] if o is None else int(o)
                 for i, o in enumerate(output_size))
    if mode == "max":
        out, mask = _ADAPTIVE["max", n](x, size, return_indices=True)
        if return_mask:
            return (from_channel_first(out, n, last),
                    from_channel_first(mask, n, last))
        return from_channel_first(out, n, last)
    return from_channel_first(_ADAPTIVE["avg", n](x, size), n, last)


def _adaptive_api(x, output_size, n, data_format, mode, return_mask=False):
    if isinstance(output_size, int):
        output_size = (output_size,) * n
    return _adaptive_pool(x, tuple(output_size), n,
                          channel_last(data_format, n), mode, return_mask)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_api(x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over adaptive bins; a None in output_size keeps that dim."""
    return _adaptive_api(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_api(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_api(x, output_size, 1, "NCL", "max", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_api(x, output_size, 2, "NCHW", "max", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_api(x, output_size, 3, "NCDHW", "max", return_mask)
