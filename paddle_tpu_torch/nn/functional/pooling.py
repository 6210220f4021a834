"""max_pool2d and adaptive_avg_pool2d (port of paddle_tpu/nn/functional/
pooling.py, the two ResNet calls).

The JAX package lowers pooling to lax.reduce_window (max pads with
-inf) and to reshape-and-mean bins; torch's max_pool2d (implicit -inf
padding) and adaptive_avg_pool2d (bin i covers [floor(i*in/out),
ceil((i+1)*in/out)), the JAX package's bins) compute the same. NCHW
only."""
from __future__ import annotations

from torch.nn import functional as F

from ...core.unported import require_defaults
from .conv import _require_nchw

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max pooling; return_mask (the argmax indices) is not ported yet."""
    require_defaults("max_pool2d", return_mask=(return_mask, False))
    _require_nchw(data_format)
    return F.max_pool2d(x, kernel_size,
                        kernel_size if stride is None else stride, padding,
                        ceil_mode=ceil_mode)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over adaptive bins; a None in output_size keeps that dim."""
    _require_nchw(data_format)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    output_size = tuple(x.shape[2 + i] if o is None else int(o)
                        for i, o in enumerate(output_size))
    return F.adaptive_avg_pool2d(x, output_size)
