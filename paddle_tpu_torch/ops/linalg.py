"""matmul and bmm (port of the parts of paddle_tpu/ops/linalg.py that
the eager surface reaches), registered as the JAX package's op types
"matmul_v2" and "bmm" (both on the AMP white list)."""
from __future__ import annotations

import torch

from ..core.dispatch import op

__all__ = ["matmul", "bmm"]


@op("matmul_v2")
def _matmul(x, y, transpose_x, transpose_y):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _matmul(x, y, transpose_x, transpose_y)


@op("bmm")
def _bmm(x, y):
    return torch.bmm(x, y)


def bmm(x, y, name=None):
    return _bmm(x, y)
