"""logical_or and logical_not (port of the parts of paddle_tpu/ops/
logic.py that nn/decode.py reaches), under the JAX package's op
types."""
from __future__ import annotations

import torch

from ..core.dispatch import op

__all__ = ["logical_or", "logical_not"]


@op("logical_or", differentiable=False)
def _logical_or(x, y):
    return torch.logical_or(x, y)


def logical_or(x, y, name=None):
    return _logical_or(x, y)


@op("logical_not", differentiable=False)
def _logical_not(x):
    return torch.logical_not(x)


def logical_not(x, name=None):
    return _logical_not(x)
