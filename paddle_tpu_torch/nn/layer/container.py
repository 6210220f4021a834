"""Sequential (port of paddle_tpu/nn/layer/container.py `Sequential`).

torch's Sequential already names its children "0", "1", ..., the names
the JAX package's state dict uses, so the port only gives it its
Paddle home."""
from __future__ import annotations

from torch import nn

__all__ = ["Sequential"]


class Sequential(nn.Sequential):
    """Runs its layers in order; child i is named str(i)."""
