"""Activations (port of paddle_tpu/nn/functional/activation.py, the ones
the GPT, ResNet and BERT train steps call)."""
from __future__ import annotations

import torch
from torch.nn import functional as F

__all__ = ["relu", "gelu", "tanh"]


def relu(x):
    """max(x, 0)."""
    return torch.relu(x)


def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    """Elementwise tanh (the BERT pooler's)."""
    return torch.tanh(x)
