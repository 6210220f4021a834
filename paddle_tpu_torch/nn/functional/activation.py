"""Activations (port of paddle_tpu/nn/functional/activation.py, the ones
the GPT, ResNet, BERT and LeNet train steps and the eager surface call),
registered under the JAX package's op types ("softmax" is on the AMP
black list)."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...core.dispatch import op
from ...core.dtypes import convert_dtype

__all__ = ["relu", "gelu", "tanh", "softmax"]


@op("relu")
def _relu(x):
    return torch.relu(x)


def relu(x, name=None):
    """max(x, 0)."""
    return _relu(x)


@op("gelu")
def _gelu(x, approximate):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return _gelu(x, bool(approximate))


@op("tanh")
def _tanh(x):
    return torch.tanh(x)


def tanh(x, name=None):
    """Elementwise tanh (the BERT pooler's)."""
    return _tanh(x)


@op("softmax")
def _softmax(x, axis):
    return torch.softmax(x, dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    """softmax over `axis`; dtype casts the input first."""
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return _softmax(x, axis)
