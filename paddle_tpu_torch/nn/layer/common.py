"""Linear, Embedding and Dropout (port of paddle_tpu/nn/layer/common.py).

Parameter layouts are Paddle's: Linear.weight is [in, out]."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import common as F

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """y = x @ weight + bias with weight [in, out]."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias \
            else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings,
                                               embedding_dim))

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(nn.Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, self.training)
