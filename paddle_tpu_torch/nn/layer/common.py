"""Linear, Embedding and Dropout (port of paddle_tpu/nn/layer/common.py).

Parameter layouts are Paddle's: Linear.weight is [in, out]."""
from __future__ import annotations

import torch
from torch import nn

from ...core.unported import require_defaults
from ..functional import common as F

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """y = x @ weight + bias with weight [in, out]; bias_attr=False drops
    the bias. A weight_attr (ParamAttr initializers) is not ported yet:
    the owning model initialises the weight."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        require_defaults("Linear", weight_attr=(weight_attr, None))
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = None if bias_attr is False \
            else nn.Parameter(torch.zeros(out_features))

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
    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        require_defaults("Dropout", axis=(axis, None),
                         mode=(mode, "upscale_in_train"))
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
