"""Linear, Embedding and Dropout (port of paddle_tpu/nn/layer/common.py).

Parameter layouts are Paddle's: Linear.weight is [in, out]. The weights
are drawn at construction with the reference's defaults (Layer.
create_parameter, nn/initializer.py): XavierNormal for Linear's weight
and a zero bias, Normal(0, 1) for Embedding, with the padding_idx row
zeroed. weight_attr / bias_attr take a ParamAttr (or a name, or an
initializer); bias_attr=False drops the bias."""
from __future__ import annotations

import torch

from ...core.unported import require_defaults
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x @ weight + bias with weight [in, out]."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self._in_features, self._out_features = in_features, out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """Rows of a [num_embeddings, embedding_dim] table; the padding_idx
    row starts at zero and its lookups stay zero. sparse (SelectedRows
    gradients) is not ported yet."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None,
                 name=None):
        super().__init__()
        require_defaults("Embedding", sparse=(sparse, False))
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            pi = padding_idx if padding_idx >= 0 \
                else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight[pi] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        require_defaults("Dropout", axis=(axis, None),
                         mode=(mode, "upscale_in_train"))
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
