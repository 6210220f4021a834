"""Common layers (port of paddle_tpu/nn/layer/common.py): Linear,
Identity, the dropouts, Embedding, Flatten, CosineSimilarity,
PairwiseDistance, Bilinear, and the vision half: Upsample,
UpsamplingNearest2D, UpsamplingBilinear2D (align_corners), Pad1D/2D/3D,
ZeroPad2D and PixelShuffle over nn.functional's interpolate, pad and
pixel_shuffle.

Parameter layouts are Paddle's: Linear.weight is [in, out], Bilinear's
[out, in1, in2]. The weights are drawn at construction with the
reference's defaults (Layer.create_parameter, nn/initializer.py):
XavierNormal for weights and a zero bias, Normal(0, 1) for Embedding,
with the padding_idx row zeroed. weight_attr / bias_attr take a
ParamAttr (or a name, or an initializer); bias_attr=False drops the
bias."""
from __future__ import annotations

import torch

from ...core.unported import require_defaults
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Identity", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Embedding", "Flatten", "CosineSimilarity",
           "PairwiseDistance", "Bilinear", "Upsample", "UpsamplingNearest2D",
           "UpsamplingBilinear2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
           "PixelShuffle"]


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


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


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
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ...ops import manipulation as M
        return M.flatten(x, self.start_axis, self.stop_axis)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """||x - y + epsilon||_p over the last axis (the reference adds
    epsilon to the difference before the norm)."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return torch.linalg.vector_norm(x - y + self.epsilon, ord=self.p,
                                        dim=-1, keepdim=self.keepdim)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features],
            attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format):
        super().__init__()
        self._pad = padding
        self._mode = mode
        self._value = value
        self._data_format = data_format

    def forward(self, x):
        pad = self._pad
        if isinstance(pad, int):
            pad = [pad] * (2 * (x.ndim - 2))
        return F.pad(x, pad, mode=self._mode, value=self._value,
                     data_format=self._data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)
