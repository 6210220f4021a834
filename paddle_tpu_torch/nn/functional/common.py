"""Common functionals (port of paddle_tpu/nn/functional/common.py, its
sequence-model half), registered under the JAX package's op types:
"linear" (on the AMP white list), "lookup_table_v2", "dropout",
"one_hot_v2", "label_smooth", "cosine_similarity", "normalize_l2" and
"bilinear".

`linear` keeps Paddle's [in, out] weight layout. `embedding` zeroes the
rows of `padding_idx` as the reference does (a negative index counts
from the end); `sparse` (SelectedRows gradients) is not ported yet.
`dropout` draws its mask from the port's generator of x's device
(core/random.py), so paddle.seed fixes it; the JAX stream cannot be
matched, so no draw is compared with it. A mask shared along axes
(`axis`: the mask has x's size on the listed axes and 1 elsewhere) and
"downscale_in_infer" (the train pass keeps the kept values as they are,
eval scales by 1 - p) compute as the JAX package does; dropout2d/3d
share the mask over the spatial axes. The interpolation, padding,
pixel_shuffle and unfold functionals belong to the vision-side slice
(ROADMAP Queue 1 item 4c)."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...core import random as _random
from ...core.dispatch import op
from ...core.unported import require_defaults

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "one_hot", "label_smooth", "cosine_similarity",
           "normalize", "bilinear"]


@op("linear")
def _linear(x, weight, bias):
    return F.linear(x, weight.t(), bias)


def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight [in, out]."""
    return _linear(x, weight, bias)


@op("lookup_table_v2")
def _embedding(weight, ids, padding_idx):
    out = F.embedding(ids.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids in x; rows of padding_idx come back
    zero (and pass no gradient)."""
    require_defaults("embedding", sparse=(sparse, False))
    if padding_idx is not None and padding_idx < 0:
        padding_idx = weight.shape[0] + padding_idx
    return _embedding(weight, x, padding_idx)


@op("dropout")
def _dropout(x, mask, p, mode):
    if mode == "upscale_in_train":
        return x * mask / (1.0 - p)
    return x * mask


def _keep_mask(x, p, shape):
    keep = torch.rand(shape, generator=_random.generator(x.device),
                      device=x.device) >= p
    return keep.to(x.dtype)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Paddle's dropout: "upscale_in_train" scales the kept values by
    1 / (1 - p) in training; "downscale_in_infer" keeps them in training
    and scales x by 1 - p in eval. `axis` (an int or a list) draws one
    mask value per index of those axes, shared along the others."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * 0.0
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    return _dropout(x, _keep_mask(x, p, shape), p, mode)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: one mask value per (sample, channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """Dropout for SELU networks: dropped values take alpha' = -alpha *
    scale, then the affine map a x + b, with the JAX package's constants
    a = ((1 + p alpha'^2) / (1 - p))^(-1/2) and b = -a alpha' p."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    mask = _keep_mask(x, p, list(x.shape))
    a = (1.0 / (1.0 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    return (x * mask + alpha_p * (1.0 - mask)) * a + b


@op("one_hot_v2", differentiable=False)
def _one_hot(x, num_classes):
    return F.one_hot(x.long(), num_classes).to(torch.float32)


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows of the ids in x, classes on a new last axis."""
    if torch.is_tensor(num_classes):
        num_classes = int(num_classes.item())
    return _one_hot(x, num_classes)


@op("label_smooth")
def _label_smooth(label, epsilon, prior):
    if prior is None:
        return (1 - epsilon) * label + epsilon / label.shape[-1]
    return (1 - epsilon) * label + epsilon * prior


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) label + epsilon prior (uniform over the last axis
    when no prior_dist)."""
    return _label_smooth(label, epsilon, prior_dist)


@op("cosine_similarity")
def _cosine_similarity(x1, x2, axis, eps):
    dot = (x1 * x2).sum(dim=axis)
    n1 = (x1 * x1).sum(dim=axis).sqrt()
    n2 = (x2 * x2).sum(dim=axis).sqrt()
    return dot / torch.clamp(n1 * n2, min=eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return _cosine_similarity(x1, x2, axis, eps)


@op("normalize_l2")
def _normalize(x, p, axis, epsilon):
    if p == 2:
        n = x.square().sum(dim=axis, keepdim=True).sqrt()
    else:
        n = x.abs().pow(p).sum(dim=axis, keepdim=True).pow(1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x over its p-norm along axis (at least epsilon)."""
    return _normalize(x, p, axis, epsilon)


@op("bilinear")
def _bilinear(x1, x2, weight, bias):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def bilinear(x1, x2, weight, bias=None, name=None):
    """x1 W_o x2 for each output o, weight [out, in1, in2]."""
    return _bilinear(x1, x2, weight, bias)
