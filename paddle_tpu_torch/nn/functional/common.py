"""Common functionals (port of paddle_tpu/nn/functional/common.py),
registered under the JAX package's op types: "linear" (on the AMP white
list), "lookup_table_v2", "dropout", "one_hot_v2", "label_smooth",
"cosine_similarity", "normalize_l2", "bilinear", "interpolate",
"unfold" and "pixel_shuffle".

`linear` keeps Paddle's [in, out] weight layout. `embedding` zeroes the
rows of `padding_idx` as the reference does (a negative index counts
from the end); `sparse` (SelectedRows gradients) is not ported yet.
`dropout` draws its mask from the port's generator of x's device
(core/random.py), so paddle.seed fixes it; the JAX stream cannot be
matched, so no draw is compared with it. A mask shared along axes
(`axis`: the mask has x's size on the listed axes and 1 elsewhere) and
"downscale_in_infer" (the train pass keeps the kept values as they are,
eval scales by 1 - p) compute as the JAX package does; dropout2d/3d
share the mask over the spatial axes.

`interpolate` follows the JAX package (common.py:173-217), which resizes
with jax.image.resize, not with torch's defaults:
- "nearest" samples floor((i + 0.5) * in / out), half-pixel centres (as
  torch's "nearest-exact" does), computed in float32 as jax does;
- "linear", "bilinear", "trilinear", "bicubic" and "area" (which maps to
  linear) apply jax's separable weight matrices (`compute_weight_mat`:
  half-pixel sample points, the kernel widened by in / out when
  shrinking, so they antialias, weights normalised to sum to 1, zero
  for a sample point outside the input); "bicubic" is Keys' kernel
  with a = -0.5 (torch's bicubic uses -0.75);
- with align_corners, the JAX package samples linspace(0, in - 1, out)
  with map_coordinates of order 1 (linear modes) and order 0 for
  bicubic (the nearest sample, rounding half away from zero), clamped
  at the edges. The port keeps those results.
The output size comes from `size`, or from the spatial dims times
scale_factor. The JAX package scales x.shape[2:] even for a
channel-last input, a fault (its size then mixes a spatial dim and the
channels); the port scales the spatial dims. `align_mode` is accepted
and ignored, as in the JAX package (its interpolate never reads it).

`unfold` reads `paddings` as [top, left, bottom, right] (common.py:
237-247). `pixel_shuffle` keeps the JAX package's channel order in both
layouts: NCHW channel c * r * r + i * r + j, NHWC (i * r + j) * C + c."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...core import random as _random
from ...core.dispatch import op
from ...core.unported import require_defaults
from .pooling import CHANNEL_LAST

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "one_hot", "label_smooth", "cosine_similarity",
           "normalize", "bilinear", "interpolate", "upsample", "unfold",
           "pixel_shuffle"]


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


# ---------------------------------------------------------------- resize
_METHOD = {"nearest": "nearest", "bilinear": "linear", "trilinear": "linear",
           "linear": "linear", "bicubic": "cubic", "area": "linear"}


def _linear_kernel(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic_kernel(x):
    """Keys' cubic with a = -0.5, as jax.image uses."""
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in, n_out, method, device):
    """jax.image's `compute_weight_mat` for scale out / in, translation 0,
    antialiasing: [n_in, n_out] float32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = (_linear_kernel if method == "linear" else _keys_cubic_kernel)(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(
        torch.float32).eps), w / torch.where(total != 0, total,
                                              torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _corner_weights(n_in, n_out, order, device):
    """map_coordinates(order, mode="nearest") at linspace(0, n_in - 1,
    n_out), as [n_in, n_out] float32."""
    if n_out == 1:
        coord = torch.zeros(1, dtype=torch.float32, device=device)
    else:
        coord = torch.linspace(0, n_in - 1, n_out, dtype=torch.float32,
                               device=device)
    w = torch.zeros(n_in, n_out, dtype=torch.float32, device=device)
    cols = torch.arange(n_out, device=device)
    if order == 0:
        # lax.round: half away from zero (the coordinates are >= 0)
        idx = torch.floor(coord)
        idx = (idx + (coord - idx >= 0.5).float()).long().clamp(0, n_in - 1)
        w[idx, cols] = 1.0
        return w
    lo = torch.floor(coord)
    hi_w = coord - lo
    lo = lo.long()
    w.index_put_((lo.clamp(0, n_in - 1), cols), 1.0 - hi_w, accumulate=True)
    w.index_put_(((lo + 1).clamp(0, n_in - 1), cols), hi_w, accumulate=True)
    return w


def _nearest_index(n_in, n_out, device):
    return torch.floor((torch.arange(n_out, dtype=torch.float32,
                                     device=device) + 0.5)
                       * n_in / n_out).long()


@op("interpolate")
def _interpolate(x, out_size, mode, align_corners, data_format):
    first = 1 if data_format in CHANNEL_LAST else 2
    method = _METHOD[mode]
    for i, n_out in enumerate(out_size):
        ax = first + i
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        if method == "nearest":
            x = x.index_select(ax, _nearest_index(n_in, n_out, x.device))
            continue
        if align_corners:
            w = _corner_weights(n_in, n_out, 1 if method == "linear" else 0,
                                x.device)
        else:
            w = _resize_weights(n_in, n_out, method, x.device)
        x = torch.tensordot(x, w.to(x.dtype), dims=([ax], [0])).movedim(
            -1, ax)
    return x


def _interp_size(x, size, scale_factor, data_format):
    spatial = x.shape[1:-1] if data_format in CHANNEL_LAST else x.shape[2:]
    if size is not None:
        if torch.is_tensor(size):
            size = size.tolist()
        return [int(s.item() if torch.is_tensor(s) else s) for s in size]
    if isinstance(scale_factor, (int, float)):
        scale_factor = [scale_factor] * len(spatial)
    return [int(d * s) for d, s in zip(spatial, scale_factor)]


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims to `size` (or times scale_factor) by
    jax.image.resize's rules (see the module docstring)."""
    if mode not in _METHOD:
        raise ValueError(f"mode {mode!r}: expected one of {sorted(_METHOD)}")
    return _interpolate(x, tuple(_interp_size(x, size, scale_factor,
                                              data_format)),
                        mode, bool(align_corners), data_format)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@op("unfold")
def _unfold(x, kernel, strides, paddings, dilations):
    if len(paddings) == 4:
        top, left, bottom, right = paddings
    else:
        top = bottom = paddings[0]
        left = right = paddings[1]
    if top == bottom and left == right:
        return F.unfold(x, kernel, dilations, (top, left), strides)
    return F.unfold(F.pad(x, (left, right, top, bottom)), kernel, dilations,
                    0, strides)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Sliding [C * kh * kw] patches of NCHW x, as [N, C * kh * kw, L]."""
    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)
    pd = [paddings] * 2 if isinstance(paddings, int) else list(paddings)
    return _unfold(x, tuple(_pair(kernel_sizes)), tuple(_pair(strides)),
                   tuple(pd), tuple(_pair(dilations)))


@op("pixel_shuffle")
def _pixel_shuffle(x, factor, data_format):
    if data_format == "NCHW":
        return F.pixel_shuffle(x, factor)
    n, h, w, c = x.shape
    oc = c // (factor * factor)
    x = x.reshape(n, h, w, factor, factor, oc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * factor, w * factor, oc)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _pixel_shuffle(x, upscale_factor, data_format)
