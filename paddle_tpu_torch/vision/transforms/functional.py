"""Transform functionals over numpy HWC/CHW arrays (port of
paddle_tpu/vision/transforms/functional.py, after the reference's
functional_cv2.py).

Everything but `resize` is the JAX module's numpy. `resize`
(paddle_tpu/vision/transforms/functional.py:23-41) runs
jax.image.resize there, which antialiases when it shrinks: its
"linear" and "cubic" kernels are widened by in/out, the weights are
normalised to sum to one, and samples outside the input get zero weight.
The port computes the same per-axis weight matrices in torch
(nn/functional/common.py `_resize_weights`, the one the port's
`interpolate` uses; cached per size) and contracts the image with them
in float32, the columns first, as two matrix products on the calling
thread; "nearest" picks floor((i + 0.5) * in / out). The result is a
float32 HWC numpy array, as in JAX.
"""
from __future__ import annotations

import functools
import numbers

import numpy as np
import torch


def _is_chw(img):
    return img.ndim == 3 and img.shape[0] in (1, 3, 4) and \
        img.shape[0] < img.shape[1]


def to_hwc(img):
    if img.ndim == 2:
        return img[:, :, None]
    if _is_chw(img):
        return np.transpose(img, (1, 2, 0))
    return img


def resize(img, size, interpolation="bilinear"):
    hwc = to_hwc(np.asarray(img))
    h, w = hwc.shape[:2]
    if isinstance(size, int):
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    method = {"bilinear": "linear", "nearest": "nearest",
              "bicubic": "cubic"}.get(interpolation, "linear")
    x = torch.from_numpy(np.ascontiguousarray(hwc)).float()
    c = x.shape[2]
    if w != ow:                   # [h, w, c] -> [h, c, w] @ [w, ow]
        if method == "nearest":
            x = x[:, _nearest(w, ow)]
        else:
            x = (x.transpose(1, 2) @ _weights(w, ow, method)).transpose(1, 2)
    if h != oh:                   # [oh, h] @ [h, ow * c]
        if method == "nearest":
            x = x[_nearest(h, oh)]
        else:
            x = (_weights(h, oh, method).T @ x.reshape(h, -1)).reshape(
                oh, ow, c)
    return x.contiguous().numpy()


@functools.lru_cache(maxsize=1024)
def _weights(n_in, n_out, method):
    """jax.image.resize's [n_in, n_out] float32 weight matrix for one
    axis (nn/functional/common.py `_resize_weights`), cached: the
    random crops of a pipeline repeat a few hundred sizes."""
    from ...nn.functional.common import _resize_weights
    return _resize_weights(n_in, n_out, method, "cpu")


@functools.lru_cache(maxsize=1024)
def _nearest(n_in, n_out):
    from ...nn.functional.common import _nearest_index
    return _nearest_index(n_in, n_out, "cpu")


def crop(img, top, left, height, width):
    hwc = to_hwc(np.asarray(img))
    return hwc[top:top + height, left:left + width]


def center_crop(img, output_size):
    hwc = to_hwc(np.asarray(img))
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = hwc.shape[:2]
    th, tw = output_size
    top = max((h - th) // 2, 0)
    left = max((w - tw) // 2, 0)
    return crop(hwc, top, left, th, tw)


def hflip(img):
    return to_hwc(np.asarray(img))[:, ::-1]


def vflip(img):
    return to_hwc(np.asarray(img))[::-1]


def pad(img, padding, fill=0, padding_mode="constant"):
    hwc = to_hwc(np.asarray(img))
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = padding
    width = [(t, b), (l, r), (0, 0)]
    if padding_mode == "constant":
        return np.pad(hwc, width, constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    return np.pad(hwc, width, mode=mode)


def adjust_brightness(img, factor):
    return np.clip(to_hwc(np.asarray(img)).astype(np.float32) * factor,
                   0, 255)


def adjust_contrast(img, factor):
    hwc = to_hwc(np.asarray(img)).astype(np.float32)
    mean = hwc.mean()
    return np.clip((hwc - mean) * factor + mean, 0, 255)


def adjust_saturation(img, factor):
    hwc = to_hwc(np.asarray(img)).astype(np.float32)
    gray = hwc.mean(axis=2, keepdims=True)
    return np.clip((hwc - gray) * factor + gray, 0, 255)


def to_grayscale(img, num_output_channels=1):
    hwc = to_hwc(np.asarray(img)).astype(np.float32)
    if hwc.shape[2] >= 3:
        gray = (0.299 * hwc[..., 0] + 0.587 * hwc[..., 1]
                + 0.114 * hwc[..., 2])[..., None]
    else:
        gray = hwc[..., :1]
    return np.repeat(gray, num_output_channels, axis=2)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    hwc = to_hwc(np.asarray(img)).astype(np.float32)
    h, w = hwc.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta = np.deg2rad(angle)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ys = cy + np.sin(theta) * (xx - cx) + np.cos(theta) * (yy - cy)
    xs = cx + np.cos(theta) * (xx - cx) - np.sin(theta) * (yy - cy)
    yi = np.clip(np.round(ys).astype(int), 0, h - 1)
    xi = np.clip(np.round(xs).astype(int), 0, w - 1)
    out = hwc[yi, xi]
    invalid = (ys < 0) | (ys > h - 1) | (xs < 0) | (xs > w - 1)
    out[invalid] = fill
    return out


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        if arr.ndim == 2:
            arr = arr[None]
        if not _is_chw(arr):
            arr = np.transpose(arr, (2, 0, 1))
        return (arr - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    return (to_hwc(arr) - mean) / std


def to_tensor(img, data_format="CHW"):
    arr = np.asarray(img, np.float32) / 255.0
    if data_format == "CHW":
        if arr.ndim == 2:
            return arr[None]
        if not _is_chw(arr):
            arr = np.transpose(arr, (2, 0, 1))
    return arr
