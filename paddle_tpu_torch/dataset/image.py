"""paddle.dataset.image (port of paddle_tpu/dataset/image.py; reference
dataset/image.py: numpy image transforms used by the fluid-era
pipelines)."""
from __future__ import annotations

import numpy as np

__all__ = ["resize_short", "center_crop", "random_crop", "left_right_flip",
           "to_chw", "simple_transform"]


def _resize(im, h, w):
    # nearest-neighbour resize in pure numpy (no cv2/PIL dependency)
    src_h, src_w = im.shape[:2]
    ri = (np.arange(h) * src_h / h).astype(np.int64)
    ci = (np.arange(w) * src_w / w).astype(np.int64)
    return im[ri][:, ci]


def resize_short(im, size):
    h, w = im.shape[:2]
    if h < w:
        return _resize(im, size, int(w * size / h))
    return _resize(im, int(h * size / w), size)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    hs, ws = (h - size) // 2, (w - size) // 2
    return im[hs:hs + size, ws:ws + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    hs = np.random.randint(0, max(h - size, 0) + 1)
    ws = np.random.randint(0, max(w - size, 0) + 1)
    return im[hs:hs + size, ws:ws + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None):
    im = resize_short(im, resize_size)
    im = random_crop(im, crop_size) if is_train else \
        center_crop(im, crop_size)
    if is_train and np.random.randint(2):
        im = left_right_flip(im)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        im -= np.asarray(mean, np.float32).reshape(-1, 1, 1)
    return im
