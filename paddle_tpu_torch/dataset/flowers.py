"""paddle.dataset.flowers (port of paddle_tpu/dataset/flowers.py; reference
dataset/flowers.py) over paddle.vision.datasets.Flowers."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "valid"]


def _reader(mode):
    def rd():
        from ..vision.datasets import Flowers
        ds = Flowers(mode=mode)
        for i in range(len(ds)):
            img, lab = ds[i]
            yield np.asarray(img, np.float32), int(lab)
    return rd


def train():
    return _reader("train")


def test():
    return _reader("test")


def valid():
    return _reader("valid")
