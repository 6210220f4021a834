"""paddle.dataset.mnist (port of paddle_tpu/dataset/mnist.py; reference
dataset/mnist.py: train()/test() yield (image[784] float32, label int)
samples) over paddle.vision.datasets.MNIST."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]


def _reader(mode):
    def rd():
        from ..vision.datasets import MNIST
        ds = MNIST(mode=mode)
        for i in range(len(ds)):
            img, lab = ds[i]
            yield np.asarray(img, np.float32).reshape(-1), int(lab)
    return rd


def train():
    return _reader("train")


def test():
    return _reader("test")
