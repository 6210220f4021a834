"""paddle.dataset.cifar (port of paddle_tpu/dataset/cifar.py; reference
dataset/cifar.py: train10/test10/train100/test100 yielding
(image[3072], label))."""
from __future__ import annotations

import numpy as np

__all__ = ["train10", "test10", "train100", "test100"]


def _reader(cls_name, mode):
    def rd():
        from ..vision import datasets as D
        ds = getattr(D, cls_name)(mode=mode)
        for i in range(len(ds)):
            img, lab = ds[i]
            yield np.asarray(img, np.float32).reshape(-1), int(lab)
    return rd


def train10():
    return _reader("Cifar10", "train")


def test10():
    return _reader("Cifar10", "test")


def train100():
    return _reader("Cifar100", "train")


def test100():
    return _reader("Cifar100", "test")
