"""paddle.dataset.uci_housing (port of paddle_tpu/dataset/uci_housing.py;
reference dataset/uci_housing.py: train()/test() yielding (features[13],
price))."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "feature_names"]

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
                 "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT"]


def _reader(mode):
    def rd():
        from ..text.datasets import UCIHousing
        ds = UCIHousing(mode=mode)
        for i in range(len(ds)):
            x, y = ds[i]
            yield np.asarray(x, np.float32), np.asarray(y, np.float32)
    return rd


def train():
    return _reader("train")


def test():
    return _reader("test")
