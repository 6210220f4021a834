"""paddle.dataset.voc2012 (port of paddle_tpu/dataset/voc2012.py; reference
dataset/voc2012.py) over paddle.vision.datasets.VOC2012."""
from __future__ import annotations

__all__ = ["train", "test", "val"]


def _reader(mode):
    def rd():
        from ..vision.datasets import VOC2012
        ds = VOC2012(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i])
    return rd


def train():
    return _reader("train")


def test():
    return _reader("test")


def val():
    return _reader("valid")
