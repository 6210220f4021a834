"""paddle.dataset.wmt14 (port of paddle_tpu/dataset/wmt14.py; reference
dataset/wmt14.py) over paddle.text.datasets.WMT14."""
from __future__ import annotations

__all__ = ["train", "test"]


def _reader(mode, dict_size):
    def rd():
        from ..text.datasets import WMT14
        ds = WMT14(mode=mode, dict_size=dict_size)
        for i in range(len(ds)):
            yield tuple(ds[i])
    return rd


def train(dict_size):
    return _reader("train", dict_size)


def test(dict_size):
    return _reader("test", dict_size)
