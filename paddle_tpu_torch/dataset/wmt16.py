"""paddle.dataset.wmt16 (port of paddle_tpu/dataset/wmt16.py; reference
dataset/wmt16.py) over paddle.text.datasets.WMT16."""
from __future__ import annotations

__all__ = ["train", "test"]


def _reader(mode, src_dict_size, trg_dict_size):
    def rd():
        from ..text.datasets import WMT16
        ds = WMT16(mode=mode, src_dict_size=src_dict_size,
                   trg_dict_size=trg_dict_size)
        for i in range(len(ds)):
            yield tuple(ds[i])
    return rd


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("train", src_dict_size, trg_dict_size)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("test", src_dict_size, trg_dict_size)
