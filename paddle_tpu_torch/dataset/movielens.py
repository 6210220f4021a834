"""paddle.dataset.movielens (port of paddle_tpu/dataset/movielens.py;
reference dataset/movielens.py) over paddle.text.datasets.Movielens."""
from __future__ import annotations

__all__ = ["train", "test"]


def _reader(mode):
    def rd():
        from ..text.datasets import Movielens
        ds = Movielens(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i])
    return rd


def train():
    return _reader("train")


def test():
    return _reader("test")
