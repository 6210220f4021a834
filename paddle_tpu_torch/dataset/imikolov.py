"""paddle.dataset.imikolov (port of paddle_tpu/dataset/imikolov.py;
reference dataset/imikolov.py: build_dict(), train(word_idx,
n)/test(word_idx, n) yielding n-gram tuples)."""
from __future__ import annotations

__all__ = ["train", "test", "build_dict"]


def build_dict(min_word_freq=50):
    from ..text.datasets import Imikolov
    return Imikolov(mode="train", data_type="NGRAM", window_size=2) \
        .word_idx


def _reader(mode, word_idx, n):
    def rd():
        from ..text.datasets import Imikolov
        ds = Imikolov(mode=mode, data_type="NGRAM", window_size=n)
        for i in range(len(ds)):
            yield tuple(int(v) for v in ds[i])
    return rd


def train(word_idx, n, data_type="NGRAM"):
    return _reader("train", word_idx, n)


def test(word_idx, n, data_type="NGRAM"):
    return _reader("test", word_idx, n)
