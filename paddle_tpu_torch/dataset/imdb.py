"""paddle.dataset.imdb (port of paddle_tpu/dataset/imdb.py; reference
dataset/imdb.py: word_dict(), train(word_idx)/test(word_idx) yielding
(token_ids, 0/1 label))."""
from __future__ import annotations

__all__ = ["train", "test", "word_dict"]


def word_dict(cutoff=150):
    from ..text.datasets import Imdb
    return Imdb(mode="train", cutoff=cutoff).word_idx


def _reader(mode, word_idx):
    def rd():
        from ..text.datasets import Imdb
        ds = Imdb(mode=mode)
        for i in range(len(ds)):
            doc, lab = ds[i]
            yield list(map(int, doc)), int(lab)
    return rd


def train(word_idx):
    return _reader("train", word_idx)


def test(word_idx):
    return _reader("test", word_idx)
