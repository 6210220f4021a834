"""paddle.dataset.conll05 (port of paddle_tpu/dataset/conll05.py; reference
dataset/conll05.py) over paddle.text.datasets.Conll05st."""
from __future__ import annotations

__all__ = ["test", "get_dict"]


def get_dict():
    """(word dict, predicate dict, label dict) of the corpus. The JAX
    package's reads a `predicate_dict` attribute its Conll05st lacks
    and raises AttributeError; this returns Conll05st.get_dict()."""
    from ..text.datasets import Conll05st
    return Conll05st().get_dict()


def test():
    def rd():
        from ..text.datasets import Conll05st
        ds = Conll05st()
        for i in range(len(ds)):
            yield tuple(ds[i])
    return rd
