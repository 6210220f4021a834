"""paddle.text (port of paddle_tpu/text/): the text datasets."""
from .datasets import (  # noqa: F401
    Imdb, UCIHousing, Imikolov, Movielens, Conll05st, WMT14, WMT16,
)

__all__ = ["Imdb", "UCIHousing", "Imikolov", "Movielens", "Conll05st",
           "WMT14", "WMT16"]
