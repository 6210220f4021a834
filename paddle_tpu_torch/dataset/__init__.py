"""paddle.dataset: the fluid-era reader-style dataset zoo (port of
paddle_tpu/dataset/; reference: python/paddle/dataset/).

Each module exposes `train()` / `test()` sample GENERATORS over the 2.0
Dataset classes (vision.datasets, text.datasets), so fluid-era
`paddle.batch(paddle.dataset.mnist.train(), 32)` pipelines run
unchanged. Numpy only; items are bitwise the JAX package's. Nothing is
downloaded: `common.download` uses a file already placed at its target
and otherwise says where to place it.
"""
from . import common  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import uci_housing  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import flowers  # noqa: F401
from . import voc2012  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401
from . import image  # noqa: F401

__all__ = ["common", "mnist", "cifar", "imdb", "imikolov",
           "uci_housing", "movielens", "conll05", "flowers", "voc2012",
           "wmt14", "wmt16", "image"]
