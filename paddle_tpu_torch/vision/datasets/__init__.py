"""Vision datasets (port of paddle_tpu/vision/datasets, numpy only).

Reference: python/paddle/vision/datasets/ (MNIST, FashionMNIST, Cifar10/100,
Flowers, VOC2012, DatasetFolder) which download from paddle's CDN. This
environment has zero network egress, so each dataset loads from a local
`data_file`/`data_dir` when given one (same on-disk formats as the
reference), and otherwise falls back to a deterministic synthetic sample
generator with the right shapes/classes — enough for pipeline and training
tests (the reference's own unit tests monkeypatch downloads similarly).
"""
from .mnist import MNIST, FashionMNIST  # noqa: F401
from .cifar import Cifar10, Cifar100  # noqa: F401
from .folder import DatasetFolder, ImageFolder  # noqa: F401
from .flowers import Flowers  # noqa: F401
from .voc2012 import VOC2012  # noqa: F401
