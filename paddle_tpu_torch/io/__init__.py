"""paddle.io of the port (paddle_tpu/io/__init__.py): Dataset, the
samplers, DataLoader and DeviceLoader.

The JAX package's export list, in its order. `InMemoryDataset` and
`QueueDataset` sit over the JAX package's native C++ datafeed
(io/dataset_native.py); here they raise NotImplementedError until that
datafeed is ported with native/ (ROADMAP Queue 1 item 8).
"""
from .dataset import (  # noqa: F401
    Dataset, IterableDataset, TensorDataset, ComposeDataset, ChainDataset,
    Subset, random_split, ConcatDataset,
)
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, WeightedRandomSampler,
    BatchSampler, DistributedBatchSampler, SubsetRandomSampler,
)
from .dataloader import DataLoader, default_collate_fn, get_worker_info  # noqa: F401
from .device_loader import DeviceLoader  # noqa: F401
from ..core.unported import not_ported as _not_ported


class InMemoryDataset:
    """paddle_tpu/io/dataset_native.py InMemoryDataset: not ported."""

    def __init__(self):
        _not_ported("paddle.io.InMemoryDataset (the native datafeed)",
                    "slice 10, ROADMAP Queue 1 item 8: "
                    "io/dataset_native.py and native/")


class QueueDataset:
    """paddle_tpu/io/dataset_native.py QueueDataset: not ported."""

    def __init__(self, queue_capacity: int = 4096):
        _not_ported("paddle.io.QueueDataset (the native datafeed)",
                    "slice 10, ROADMAP Queue 1 item 8: "
                    "io/dataset_native.py and native/")
