"""Dataset types (port of paddle_tpu/io/dataset.py, itself after the
reference's python/paddle/fluid/dataloader/dataset.py).

Plain Python with the JAX module's index arithmetic: `random_split`
draws its permutation from numpy's global stream
(paddle_tpu/io/dataset.py:110-121), so the same numpy seed splits the
same way in both packages. TensorDataset indexes whatever it holds
(torch tensors, the port's Tensors or numpy arrays).
"""
from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np


class Dataset:
    """paddle_tpu/io/dataset.py:10."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__getitem__", self.__class__.__name__))

    def __len__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__len__", self.__class__.__name__))


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__iter__", self.__class__.__name__))

    def __getitem__(self, idx):
        raise RuntimeError(
            "'__getitem__' should not be called for IterableDataset")

    def __len__(self):
        raise RuntimeError(
            "'__len__' should not be called for IterableDataset")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {t.shape[0] for t in tensors}
        assert len(lens) == 1, "tensors must share the first dimension"
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        assert all(len(d) == n for d in self.datasets)

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, tuple):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        lengths = [int(total * f) for f in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    assert sum(lengths) == total, \
        "Sum of input lengths does not equal the length of the dataset"
    perm = np.random.permutation(total).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out
