"""Port of paddle_tpu/vision/datasets/cifar.py (numpy only, as there). Cifar10/100 (reference: python/paddle/vision/datasets/cifar.py — tar of
pickled batches; synthetic fallback, zero egress)."""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ...io import Dataset
from .mnist import _synthetic_digits


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            self.data = self._load_tar(data_file, mode)
        else:
            n = 1024 if mode == "train" else 256
            imgs, ys = _synthetic_digits(n, seed=7, image_size=32,
                                         num_classes=self.NUM_CLASSES)
            rgb = np.repeat(imgs[:, None], 3, axis=1)  # [N,3,32,32]
            self.data = list(zip(rgb, ys))

    def _load_tar(self, data_file, mode):
        want = "data_batch" if mode == "train" else "test_batch"
        out = []
        with tarfile.open(data_file, "r") as tf:
            for member in tf.getmembers():
                if want in member.name:
                    batch = pickle.load(tf.extractfile(member),
                                        encoding="bytes")
                    data = batch[b"data"].reshape(-1, 3, 32, 32)
                    labels = batch.get(b"labels", batch.get(b"fine_labels"))
                    # ptlint: disable=PT-T007  host-only pickle bytes;
                    # nothing here ever touched a device
                    out.extend(zip(data, np.asarray(labels, np.int64)))
        return out

    def __getitem__(self, idx):
        img, label = self.data[idx]
        img = np.asarray(img, np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
