"""Port of paddle_tpu/vision/datasets/flowers.py (numpy only, as there). Flowers-102 (reference: python/paddle/vision/datasets/flowers.py —
image tgz + .mat labels; synthetic fallback, zero egress)."""
from __future__ import annotations

import os

import numpy as np

from ...io import Dataset


class Flowers(Dataset):
    NUM_CLASSES = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        if data_file:
            raise NotImplementedError(
                "Flowers: real-archive loading is not implemented in this "
                "build (zero-egress, synthetic fallback); pass "
                "data_file=None or use vision.datasets.ImageFolder on "
                "an extracted directory.")
        self.transform = transform
        n = 512 if mode == "train" else 128
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.labels = rng.randint(0, self.NUM_CLASSES, n).astype(np.int64)
        # class-dependent mean color => learnable synthetic task
        self.images = (rng.rand(n, 3, 64, 64).astype(np.float32) * 0.3
                       + (self.labels[:, None, None, None] %
                          16).astype(np.float32) / 16.0)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)
