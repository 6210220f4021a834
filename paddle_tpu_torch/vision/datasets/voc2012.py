"""Port of paddle_tpu/vision/datasets/voc2012.py (numpy only, as there). VOC2012 segmentation (reference: python/paddle/vision/datasets/
voc2012.py — (image, seg-mask) pairs; synthetic fallback, zero egress)."""
from __future__ import annotations

import numpy as np

from ...io import Dataset


class VOC2012(Dataset):
    NUM_CLASSES = 21

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if data_file:
            raise NotImplementedError(
                "VOC2012: real-archive loading is not implemented in this "
                "build (zero-egress, synthetic fallback); pass "
                "data_file=None or use vision.datasets.ImageFolder on "
                "an extracted directory.")
        self.transform = transform
        n = 128 if mode == "train" else 32
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.images = rng.rand(n, 3, 64, 64).astype(np.float32)
        # blocky masks: each quadrant one class (structured, learnable)
        self.masks = np.zeros((n, 64, 64), np.int64)
        for i in range(n):
            for qy in range(2):
                for qx in range(2):
                    self.masks[i, qy * 32:(qy + 1) * 32,
                               qx * 32:(qx + 1) * 32] = rng.randint(
                                   0, self.NUM_CLASSES)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)
