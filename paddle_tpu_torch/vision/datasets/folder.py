"""Port of paddle_tpu/vision/datasets/folder.py (numpy only, as there). DatasetFolder/ImageFolder (reference:
python/paddle/vision/datasets/folder.py)."""
from __future__ import annotations

import os

import numpy as np

from ...io import Dataset

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        raise RuntimeError("PIL not available; use .npy images")


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for fname in sorted(os.listdir(d)):
                path = os.path.join(d, fname)
                ok = is_valid_file(path) if is_valid_file else \
                    fname.lower().endswith(extensions)
                if ok:
                    self.samples.append((path, self.class_to_idx[c]))
        self.transform = transform

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, np.asarray(target, np.int64)

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        extensions = extensions or IMG_EXTENSIONS
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                ok = is_valid_file(path) if is_valid_file else \
                    fname.lower().endswith(extensions)
                if ok:
                    self.samples.append(path)
        self.transform = transform

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)
