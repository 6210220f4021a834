"""paddle.vision.image (port of paddle_tpu/vision/image.py, after the
reference's python/paddle/vision/image.py: set_image_backend:23,
get_image_backend:90, image_load:110).

The same backends as the JAX module: 'pil' when Pillow imports, 'cv2'
on request, else a numpy loader for raw .npy and uncompressed PPM/PGM
files. Host-only: nothing here touches torch.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_BACKEND = None


def set_image_backend(backend):
    global _BACKEND
    if backend not in ("pil", "cv2", "numpy"):
        raise ValueError(
            f"Expected backend 'pil', 'cv2' or 'numpy', got {backend!r}")
    _BACKEND = backend


def get_image_backend():
    if _BACKEND is not None:
        return _BACKEND
    try:
        import PIL  # noqa: F401
        return "pil"
    except ImportError:
        return "numpy"


def _load_numpy(path):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext in (".ppm", ".pgm"):
        with open(path, "rb") as f:
            magic = f.readline().strip()
            line = f.readline()
            while line.startswith(b"#"):
                line = f.readline()
            w, h = map(int, line.split())
            maxv = int(f.readline())
            depth = 3 if magic == b"P6" else 1
            dt = np.uint8 if maxv < 256 else ">u2"
            data = np.frombuffer(f.read(), dt)
            return data.reshape(h, w, depth) if depth == 3 \
                else data.reshape(h, w)
    raise ValueError(
        f"numpy image backend cannot decode {ext!r}; install Pillow or "
        "OpenCV and set_image_backend accordingly")


def image_load(path, backend=None):
    """Load an image as the backend's native type (PIL.Image / cv2
    ndarray / numpy ndarray)."""
    backend = backend or get_image_backend()
    if backend == "pil":
        from PIL import Image
        return Image.open(path)
    if backend == "cv2":
        import cv2
        return cv2.imread(path)
    return _load_numpy(path)
