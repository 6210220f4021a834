"""Device resolution for the port.

The JAX package resolves a Place to whatever backend the process has
(paddle_tpu/core/place.py). The port is stricter: its entry points run
on CUDA by default, run on the CPU only when the caller asks for it
(device="cpu", as the tests do), and raise when asked for CUDA on a
machine without a GPU. Nothing drops quietly to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> "cuda" (the default), "cpu" -> the CPU, "cuda"/"cuda:N"
    -> that GPU. Raises ValueError for any other device type and
    RuntimeError for CUDA when no GPU is visible."""
    try:
        dev = torch.device("cuda" if device is None else device)
    except RuntimeError as e:
        raise ValueError(f"device {device!r}: {e}") from None
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"device {device!r}: the port runs on 'cuda' (default) or "
            f"'cpu' (explicit)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise ValueError(
            f"device {device!r}: only {torch.cuda.device_count()} CUDA "
            f"device(s) visible")
    return dev
