"""Devices and places (port of paddle_tpu/core/place.py).

The JAX package resolves a Place to whatever backend the process has.
The port is stricter: its entry points run on CUDA by default, run on
the CPU only when the caller asks for it (device="cpu", or
set_device("cpu") once for the process, as the tests do), and raise
when asked for CUDA on a machine without a GPU. Nothing drops quietly
to the CPU.

`set_device` sets the default that `resolve_device(None)` returns;
without it the default is "cuda". Tensors, the creation ops and the
parameters of every Layer are made there; `default_device` sets it for
the length of a block (a model's constructor builds its layers inside
one, on the device it was given). A Place names a device:
`CPUPlace()` and `CUDAPlace(i)`, each turning into a torch.device with
`get_device()`.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace", "set_device",
           "get_device", "device_count", "is_compiled_with_cuda",
           "place_of", "default_device"]


class Place:
    """A device a Tensor lives on."""

    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def get_device(self) -> torch.device:
        return torch.device(self.device_type, self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({'gpu' if self.device_type == 'cuda' else 'cpu'}:" \
               f"{self.device_id})"


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    def get_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "cuda"


DeviceLike = Optional[Union[str, torch.device, Place]]

# set_device's choice; None means the port's default, CUDA
_default: Optional[torch.device] = None
# the meta device while static capture is on (static/program.py): a
# layer built then holds no device memory
_capture_device: Optional[torch.device] = None


def _as_torch(device) -> torch.device:
    if isinstance(device, Place):
        return device.get_device()
    if isinstance(device, str):
        name, _, idx = device.partition(":")
        if name == "gpu":
            device = "cuda" + (f":{idx}" if idx else "")
    try:
        return torch.device(device)
    except RuntimeError as e:
        raise ValueError(f"device {device!r}: {e}") from None


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> set_device's choice, or "cuda" when none was made; "cpu"
    -> the CPU; "cuda"/"gpu"/"cuda:N"/"gpu:N" or a Place -> that device.
    Raises ValueError for any other device type and RuntimeError for
    CUDA when no GPU is visible."""
    if device is None and _capture_device is not None:
        return _capture_device
    if device is None and _default is not None:
        return _default
    dev = _as_torch("cuda" if device is None else device)
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


def set_device(device: str):
    """paddle.set_device: "cpu", "gpu", "gpu:N" (or "cuda", "cuda:N")
    becomes the default device of the port's entry points, tensors and
    parameters. Returns its Place."""
    global _default
    if not isinstance(device, str):
        raise ValueError(f"set_device takes a string, got {device!r}")
    _default = resolve_device(device)
    return place_of(_default)


@contextlib.contextmanager
def default_device(device: DeviceLike = None):
    """set_device(device) inside the block, resolved as resolve_device
    resolves it (None keeps the current default); the previous default
    comes back after it."""
    global _default
    prev, _default = _default, resolve_device(device)
    try:
        yield _default
    finally:
        _default = prev


def get_device() -> str:
    """"cpu" or "gpu:N" (the default device; "gpu:0" until set_device)."""
    dev = _default if _default is not None else torch.device("cuda", 0)
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def place_of(device: torch.device) -> Place:
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(device.index or 0)


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def device_count() -> int:
    return torch.cuda.device_count()
