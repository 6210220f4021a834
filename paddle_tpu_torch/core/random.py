"""Random state (port of paddle_tpu/core/random.py).

The JAX package folds a counter into a root key made from the seed. The
port keeps one explicit torch.Generator per device, made on first use
and seeded from the process seed (0 until `seed` is called);
`paddle.seed(s)` reseeds every one of them. The port's random draws
(initializers, dropout, the creation ops' rand/randn/randint) take their
device's generator and nothing draws from torch's global generator, so
a seed fixes the port's draws whatever else in the process uses torch's
global stream. The streams differ from the JAX package's: tests compare
distributions, never values.

Initializers draw on the CPU generator and the parameter then moves to
its device, so one seed gives the same weights on the CPU and the GPU.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "generator"]

_seed = 0
_generators: Dict[str, torch.Generator] = {}


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device="cpu") -> torch.Generator:
    """The port's generator for `device` (made and seeded on first
    use)."""
    dev = _key(device)
    g = _generators.get(str(dev))
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(_seed)
        _generators[str(dev)] = g
    return g


def seed(s: int):
    """Reseed every device's generator with `s`; returns the CPU's."""
    global _seed
    _seed = int(s)
    for g in _generators.values():
        g.manual_seed(_seed)
    return generator("cpu")


def get_rng_state(*, device="cpu") -> torch.Tensor:
    """A snapshot of `device`'s generator state (does not advance it)."""
    return generator(device).get_state()


def set_rng_state(state, *, device="cpu") -> None:
    generator(device).set_state(state)
