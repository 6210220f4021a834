"""Loading the JAX package's state into a port module (the port's side of
paddle_tpu/nn/layer/layers.py `Layer.set_state_dict`).

The port keeps the JAX package's parameter and buffer names and layouts,
so a state moves between the packages as {name: numpy array}, with no
renaming and no transposes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_state"]


@torch.no_grad()
def load_jax_state(module: nn.Module, state: Dict[str, np.ndarray]):
    """Copy `state`, the numpy form of a JAX model's parameters (and BN
    buffers), into `module`'s parameters and buffers, each keeping its
    own dtype and device. Names and shapes must match exactly. Returns
    the module."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"state names differ: missing {missing}, "
                         f"unexpected {extra}")
    for name, t in own.items():
        src = np.asarray(state[name])
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {src.shape} != {tuple(t.shape)}")
        # through f32 (f64 kept): torch has no counterpart of the JAX
        # package's numpy bf16; copy_ casts to the tensor's own dtype
        wide = np.float64 if src.dtype == np.float64 else np.float32
        t.copy_(torch.from_numpy(np.array(src, dtype=wide)))
    return module
