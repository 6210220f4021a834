"""layer_norm (port of paddle_tpu/nn/functional/norm.py `layer_norm`).

Statistics and the scale/shift math run in f32 and the result comes back
in x's dtype, the JAX package's numerics for low-precision activations
(`_apply_scale_shift`, norm.py:51-60): torch's layer_norm does exactly
that for bf16 inputs on CUDA and computes in x's own f32 on the CPU."""
from __future__ import annotations

from torch.nn import functional as F

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)
