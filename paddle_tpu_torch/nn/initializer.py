"""Parameter initializers (port of paddle_tpu/nn/initializer.py):
Constant, Uniform, Normal, TruncatedNormal, XavierUniform,
XavierNormal, KaimingUniform, KaimingNormal, Assign, Bilinear, Dirac,
Orthogonal and the fluid aliases, with the reference's fan rules.

An initializer is called as init(shape, dtype) and returns a new CPU
tensor; the random ones draw from the port's CPU generator
(core/random.py, seeded by paddle.seed), and Layer.create_parameter
moves the value to the parameter's device. The JAX package's stream
cannot be matched, so the random ones agree with it in distribution
(TruncatedNormal cuts at two standard deviations, as
jax.random.truncated_normal(-2, 2) does); the deterministic ones
(Constant, Assign, Bilinear, Dirac) agree value for value. The
defaults: XavierNormal for weights, Constant(0) for biases
(Layer.create_parameter), Normal(0, 1) for Embedding, Constant(1) for
the norm layers' weights and KaimingUniform(fan_in) for convolutions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import random as _random
from ..core.dtypes import convert_dtype, get_default_dtype

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform",
           "KaimingNormal", "Assign", "Bilinear", "Dirac", "Orthogonal",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "TruncatedNormalInitializer", "XavierInitializer",
           "MSRAInitializer", "NumpyArrayInitializer"]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _dtype(dtype):
    return convert_dtype(dtype) or get_default_dtype()


def _empty(shape, dtype):
    return torch.empty(tuple(shape), dtype=_dtype(dtype))


def _cpu():
    return _random.generator("cpu")


class Initializer:
    def __call__(self, shape, dtype=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None):
        return _empty(shape, dtype).fill_(self.value)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None):
        return _empty(shape, dtype).uniform_(self.low, self.high,
                                             generator=_cpu())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None):
        return _empty(shape, dtype).normal_(self.mean, self.std,
                                            generator=_cpu())


class TruncatedNormal(Initializer):
    """mean + std * N(0, 1) cut to [-2, 2]."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None):
        # the inverse CDF of a uniform draw over [Phi(-2), Phi(2)]
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        u = torch.empty(tuple(shape), dtype=torch.float64).uniform_(
            lo, 1.0 - lo, generator=_cpu())
        r = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
        return (self.mean + self.std * r).to(_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype=None):
        fi, fo = _fan_in_out(shape)
        limit = math.sqrt(6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return Uniform(-limit, limit)(shape, dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype=None):
        fi, fo = _fan_in_out(shape)
        std = math.sqrt(2.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return Normal(0.0, std)(shape, dtype)


class KaimingUniform(Initializer):
    """U(-sqrt(6 / fan_in), sqrt(6 / fan_in)); negative_slope and
    nonlinearity are accepted and ignored, as in the reference."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in

    def __call__(self, shape, dtype=None):
        fi, _ = _fan_in_out(shape)
        limit = math.sqrt(6.0 / (self.fan_in or fi))
        return Uniform(-limit, limit)(shape, dtype)


class KaimingNormal(Initializer):
    """N(0, 2 / fan_in); negative_slope and nonlinearity are accepted and
    ignored, as in the reference."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in

    def __call__(self, shape, dtype=None):
        fi, _ = _fan_in_out(shape)
        return Normal(0.0, math.sqrt(2.0 / (self.fan_in or fi)))(shape,
                                                                 dtype)


class Assign(Initializer):
    """The given value (array, list or Tensor), reshaped to `shape`."""

    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype=None):
        v = self.value
        if torch.is_tensor(v):
            v = v.detach().cpu().numpy()
        arr = torch.as_tensor(np.array(v, copy=True)).to(_dtype(dtype))
        return arr.reshape(tuple(shape))


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a conv-transpose weight
    [out, in, kh, kw]."""

    def __call__(self, shape, dtype=None):
        shape = tuple(shape)
        weight = np.zeros(shape, dtype=np.float32)
        f = math.ceil(shape[3] / 2)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            w = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
            weight[i // (shape[3] * shape[2] * shape[1]),
                   (i // (shape[3] * shape[2])) % shape[1], y, x] = w
        return torch.from_numpy(weight).to(_dtype(dtype))


class Dirac(Initializer):
    """Identity convolution kernels: a 1 at the spatial centre of
    (g * out/groups + i, i)."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype=None):
        w = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                w[(g * (oc // self.groups) + i, i) + centers] = 1.0
        return torch.from_numpy(w).to(_dtype(dtype))


class Orthogonal(Initializer):
    """gain times the Q factor (signs fixed by R's diagonal) of a normal
    [max(rows, cols), min(rows, cols)] draw, rows = shape[0]."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype=None):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        mat = torch.empty(max(rows, cols), min(rows, cols),
                          dtype=torch.float64).normal_(generator=_cpu())
        q, r = torch.linalg.qr(mat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(
            _dtype(dtype))


# legacy fluid aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierNormal
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign
