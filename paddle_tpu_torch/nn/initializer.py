"""Parameter initializers (port of the part of paddle_tpu/nn/initializer.py
that the layers' defaults use): Constant, Uniform, Normal, XavierNormal
and KaimingUniform, with the reference's fan rules.

An initializer is called as init(shape, dtype) and returns a new CPU
tensor drawn from the port's CPU generator (core/random.py, seeded by
paddle.seed); Layer.create_parameter moves it to the parameter's
device. The defaults: XavierNormal for weights, Constant(0) for biases
(Layer.create_parameter), Normal(0, 1) for Embedding, Constant(1) for
the norm layers' weights and KaimingUniform(fan_in) for convolutions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import random as _random
from ..core.dtypes import convert_dtype, get_default_dtype

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "XavierNormal",
           "KaimingUniform"]


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


def _empty(shape, dtype):
    return torch.empty(tuple(shape),
                       dtype=convert_dtype(dtype) or get_default_dtype())


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
        return _empty(shape, dtype).uniform_(
            self.low, self.high, generator=_random.generator("cpu"))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None):
        return _empty(shape, dtype).normal_(
            self.mean, self.std, generator=_random.generator("cpu"))


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
