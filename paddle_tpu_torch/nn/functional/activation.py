"""Activations (port of paddle_tpu/nn/functional/activation.py), each
registered under the JAX package's op type ("softmax" and "log_softmax"
are on the AMP black list), so auto_cast casts them as the reference
does.

Every formula is the JAX package's, written with torch.where where the
JAX one is a jnp.where, so the values and the gradients agree (a tie at
a branch point, such as leaky_relu at exactly 0, takes the reference's
side). `rrelu` in training and `gumbel_softmax` draw from the port's
generator of the input's device (core/random.py): the JAX stream cannot
be matched, so tests compare their distributions, and rrelu's eval form
exactly. The in-place forms (relu_, elu_, softmax_, tanh_) write into
their argument through torch's in-place operations, so torch's version
counter and leaf check stand in for the reference's in-place contract.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...core import random as _random
from ...core.dispatch import op
from ...core.dtypes import convert_dtype

__all__ = ["relu", "relu6", "sigmoid", "silu", "swish", "tanh", "tanhshrink",
           "mish", "log_sigmoid", "hardsigmoid", "hardswish", "gelu",
           "leaky_relu", "elu", "celu", "selu", "hardtanh", "hardshrink",
           "softshrink", "softplus", "softsign", "prelu", "rrelu",
           "thresholded_relu", "softmax", "log_softmax", "gumbel_softmax",
           "maxout", "glu", "relu_", "elu_", "softmax_", "tanh_"]


def _unop(name, fn):
    wrapped = op(name)(fn)

    def api(x, name=None):
        return wrapped(x)
    api.__name__ = api.__qualname__ = name
    return api


def _softplus0(x):
    """log(1 + e^x), jax.nn.softplus's form."""
    return torch.logaddexp(x, torch.zeros_like(x))


relu = _unop("relu", torch.relu)
relu6 = _unop("relu6", lambda x: torch.clamp(x, 0, 6))
sigmoid = _unop("sigmoid", torch.sigmoid)
silu = _unop("silu", lambda x: x * torch.sigmoid(x))
swish = silu
tanh = _unop("tanh", torch.tanh)
tanhshrink = _unop("tanh_shrink", lambda x: x - torch.tanh(x))
mish = _unop("mish", lambda x: x * torch.tanh(_softplus0(x)))
log_sigmoid = _unop("logsigmoid", lambda x: -_softplus0(-x))
hardsigmoid = _unop("hard_sigmoid",
                    lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))
hardswish = _unop("hard_swish",
                  lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)
relu.__doc__ = "max(x, 0)."
tanh.__doc__ = "Elementwise tanh."


@op("gelu")
def _gelu(x, approximate):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return _gelu(x, bool(approximate))


@op("leaky_relu")
def _leaky_relu(x, negative_slope):
    return torch.where(x >= 0, x, negative_slope * x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _leaky_relu(x, negative_slope)


@op("elu")
def _elu(x, alpha):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def elu(x, alpha=1.0, name=None):
    return _elu(x, alpha)


@op("celu")
def _celu(x, alpha):
    zero = torch.zeros_like(x)
    return torch.maximum(x, zero) + torch.minimum(
        zero, alpha * torch.expm1(x / alpha))


def celu(x, alpha=1.0, name=None):
    return _celu(x, alpha)


@op("selu")
def _selu(x, scale, alpha):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _selu(x, scale, alpha)


@op("hard_tanh")
def _hardtanh(x, lo, hi):
    return torch.clamp(x, lo, hi)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _hardtanh(x, min, max)


@op("hard_shrink")
def _hardshrink(x, threshold):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def hardshrink(x, threshold=0.5, name=None):
    return _hardshrink(x, threshold)


@op("softshrink")
def _softshrink(x, threshold):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softshrink(x, threshold=0.5, name=None):
    return _softshrink(x, threshold)


@op("softplus")
def _softplus(x, beta, threshold):
    scaled = beta * x
    return torch.where(scaled > threshold, x, _softplus0(scaled) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _softplus(x, beta, threshold)


@op("softsign")
def _softsign(x):
    return x / (1 + x.abs())


def softsign(x, name=None):
    return _softsign(x)


@op("prelu")
def _prelu(x, weight, data_format):
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    shape = [1] * x.ndim
    shape[1 if data_format == "NCHW" else x.ndim - 1] = weight.shape[0]
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """Per-channel (or one shared) negative slope `weight`."""
    return _prelu(x, weight, data_format)


@op("rrelu")
def _rrelu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Negative slope drawn once per call from U(lower, upper) in
    training (the reference draws one scalar), (lower + upper) / 2 in
    eval."""
    if training:
        slope = torch.empty((), dtype=torch.float64).uniform_(
            lower, upper, generator=_random.generator("cpu")).item()
        return _rrelu(x, slope)
    return _rrelu(x, (lower + upper) / 2.0)


@op("thresholded_relu")
def _thresholded_relu(x, threshold):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def thresholded_relu(x, threshold=1.0, name=None):
    return _thresholded_relu(x, threshold)


@op("softmax")
def _softmax(x, axis):
    return torch.softmax(x, dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    """softmax over `axis`; dtype casts the input first."""
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return _softmax(x, axis)


@op("log_softmax")
def _log_softmax(x, axis):
    return torch.log_softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return _log_softmax(x, axis)


@op("gumbel_softmax")
def _gumbel_softmax(x, gumbel, temperature, hard, axis):
    y = torch.softmax((x + gumbel) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        one_hot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        # straight-through estimator
        return one_hot + y - y.detach()
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g ~ Gumbel(0, 1) drawn from
    the port's generator; hard gives the one-hot of the argmax with the
    soft sample's gradient."""
    dtype = x.dtype if x.is_floating_point() else torch.float32
    # -log(E) with E ~ Exp(1) is a standard Gumbel draw
    e = torch.empty(tuple(x.shape), dtype=dtype, device=x.device)
    gumbel = -e.exponential_(generator=_random.generator(x.device)).log()
    return _gumbel_softmax(x, gumbel, temperature, hard, axis)


@op("maxout")
def _maxout(x, groups, axis):
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(dim=axis + 1)


def maxout(x, groups, axis=1, name=None):
    return _maxout(x, groups, axis)


@op("glu")
def _glu(x, axis):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def glu(x, axis=-1, name=None):
    return _glu(x, axis)


def relu_(x, name=None):
    """In-place relu."""
    return torch.relu_(x)


def elu_(x, alpha=1.0, name=None):
    """In-place elu."""
    return F.elu_(x, alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    """In-place softmax (into x's own dtype)."""
    return x.copy_(softmax(x, axis, dtype))


def tanh_(x, name=None):
    """In-place tanh."""
    return torch.tanh_(x)
