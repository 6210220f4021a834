"""Random sampling ops (port of paddle_tpu/ops/random_ops.py), every
public name in the reference's order and under the JAX package's op
types.

Each draws from the port's generator of its input's device
(core/random.py), never from torch's global generator, so `paddle.seed`
fixes the draws on each device. The streams differ from JAX's
threefry: the tests compare distributions, never values.

torch has no gamma sampler that takes a generator, so `standard_gamma`
(and `dirichlet` over it) is Marsaglia and Tsang's method on the port's
generator: for alpha >= 1, 16 candidates per entry, the first accepted
one taken (each is accepted with probability above 0.95, so all 16 fail
with probability below 1e-20, and then the last is taken); alpha < 1
draws alpha + 1 and scales by U^(1/alpha). `truncated_normal` inverts
the normal CDF over [-2, 2] standard deviations, as the reference
truncates.
"""
from __future__ import annotations

import math

import torch

from ..core import random as _random
from ..core.dispatch import op
from ..core.dtypes import convert_dtype, get_default_dtype
from ..core.place import resolve_device
from ..core.tensor import box, wrap

__all__ = ["bernoulli", "multinomial", "poisson", "exponential_",
           "standard_gamma", "dirichlet", "sampling_id",
           "truncated_normal", "normal_like"]


def _gen(device, seed=0):
    """The port's generator for `device`, or a new one seeded with a
    nonzero seed (the JAX package's PRNGKey(seed))."""
    if not seed:
        return _random.generator(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


@op("bernoulli", differentiable=False)
def _bernoulli(x):
    return torch.bernoulli(x.detach(), generator=_gen(x.device))


def bernoulli(x, name=None):
    """Elementwise draws of 1 with probability x (x's dtype)."""
    return _bernoulli(wrap(x))


@op("multinomial", differentiable=False)
def _multinomial(x, num_samples, replacement):
    return torch.multinomial(x.detach(), num_samples, replacement,
                             generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """int64 category draws from the (unnormalised) probabilities on x's
    last axis."""
    return _multinomial(wrap(x), int(num_samples), bool(replacement))


@op("poisson", differentiable=False)
def _poisson(x):
    return torch.poisson(x.detach(), generator=_gen(x.device))


def poisson(x, name=None):
    """Elementwise Poisson draws of rate x."""
    return _poisson(wrap(x))


@op("exponential", differentiable=False)
def _exponential(x, lam):
    return x.exponential_(lam, generator=_gen(x.device))


def exponential_(x, lam=1.0, name=None):
    """Refill x in place with Exp(lam) draws; returns x."""
    _exponential(x, float(lam))
    return x


def _gamma(alpha, g):
    """Marsaglia-Tsang gamma(alpha, 1) draws (see the module docstring)."""
    a = alpha.to(torch.float64 if alpha.dtype == torch.float64
                 else torch.float32)
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    k = 16
    z = torch.randn((k, *a.shape), generator=g, dtype=a.dtype,
                    device=a.device)
    u = torch.rand((k, *a.shape), generator=g, dtype=a.dtype,
                   device=a.device)
    v = (1 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    ok[-1] = True
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
    out = d * torch.gather(v, 0, first)[0]
    ub = torch.rand(a.shape, generator=g, dtype=a.dtype, device=a.device)
    return torch.where(boost, out * ub ** (1.0 / a), out)


@op("standard_gamma", differentiable=False)
def _standard_gamma(x):
    return _gamma(x.detach(), _gen(x.device)).to(x.dtype)


def standard_gamma(x, name=None):
    """Elementwise Gamma(x, 1) draws."""
    return _standard_gamma(wrap(x))


@op("dirichlet", differentiable=False)
def _dirichlet(alpha):
    g = _gamma(alpha.detach(), _gen(alpha.device))
    return (g / g.sum(-1, keepdim=True)).to(alpha.dtype)


def dirichlet(alpha, name=None):
    """Dirichlet(alpha) draws over the last axis."""
    return _dirichlet(wrap(alpha))


@op("sampling_id", differentiable=False)
def _sampling_id(x, seed):
    return torch.multinomial(x.detach(), 1, True,
                             generator=_gen(x.device, seed))[..., 0]


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", name=None):  # noqa: A002
    """One int64 id per row of the probabilities x."""
    return _sampling_id(wrap(x), seed)


@op("truncated_gaussian_random", differentiable=False)
def _truncated_normal(shape, mean, std, dtype, device):
    lo = 0.5 * (1 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float64, device=device).uniform_(
        lo, 1 - lo, generator=_random.generator(device))
    z = math.sqrt(2.0) * torch.erfinv(2 * u - 1)
    return (mean + std * z.clamp(-2.0, 2.0)).to(dtype)


def truncated_normal(shape, mean=0.0, std=1.0, dtype=None, name=None):
    """N(mean, std) truncated at two standard deviations, on the default
    device."""
    return box(_truncated_normal(tuple(shape), float(mean), float(std),
                                 convert_dtype(dtype) or get_default_dtype(),
                                 resolve_device(None)))


def normal_like(x, mean=0.0, std=1.0, name=None):
    x = wrap(x)
    return box(mean + std * torch.randn(
        x.shape, generator=_random.generator(x.device), dtype=x.dtype,
        device=x.device))
