"""Comparison, logical and bitwise ops (port of paddle_tpu/ops/logic.py),
every public name in the reference's order and under the JAX package's
op types. `equal_all`, `allclose`, `isclose` and `is_empty` return bool
tensors on their input's device (no host read); `is_tensor` is true of
torch tensors, the port's Tensor among them."""
from __future__ import annotations

import torch

from ..core.dispatch import eager, op
from ..core.tensor import wrap


def _cmp(name, fn):
    wrapped = op(name, differentiable=False)(fn)

    def api(x, y, name=None):
        x = wrap(x, y)
        return wrapped(x, wrap(y, x))
    api.__name__ = name
    return api


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


@op("logical_not", differentiable=False)
def _logical_not(x):
    return torch.logical_not(x)


@op("bitwise_not", differentiable=False)
def _bitwise_not(x):
    return torch.bitwise_not(x)


def logical_not(x, name=None):
    return _logical_not(wrap(x))


def bitwise_not(x, name=None):
    return _bitwise_not(wrap(x))


@eager
def _equal_all(x, y):
    if tuple(x.shape) != tuple(y.shape):
        return torch.tensor(False, device=x.device)
    return torch.eq(x, y).all()


def equal_all(x, y, name=None):
    """A bool tensor: same shape and every entry equal."""
    x = wrap(x, y)
    return _equal_all(x, wrap(y, x))


@eager
def _isclose(x, y, rtol, atol, equal_nan):
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return torch.isclose(x, y, rtol, atol, equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = wrap(x, y)
    return _isclose(x, wrap(y, x), rtol, atol, equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = wrap(x, y)
    return _isclose(x, wrap(y, x), rtol, atol, equal_nan)


@eager
def _is_empty(x):
    return torch.tensor(torch.numel(x) == 0, device=x.device)


def is_empty(x, name=None):
    return _is_empty(wrap(x))


def is_tensor(x):
    return torch.is_tensor(x)


__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
           "logical_not", "bitwise_not", "equal_all", "allclose", "isclose",
           "is_empty", "is_tensor"]
