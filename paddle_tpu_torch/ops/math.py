"""Elementwise math and reductions (port of the parts of paddle_tpu/ops/
math.py that the eager surface, the twins of the autograd and dtype
tests and the examples reach), under the JAX package's op types.

Promotion is torch's, which gives the rules the JAX package pins
(core/dtypes.py): Python scalars are weak, numpy scalars do not widen a
tensor, and int/bool division gives the default float dtype. "reduce_sum",
"reduce_mean", "exp", "log" and "square" are on the AMP black list, so
under auto_cast they run in float32, as in the reference."""
from __future__ import annotations

import torch

from ..core.dispatch import op
from ..core.dtypes import convert_dtype

__all__ = ["add", "subtract", "multiply", "divide", "pow", "maximum",
           "minimum", "abs", "neg", "exp", "log", "sqrt", "tanh", "square",
           "sum", "mean", "max", "min", "clip", "cast"]


def _binop(name, fn):
    wrapped = op(name)(fn)

    def api(x, y, name=None):
        return wrapped(x, y)
    api.__name__ = name
    return api


def _unop(name, fn):
    wrapped = op(name)(fn)

    def api(x, name=None):
        return wrapped(x)
    api.__name__ = name
    return api


add = _binop("elementwise_add", lambda x, y: torch.add(x, y))
subtract = _binop("elementwise_sub", lambda x, y: torch.sub(x, y))
multiply = _binop("elementwise_mul", lambda x, y: torch.mul(x, y))
divide = _binop("elementwise_div", lambda x, y: torch.true_divide(x, y))
pow = _binop("elementwise_pow", lambda x, y: torch.pow(x, y))  # noqa: A001
maximum = _binop("elementwise_max", lambda x, y: torch.maximum(x, y))
minimum = _binop("elementwise_min", lambda x, y: torch.minimum(x, y))

abs = _unop("abs", torch.abs)  # noqa: A001
neg = _unop("neg", torch.neg)
exp = _unop("exp", torch.exp)
log = _unop("log", torch.log)
sqrt = _unop("sqrt", torch.sqrt)
tanh = _unop("tanh", torch.tanh)
square = _unop("square", torch.square)


def _dims(axis):
    if axis is None:
        return None
    if torch.is_tensor(axis):
        axis = axis.tolist()
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


@op("reduce_sum")
def _sum(x, axis, keepdim):
    return torch.sum(x) if axis is None else torch.sum(x, axis, keepdim)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    """dtype casts the input first (Paddle's rule)."""
    if dtype is not None:
        x = cast(x, dtype)
    return _sum(x, _dims(axis), keepdim)


@op("reduce_mean")
def _mean(x, axis, keepdim):
    return torch.mean(x) if axis is None else torch.mean(x, axis, keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    return _mean(x, _dims(axis), keepdim)


@op("reduce_max")
def _max(x, axis, keepdim):
    return torch.amax(x, () if axis is None else axis, keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _max(x, _dims(axis), keepdim)


@op("reduce_min")
def _min(x, axis, keepdim):
    return torch.amin(x, () if axis is None else axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _min(x, _dims(axis), keepdim)


@op("clip")
def _clip(x, mn, mx):
    return torch.clamp(x, mn, mx)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    mn = min.item() if torch.is_tensor(min) else min
    mx = max.item() if torch.is_tensor(max) else max
    return _clip(x, mn, mx)


@op("cast")
def _cast(x, dtype):
    return x.to(dtype)


def cast(x, dtype):
    return _cast(x, convert_dtype(dtype))

