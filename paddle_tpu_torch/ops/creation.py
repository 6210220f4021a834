"""Creation ops (port of the parts of paddle_tpu/ops/creation.py that the
eager surface and the examples reach): zeros, ones, full, arange, the
*_like ops, rand / randn / randint, and diag_embed (nn.functional's).

Each returns a Tensor (stop_gradient True) on the default device
(core/place.py). Random draws take that device's generator from
core/random.py, never torch's global one. Python floats take the
default float dtype; arange of ints and randint give int64, as in the
reference.
"""
from __future__ import annotations

import torch

from ..core import random as _random
from ..core.dispatch import op
from ..core.dtypes import convert_dtype, get_default_dtype
from ..core.place import resolve_device
from ..core.tensor import Tensor, plain

__all__ = ["zeros", "ones", "full", "arange", "zeros_like", "ones_like",
           "full_like", "rand", "randn", "randint", "diag_embed"]


def _shape(shape):
    if torch.is_tensor(shape):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s.item()) if torch.is_tensor(s) else int(s)
                 for s in shape)


def _new(t: torch.Tensor) -> Tensor:
    return torch.Tensor._make_subclass(Tensor, t, False)


def _dev():
    return resolve_device(None)


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape(shape), dtype=convert_dtype(dtype)
                            or get_default_dtype(), device=_dev()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape(shape), dtype=convert_dtype(dtype)
                           or get_default_dtype(), device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    if torch.is_tensor(fill_value):
        fill_value = fill_value.item()
    if dtype is None:
        dtype = torch.bool if isinstance(fill_value, bool) \
            else get_default_dtype()
    return _new(torch.full(_shape(shape), fill_value,
                           dtype=convert_dtype(dtype), device=_dev()))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    start, end, step = (v.item() if torch.is_tensor(v) else v
                        for v in (start, end, step))
    if dtype is None and any(isinstance(v, float)
                             for v in (start, end, step)):
        dtype = get_default_dtype()
    return _new(torch.arange(start, end, step,
                             dtype=convert_dtype(dtype) or torch.int64,
                             device=_dev()))


@op("zeros_like")
def _zeros_like(x, dtype):
    return torch.zeros_like(x, dtype=dtype)


def zeros_like(x, dtype=None, name=None):
    return _zeros_like(x, convert_dtype(dtype))


@op("ones_like")
def _ones_like(x, dtype):
    return torch.ones_like(x, dtype=dtype)


def ones_like(x, dtype=None, name=None):
    return _ones_like(x, convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return _new(torch.full_like(plain(x), fill_value,
                                dtype=convert_dtype(dtype) or x.dtype))


def _random_shape(shape):
    if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
        shape = shape[0]
    return _shape(shape)


def rand(*shape, dtype=None, name=None):
    """U[0, 1) from the default device's generator."""
    dev = _dev()
    return _new(torch.rand(_random_shape(shape), generator=_random.generator(
        dev), dtype=convert_dtype(dtype) or get_default_dtype(), device=dev))


def randn(*shape, dtype=None, name=None):
    """N(0, 1) from the default device's generator."""
    dev = _dev()
    return _new(torch.randn(_random_shape(shape), generator=_random.generator(
        dev), dtype=convert_dtype(dtype) or get_default_dtype(), device=dev))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    """Integers in [low, high) from the default device's generator."""
    if high is None:
        low, high = 0, low
    dev = _dev()
    return _new(torch.randint(low, high, _shape(shape),
                              generator=_random.generator(dev),
                              dtype=convert_dtype(dtype) or torch.int64,
                              device=dev))


@op("diag_embed")
def _diag_embed(x, offset, dim1, dim2):
    return torch.diag_embed(x, offset, dim1, dim2)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """Batched diagonal matrices from the last axis: out[..., i, i +
    offset] = input[..., i], the two new axes at dim1 and dim2."""
    return _diag_embed(input, int(offset), int(dim1), int(dim2))
