"""Creation ops (port of paddle_tpu/ops/creation.py), every public name in
the reference's order and under the JAX package's op types.

A creator with no input returns a Tensor (stop_gradient True) on the
default device (core/place.py); a `*_like` creator, `diag`, `tril` and
the rest return on their input's device. Random draws take their
device's generator from core/random.py, never torch's global one; a
nonzero `seed` (uniform, gaussian) draws from a generator of its own
seeded with it, as the JAX package's PRNGKey(seed) does. Python floats
take the default float dtype; arange of ints and randint give int64, as
in the reference. `empty` is zeros, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core import random as _random
from ..core.dispatch import op
from ..core.dtypes import convert_dtype, get_default_dtype
from ..core.place import resolve_device
from ..core.tensor import Tensor, plain, wrap
from .random_ops import _gen


def _shape(shape):
    if torch.is_tensor(shape):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s.item()) if torch.is_tensor(s) else int(s)
                 for s in shape)


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    return d if d is not None else (default or get_default_dtype())


def _new(t: torch.Tensor) -> Tensor:
    return torch.Tensor._make_subclass(Tensor, t, False)


def _dev():
    return resolve_device(None)


@op("assign")
def _assign(x):
    return x.clone()


def assign(x, output=None):
    """A copy of x (on the graph); written into `output` when given."""
    out = _assign(wrap(x))
    if output is not None:
        output.set_value(out.detach())
        return output
    return out


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    if torch.is_tensor(fill_value):
        fill_value = fill_value.item()
    if dtype is None:
        dtype = torch.bool if isinstance(fill_value, bool) \
            else get_default_dtype()
    return _new(torch.full(_shape(shape), fill_value,
                           dtype=convert_dtype(dtype), device=_dev()))


fill_constant = full


@op("zeros_like")
def _zeros_like(x, dtype):
    return torch.zeros_like(x, dtype=dtype)


def zeros_like(x, dtype=None, name=None):
    return _zeros_like(wrap(x), convert_dtype(dtype))


@op("ones_like")
def _ones_like(x, dtype):
    return torch.ones_like(x, dtype=dtype)


def ones_like(x, dtype=None, name=None):
    return _ones_like(wrap(x), convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    x = wrap(x)
    return _new(torch.full_like(plain(x).detach(), fill_value,
                                dtype=convert_dtype(dtype) or x.dtype))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


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


def _scalar(v):
    return v.item() if torch.is_tensor(v) else v


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), dtype=_dt(dtype),
                               device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), base=base,
                               dtype=_dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _new(torch.eye(num_rows, num_rows if num_columns is None
                          else num_columns, dtype=_dt(dtype), device=_dev()))


@op("diag")
def _diag(x, offset, padding_value):
    d = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        d = torch.where(mask, d, torch.tensor(padding_value, dtype=d.dtype,
                                              device=d.device))
    return d


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D x on the offset diagonal of a square matrix (the rest
    padding_value), or the offset diagonal of a 2-D x."""
    return _diag(wrap(x), offset, padding_value)


@op("diagflat")
def _diagflat(x, offset):
    return torch.diagflat(x, offset)


def diagflat(x, offset=0, name=None):
    return _diagflat(wrap(x), offset)


@op("tril")
def _tril(x, diagonal):
    return torch.tril(x, diagonal)


def tril(x, diagonal=0, name=None):
    return _tril(wrap(x), diagonal)


@op("triu")
def _triu(x, diagonal):
    return torch.triu(x, diagonal)


def triu(x, diagonal=0, name=None):
    return _triu(wrap(x), diagonal)


def clone(x, name=None):
    return assign(x)


# ------------------------------------------------------------------ random
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    """U[min, max) on the default device."""
    dev = _dev()
    return _new(torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
                .uniform_(min, max, generator=_gen(dev, seed)))


uniform_random = uniform


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """N(mean, std); Tensor mean or std broadcast to the draw's shape."""
    if torch.is_tensor(mean) or torch.is_tensor(std):
        like = mean if torch.is_tensor(mean) else std
        m, s = plain(wrap(mean, like)), plain(wrap(std, like))
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, generator=_random.generator(like.device),
                        dtype=get_default_dtype(), device=like.device)
        return _new((m + s * z).detach())
    dev = _dev()
    z = torch.randn(_shape(shape or [1]), generator=_random.generator(dev),
                    dtype=get_default_dtype(), device=dev)
    return _new(mean + std * z)


def gaussian(shape, mean=0.0, std=1.0, dtype=None, seed=0, name=None):
    dev = _dev()
    z = torch.randn(_shape(shape), generator=_gen(dev, seed),
                    dtype=_dt(dtype), device=dev)
    return _new(mean + std * z)


def standard_normal(shape, dtype=None, name=None):
    return gaussian(shape, 0.0, 1.0, dtype)


def _random_shape(shape):
    if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
        shape = shape[0]
    return _shape(shape)


def randn(*shape, dtype=None, name=None):
    """N(0, 1) from the default device's generator."""
    dev = _dev()
    return _new(torch.randn(_random_shape(shape), generator=_random.generator(
        dev), dtype=_dt(dtype), device=dev))


def rand(*shape, dtype=None, name=None):
    """U[0, 1) from the default device's generator."""
    dev = _dev()
    return _new(torch.rand(_random_shape(shape), generator=_random.generator(
        dev), dtype=_dt(dtype), device=dev))


def _randint(low, high, shape, dtype, device):
    if high is None:
        low, high = 0, low
    return _new(torch.randint(low, high, _shape(shape),
                              generator=_random.generator(device),
                              dtype=convert_dtype(dtype) or torch.int64,
                              device=device))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    """Integers in [low, high) from the default device's generator."""
    return _randint(low, high, shape, dtype, _dev())


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = wrap(x)
    return _randint(low, high, x.shape, dtype or x.dtype, x.device)


def randperm(n, dtype=None, name=None):
    dev = _dev()
    return _new(torch.randperm(int(n), generator=_random.generator(dev),
                               dtype=convert_dtype(dtype) or torch.int64,
                               device=dev))


def rand_like(x, dtype=None, name=None):
    x = wrap(x)
    return _new(torch.empty(x.shape, dtype=_dt(dtype, x.dtype),
                            device=x.device).uniform_(
        0.0, 1.0, generator=_random.generator(x.device)))


def randn_like(x, dtype=None, name=None):
    x = wrap(x)
    return _new(torch.randn(x.shape, generator=_random.generator(x.device),
                            dtype=_dt(dtype, x.dtype), device=x.device))


# canonical random/meta implementations live in random_ops/array_ops
from .random_ops import bernoulli, multinomial, poisson  # noqa: E402,F401
from .array_ops import meshgrid  # noqa: E402,F401


# ------------------------------------------------------------------ legacy
# *_batch_size_like creators: `shape` with dim output_dim_idx replaced by
# input's dim input_dim_idx

def _batch_size_like_shape(input, shape, input_dim_idx, output_dim_idx):
    shape = list(shape)
    shape[output_dim_idx] = int(input.shape[input_dim_idx])
    return shape


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  name=None):
    return full(_batch_size_like_shape(input, shape, input_dim_idx,
                                       output_dim_idx), value, dtype)


def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,
                                    input_dim_idx=0, output_dim_idx=0,
                                    dtype="float32", name=None):
    return normal(mean, std, _batch_size_like_shape(
        input, shape, input_dim_idx, output_dim_idx)).astype(dtype)


def uniform_random_batch_size_like(input, shape, min=-1.0, max=1.0,  # noqa: A002
                                   input_dim_idx=0, output_dim_idx=0,
                                   dtype="float32", name=None):
    return uniform(_batch_size_like_shape(input, shape, input_dim_idx,
                                          output_dim_idx), dtype, min, max)


@op("diag_embed")
def _diag_embed(x, offset, dim1, dim2):
    return torch.diag_embed(x, offset, dim1, dim2)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """Batched diagonal matrices from the last axis: out[..., i, i +
    offset] = input[..., i], the two new axes at dim1 and dim2."""
    return _diag_embed(wrap(input), int(offset), int(dim1), int(dim2))


__all__ = ["assign", "zeros", "ones", "full", "fill_constant", "zeros_like",
           "ones_like", "full_like", "empty", "empty_like", "arange",
           "linspace", "logspace", "eye", "diag", "diagflat", "tril", "triu",
           "clone", "uniform", "uniform_random", "normal", "gaussian",
           "standard_normal", "randn", "rand", "randint", "randint_like",
           "randperm", "rand_like", "randn_like",
           "fill_constant_batch_size_like",
           "gaussian_random_batch_size_like",
           "uniform_random_batch_size_like", "diag_embed"]
