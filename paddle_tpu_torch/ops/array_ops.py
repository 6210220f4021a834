"""Array and meta ops (port of paddle_tpu/ops/array_ops.py): shape, size,
rank, the unique family, meshgrid, unbind, TensorArray, assign_value,
crop and broadcast_tensors, every public name in the reference's order
and under the JAX package's op types.

`unique` and `unique_consecutive` run on the tensor's device (the JAX
package copies to the host for numpy's): sorted values, with the index
of each value's first occurrence (a min over positions), the inverse
and the counts, flattened first when axis is None, as numpy does. Their
output lengths depend on the data, which torch learns from the device.

Not ported: `array_to_lod_tensor` and `lod_tensor_to_array`, which wait
for core/lod.py (ROADMAP Queue 1, the long tail).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import eager, op
from ..core.dtypes import convert_dtype
from ..core.place import resolve_device
from ..core.tensor import box, wrap

__all__ = ["shape", "size", "rank", "unique", "unique_consecutive",
           "meshgrid", "unbind", "assign_value", "crop",
           "create_array", "array_write", "array_read", "array_length",
           "TensorArray", "broadcast_tensors", "numel"]


@op("shape", differentiable=False)
def _shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)


def shape(input, name=None):
    """paddle.shape: the shape as a 1-D int64 tensor."""
    return _shape(wrap(input))


@op("size", differentiable=False)
def _size(x):
    return torch.tensor(torch.numel(x), dtype=torch.int64, device=x.device)


def size(x, name=None):
    return _size(wrap(x))


numel = size


@eager
def _rank(x):
    return torch.tensor(x.ndim, dtype=torch.int32, device=x.device)


def rank(input, name=None):
    return _rank(wrap(input))


# ---------------------------------------------------------------- unique
def _first_index(inverse, n_unique, positions):
    """The smallest position of each unique value (a min, so the same
    on every device and run)."""
    big = torch.full((n_unique,), positions.numel(), dtype=torch.int64,
                     device=inverse.device)
    return big.scatter_reduce(0, inverse, positions, "amin")


@op("unique", differentiable=False)
def _unique(x, return_index, return_inverse, return_counts, axis, dtype):
    shape = x.shape
    if axis is None:
        x = torch.reshape(x, (-1,))
    # dim=None, not 0, for the flattened x: torch's per-slice path for a
    # dim is ~25x slower on a 1-D tensor
    vals, inverse, counts = torch.unique(
        x, sorted=True, return_inverse=True, return_counts=True, dim=axis)
    outs = [vals]
    if return_index:
        n = x.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=x.device)
        outs.append(_first_index(inverse, counts.numel(), pos).to(dtype))
    if return_inverse:
        # numpy's inverse (the JAX package's) takes x's shape for axis None
        outs.append((inverse.reshape(shape) if axis is None else inverse)
                    .to(dtype))
    if return_counts:
        outs.append(counts.to(dtype))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (rows along axis), and on request the
    index of each one's first occurrence, the inverse and the counts."""
    return _unique(wrap(x), return_index, return_inverse, return_counts,
                   axis, convert_dtype(dtype))


@eager
def _unique_consecutive(x, return_inverse, return_counts, axis, dtype):
    if axis is None:
        x = torch.reshape(x, (-1,))
    vals, inverse, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=axis)
    outs = [vals]
    if return_inverse:
        outs.append(inverse.to(dtype))
    if return_counts:
        outs.append(counts.to(dtype))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Drop repeats that follow each other only (over the flattened x
    when axis is None)."""
    return _unique_consecutive(wrap(x), return_inverse, return_counts, axis,
                               convert_dtype(dtype))


# ------------------------------------------------------------- meshgrid etc
@op("meshgrid")
def _meshgrid(xs):
    return list(torch.meshgrid(*xs, indexing="ij"))


def meshgrid(*args, **kwargs):
    """Paddle's meshgrid ("ij" indexing) over 1-D tensors, given one by
    one or as one list."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    like = next((a for a in args if torch.is_tensor(a)), None)
    return _meshgrid([wrap(a, like) for a in args])


@op("unbind")
def _unbind(x, axis):
    return list(torch.unbind(x, axis))


def unbind(input, axis=0, name=None):
    return _unbind(wrap(input), axis)


@op("assign_value")
def _assign_value(values, dtype, device):
    return torch.as_tensor(values, dtype=dtype, device=device)


def assign_value(shape, dtype, values, name=None):
    """A tensor of `values` (host data) with dtype, reshaped to shape."""
    out = box(_assign_value(np.asarray(values), convert_dtype(dtype),
                            resolve_device(None)))
    return out.reshape(list(shape)) if shape else out


@op("crop_tensor")
def _crop(x, offsets, crop_shape):
    for a, (o, s) in enumerate(zip(offsets, crop_shape)):
        x = x.narrow(a, o, s)
    return x


def _host_ints(v):
    return [int(a) for a in (v.tolist() if torch.is_tensor(v) else v)]


def crop(x, shape=None, offsets=None, name=None):
    """x[offsets : offsets + shape] per axis (-1 in shape: to the end)."""
    t = wrap(x)
    offsets = [0] * t.ndim if offsets is None else _host_ints(offsets)
    shp = _host_ints(shape)
    shp = [t.shape[i] - offsets[i] if s == -1 else s
           for i, s in enumerate(shp)]
    return _crop(t, tuple(offsets), tuple(shp))


@op("broadcast_tensors")
def _broadcast_tensors(xs):
    return list(torch.broadcast_tensors(*xs))


def broadcast_tensors(input, name=None):
    xs = list(input)
    like = next((v for v in xs if torch.is_tensor(v)), None)
    return _broadcast_tensors([wrap(v, like) for v in xs])


# ----------------------------------------------------------- TensorArray
class TensorArray(list):
    """LoDTensorArray analogue: a Python list of Tensors."""

    def append(self, t):
        super().append(wrap(t))
        return self


def create_array(dtype="float32", initialized_list=None):
    arr = TensorArray()
    for t in (initialized_list or []):
        arr.append(t)
    return arr


def _index(i):
    return int(i.item()) if torch.is_tensor(i) else int(i)


def array_write(x, i, array=None):
    """Write x at index i (extending with zeros like x when i is past
    the end)."""
    if array is None:
        array = TensorArray()
    idx = _index(i)
    x = wrap(x)
    if idx < len(array):
        array[idx] = x
    else:
        while len(array) < idx:
            array.append(torch.zeros_like(x))
        array.append(x)
    return array


def array_read(array, i):
    return array[_index(i)]


def array_length(array):
    return box(torch.tensor(len(array), dtype=torch.int64,
                            device=resolve_device(None)))


@op("tensor_array_to_tensor")
def _taro(xs, axis, use_stack):
    return torch.stack(list(xs), axis) if use_stack else \
        torch.cat(list(xs), axis)


def tensor_array_to_tensor(input, axis=0, use_stack=False, name=None):
    """Concatenate (or stack) a TensorArray into one tensor; also the
    int64 size of each item along axis."""
    xs = list(input)
    like = next((v for v in xs if torch.is_tensor(v)), None)
    xs = [wrap(v, like) for v in xs]
    sizes = box(torch.tensor([1 if use_stack else x.shape[axis] for x in xs],
                             dtype=torch.int64, device=xs[0].device))
    return _taro(xs, int(axis), bool(use_stack)), sizes
