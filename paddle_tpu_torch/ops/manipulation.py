"""Shape, layout, gather and scatter ops (port of paddle_tpu/ops/
manipulation.py), every public name in the reference's order and under
the JAX package's op types.

Paddle's argument order and meaning hold where torch's differ:
`split(x, 2)` makes two pieces (a count, or a list of sizes with one
-1), `gather(x, index, axis)` selects along an axis,
`index_select(x, index, axis)`, `flip(x, axis)`, and `expand` keeps an
axis for -1. pad's non-constant modes ("reflect", "replicate",
"circular": numpy's reflect, edge and wrap) gather along each padded
axis; `strided_slice` takes negative strides.

Scatters with repeated indices give the JAX package's CPU result on
every device, and the same one on CUDA run after run: with overwrite
the last update of a row wins (the winner is found with a max over
update positions, and the rows are gathered, never written by racing
threads); accumulating scatters (`scatter(overwrite=False)`,
`scatter_nd_add`, `index_add`, `put_along_axis(reduce="add")`) go
through torch's `index_put_(accumulate=True)`, which sorts the indices
on CUDA and adds in a fixed order.

The in-place variants (`reshape_`, `squeeze_`, `unsqueeze_`,
`scatter_`) change x itself with torch's in-place ops, so a leaf that
needs grad refuses them, as the JAX package's check does; `reshape_`
needs a contiguous x. Shape and offset arguments given as Tensors are
read on the host, as in the JAX package (ops/__init__.py HOST_READS).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dispatch import eager, op
from ..core.tensor import wrap


_pyslice = builtins.slice


def _ints(v):
    if torch.is_tensor(v):
        return [int(a) for a in torch.reshape(v, (-1,)).tolist()]
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(a.item()) if torch.is_tensor(a) else int(a) for a in v]


def _axis(axis):
    return int(axis.item()) if torch.is_tensor(axis) else axis


@op("reshape")
def _reshape(x, shape):
    return torch.reshape(x, shape)


def reshape(x, shape, name=None):
    """Paddle's reshape: a 0 copies that dimension from x, one -1 takes
    the rest."""
    x = wrap(x)
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(_ints(shape))]
    return _reshape(x, shape)


def reshape_(x, shape, name=None):
    out = reshape(x.detach(), shape)
    if not x.is_contiguous():
        raise ValueError("reshape_ needs a contiguous Tensor; use reshape")
    x.as_strided_(out.shape, out.stride())
    return x


@op("transpose")
def _transpose(x, perm):
    return x.permute(*perm)


def transpose(x, perm=None, name=None):
    x = wrap(x)
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    return _transpose(x, _ints(perm))


def t(x, name=None):
    x = wrap(x)
    if x.ndim < 2:
        return x
    return transpose(x, [1, 0])


def moveaxis(x, source, destination, name=None):
    return _moveaxis(wrap(x), tuple(_ints(source)),
                     tuple(_ints(destination)))


@op("moveaxis")
def _moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@op("concat")
def _concat(xs, axis):
    return torch.cat(list(xs), dim=axis)


def concat(x, axis=0, name=None):
    xs = list(x)
    like = next((v for v in xs if torch.is_tensor(v)), None)
    return _concat([wrap(v, like) for v in xs], _axis(axis))


@op("stack")
def _stack(xs, axis):
    return torch.stack(list(xs), dim=axis)


def stack(x, axis=0, name=None):
    xs = list(x)
    like = next((v for v in xs if torch.is_tensor(v)), None)
    return _stack([wrap(v, like) for v in xs], _axis(axis))


@op("unstack")
def _unstack(x, axis, num):
    return list(torch.unbind(x, axis))


def unstack(x, axis=0, num=None, name=None):
    x = wrap(x)
    return _unstack(x, axis, x.shape[axis] if num is None else num)


@op("split")
def _split(x, sections, axis):
    # torch.Tensor.split, not torch.split: torch.split calls the method of
    # its argument, which on a parameter is this module's split
    return list(torch.Tensor.split(x, sections, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """num_or_sections: a count of equal parts, or a list of sizes (one
    may be -1: the rest)."""
    x = wrap(x)
    axis = _axis(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, (list, tuple)):
        secs = _ints(num_or_sections)
        if -1 in secs:
            known = sum(s for s in secs if s != -1)
            secs = [total - known if s == -1 else s for s in secs]
    else:
        n = int(num_or_sections)
        if total % n:
            raise ValueError(f"split: dimension {total} of axis {axis} is "
                             f"not divisible into {n} parts")
        secs = [total // n] * n
    return _split(x, secs, axis)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@eager
def _tensor_split(x, num_or_indices, axis):
    return list(torch.tensor_split(x, num_or_indices, dim=axis))


def tensor_split(x, num_or_indices, axis=0, name=None):
    """Like split, but a count need not divide the axis (the first
    parts take one more)."""
    n = num_or_indices if isinstance(num_or_indices, int) \
        else _ints(num_or_indices)
    return _tensor_split(wrap(x), n, axis)


@op("squeeze")
def _squeeze(x, axes):
    return torch.squeeze(x) if axes is None else torch.squeeze(x, axes)


def _squeeze_axes(x, axis):
    axes = _ints(axis)
    return tuple(a % x.ndim for a in axes if x.shape[a] == 1)


def squeeze(x, axis=None, name=None):
    x = wrap(x)
    if axis is None:
        return _squeeze(x, None)
    return _squeeze(x, _squeeze_axes(x, axis))


def squeeze_(x, axis=None, name=None):
    if axis is None:
        torch.Tensor.squeeze_(x)
        return x
    for a in sorted(_squeeze_axes(x, axis), reverse=True):
        torch.Tensor.squeeze_(x, a)
    return x


@op("unsqueeze")
def _unsqueeze(x, axes):
    for a in axes:
        x = torch.unsqueeze(x, a)
    return x


def unsqueeze(x, axis, name=None):
    """New axes of size 1 inserted one after another, each at its
    position in the result so far (jnp.expand_dims in order)."""
    return _unsqueeze(wrap(x), tuple(_ints(axis)))


def unsqueeze_(x, axis, name=None):
    for a in _ints(axis):
        torch.Tensor.unsqueeze_(x, a)
    return x


@op("flatten")
def _flatten(x, start, stop):
    return torch.flatten(x, start, stop)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = wrap(x)
    if x.ndim == 0:
        return _reshape(x, [1])
    return _flatten(x, start_axis % x.ndim, stop_axis % x.ndim)


@op("expand")
def _expand(x, shape):
    return torch.broadcast_to(x, shape)


def expand(x, shape, name=None):
    """x broadcast to `shape` (-1 keeps x's size on that axis)."""
    x = wrap(x)
    shape = _ints(shape)
    pad = len(shape) - x.ndim
    shape = [x.shape[i - pad] if s == -1 else s for i, s in enumerate(shape)]
    return _expand(x, shape)


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@op("tile")
def _tile(x, reps):
    return torch.tile(x, reps)


def tile(x, repeat_times, name=None):
    return _tile(wrap(x), tuple(_ints(repeat_times)))


@op("repeat_interleave")
def _repeat_interleave(x, repeats, axis):
    return torch.repeat_interleave(x, repeats, dim=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    """Each entry repeated `repeats` times along axis (over the flattened
    x when None); repeats may be a Tensor of per-entry counts."""
    x = wrap(x)
    if torch.is_tensor(repeats):
        repeats = repeats.to(x.device)
    else:
        repeats = int(repeats)
    return _repeat_interleave(x, repeats, axis)


@op("roll")
def _roll(x, shifts, axis):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    if torch.is_tensor(shifts):
        shifts = tuple(_ints(shifts))
    if isinstance(shifts, list):
        shifts = tuple(shifts)
    if isinstance(axis, list):
        axis = tuple(axis)
    return _roll(wrap(x), shifts, axis)


@op("flip")
def _flip(x, axis):
    return torch.flip(x, axis)


def flip(x, axis, name=None):
    return _flip(wrap(x), tuple(_ints(axis)))


reverse = flip


@op("rot90")
def _rot90(x, k, axes):
    return torch.rot90(x, k, axes)


def rot90(x, k=1, axes=(0, 1), name=None):
    return _rot90(wrap(x), k, tuple(axes))


@op("gather")
def _gather(x, index, axis):
    if index.ndim == 0:
        index = index[None]
    out = torch.index_select(x, axis, torch.reshape(index, (-1,)).long())
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


def gather(x, index, axis=0, name=None):
    """Rows (entries along `axis`) of x at index."""
    x = wrap(x)
    axis = _axis(axis)
    return _gather(x, wrap(index, x), axis % x.ndim)


@op("gather_nd")
def _gather_nd(x, index):
    return x[tuple(torch.movedim(index.long(), -1, 0))]


def gather_nd(x, index, name=None):
    x = wrap(x)
    return _gather_nd(x, wrap(index, x))


def _last_writer(n, index):
    """For each of n targets, the position of the last update that
    writes it (-1: none). A max over positions, so the same on every
    device and every run."""
    pos = torch.arange(index.numel(), device=index.device)
    return torch.full((n,), -1, dtype=torch.int64, device=index.device) \
        .scatter_reduce(0, torch.reshape(index, (-1,)), pos, "amax")


@op("scatter")
def _scatter(x, index, updates, overwrite):
    index = torch.reshape(index, (-1,)).long()
    win = _last_writer(x.shape[0], index)
    hit = (win >= 0).reshape([-1] + [1] * (x.ndim - 1))
    if overwrite:
        rows = torch.index_select(updates, 0, win.clamp_min(0))
        return torch.where(hit, rows.to(x.dtype), x)
    # paddle scatter(overwrite=False): zero the rows, then accumulate
    base = torch.where(hit, torch.zeros_like(x), x)
    return base.index_put((index,), updates.to(x.dtype), accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    """x with rows `index` replaced by updates (the last update of a
    repeated row wins), or, with overwrite False, by the sum of the
    updates that name them."""
    x = wrap(x)
    return _scatter(x, wrap(index, x), wrap(updates, x), overwrite)


def scatter_(x, index, updates, overwrite=True, name=None):
    out = scatter(x.detach(), index, updates, overwrite)
    with torch.no_grad():
        x.copy_(out)
    return x


@op("scatter_nd_add")
def _scatter_nd_add(x, index, updates):
    idx = tuple(torch.movedim(index.long(), -1, 0))
    return x.index_put(idx, updates.to(x.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x = wrap(x)
    return _scatter_nd_add(x, wrap(index, x), wrap(updates, x))


def scatter_nd(index, updates, shape, name=None):
    updates = wrap(updates)
    x = torch.zeros(_ints(shape), dtype=updates.dtype, device=updates.device)
    return scatter_nd_add(x, index, updates)


@op("index_select")
def _index_select(x, index, axis):
    return torch.index_select(x, axis, index.long())


def index_select(x, index, axis=0, name=None):
    x = wrap(x)
    return _index_select(x, wrap(index, x), axis)


@op("index_sample")
def _index_sample(x, index):
    return torch.gather(x, 1, index.long())


def index_sample(x, index, name=None):
    x = wrap(x)
    return _index_sample(x, wrap(index, x))


@op("index_add")
def _index_add(x, index, axis, value):
    moved = torch.movedim(x, axis, 0)
    out = moved.index_put((index.long(),), torch.movedim(value, axis, 0)
                          .to(x.dtype), accumulate=True)
    return torch.movedim(out, 0, axis)


def index_add(x, index, axis, value, name=None):
    x = wrap(x)
    return _index_add(x, wrap(index, x), axis, wrap(value, x))


@op("take_along_axis")
def _take_along_axis(x, indices, axis):
    return torch.gather(x, axis, indices.long())


def take_along_axis(arr, indices, axis, name=None):
    arr = wrap(arr)
    return _take_along_axis(arr, wrap(indices, arr), axis)


@op("put_along_axis")
def _put_along_axis(x, indices, values, axis, reduce):
    axis = axis + x.ndim if axis < 0 else axis
    indices = indices.long()
    values = torch.broadcast_to(values.to(x.dtype), indices.shape)
    # the flat position in x of every (indices position): the caller's
    # index on `axis`, the open grid on the other axes
    lin = torch.zeros(indices.shape, dtype=torch.int64, device=x.device)
    stride = 1
    for d in reversed(range(x.ndim)):
        if d == axis:
            coord = indices
        else:
            shape = [-1 if i == d else 1 for i in range(x.ndim)]
            coord = torch.arange(indices.shape[d], device=x.device) \
                .reshape(shape)
        lin = lin + coord * stride
        stride *= x.shape[d]
    flat = torch.reshape(x, (-1,))
    lin, vals = torch.reshape(lin, (-1,)), torch.reshape(values, (-1,))
    if reduce == "assign":
        win = _last_writer(flat.numel(), lin)
        out = torch.where(win >= 0,
                          torch.index_select(vals, 0, win.clamp_min(0)), flat)
    elif reduce == "add":
        out = flat.index_put((lin,), vals, accumulate=True)
    elif reduce in ("multiply", "mul"):
        out = flat.scatter_reduce(0, lin, vals, "prod")
    else:
        raise ValueError(f"unknown reduce {reduce}")
    return out.reshape(x.shape)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr = wrap(arr)
    return _put_along_axis(arr, wrap(indices, arr), wrap(values, arr), axis,
                           reduce)


@op("masked_select")
def _masked_select(x, mask):
    return torch.masked_select(x, mask)


def masked_select(x, mask, name=None):
    """The entries of x where mask (broadcast to x) holds, flattened.
    The count is data-dependent: torch learns it from the device."""
    x = wrap(x)
    return _masked_select(x, wrap(mask, x))


@op("masked_fill")
def _masked_fill(x, mask, value):
    v = value.to(x.dtype) if torch.is_tensor(value) else torch.tensor(
        value, dtype=x.dtype, device=x.device)
    return torch.where(mask, v, x)


def masked_fill(x, mask, value, name=None):
    x = wrap(x)
    return _masked_fill(x, wrap(mask, x), value)


@op("where")
def _where(cond, x, y):
    return torch.where(cond, x, y)


def where(condition, x=None, y=None, name=None):
    """x where condition holds, else y. With neither x nor y, the
    indices of the true entries (one tensor per axis)."""
    condition = wrap(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x = wrap(x, condition)
    return _where(condition, x, wrap(y, x))


@eager
def _nonzero(x, as_tuple):
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def nonzero(x, as_tuple=False):
    """int64 indices of the nonzero entries ([count, ndim], or one
    tensor per axis); the count comes from the device."""
    return _nonzero(wrap(x), as_tuple)


def _pad_index(n, lo, hi, mode, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    period = 2 * (n - 1)
    i = i.abs() % period if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@op("pad_nd")
def _pad_nd(x, width, mode, value):
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode}")
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            x = torch.index_select(x, ax, _pad_index(x.shape[ax], lo, hi,
                                                     mode, x.device))
    return x


def pad(x, pad, mode="constant", value=0.0, data_format=None, name=None):
    """Paddle's pad: a flat [lo, hi, ...] list of 2 * ndim entries pads
    every axis from axis 0 (with data_format None); a shorter one pads
    the last len(pad) // 2 axes, last axis first (torch's order), or,
    with a channel-last data_format, the spatial axes before the
    channels."""
    x = wrap(x)
    pad = _ints(pad)
    nd = x.ndim
    if len(pad) == 2 * nd and data_format is None:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        k = len(pad) // 2
        tail = [(pad[2 * i], pad[2 * i + 1]) for i in range(k)][::-1]
        if data_format in ("NHWC", "NDHWC", "NLC"):
            width = [(0, 0)] + tail + [(0, 0)] * (nd - k - 1)
        else:
            width = [(0, 0)] * (nd - k) + tail
    return _pad_nd(x, tuple(width), mode, value)


@op("slice")
def _slice(x, axes, starts, ends):
    idx = [_pyslice(None)] * x.ndim
    for a, s, e in zip(axes, starts, ends):
        idx[a] = _pyslice(s, e)
    return x[tuple(idx)]


def slice(x, axes, starts, ends):  # noqa: A001
    """x[starts:ends] on each of axes (Python's clamping)."""
    return _slice(wrap(x), tuple(axes), tuple(_ints(starts)),
                  tuple(_ints(ends)))


@op("strided_slice")
def _strided_slice(x, axes, starts, ends, strides):
    for a, s, e, st in zip(axes, starts, ends, strides):
        if st > 0:
            idx = [_pyslice(None)] * x.ndim
            idx[a] = _pyslice(s, e, st)
            x = x[tuple(idx)]
        else:
            rows = list(range(*_pyslice(s, e, st).indices(x.shape[a])))
            x = torch.index_select(x, a, torch.tensor(
                rows, dtype=torch.int64, device=x.device))
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _strided_slice(wrap(x), tuple(axes), tuple(_ints(starts)),
                          tuple(_ints(ends)), tuple(_ints(strides)))


@op("as_complex")
def _as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_complex(x, name=None):
    return _as_complex(wrap(x))


@op("as_real")
def _as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def as_real(x, name=None):
    return _as_real(wrap(x))


@eager
def _shard_index(v, index_num, nshards, shard_id, ignore_value):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(v, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, v % shard_size,
                       torch.full_like(v, ignore_value))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """The index within shard `shard_id` of each id, or ignore_value for
    ids of other shards (the reference's shard_index_op)."""
    return _shard_index(wrap(input), index_num, nshards, shard_id,
                        ignore_value)


# canonical implementations live in array_ops; re-exported here for the
# legacy import paths, as in the JAX package
from .array_ops import (  # noqa: E402,F401
    crop, unique, unique_consecutive, numel, broadcast_tensors,
)

__all__ = ["reshape", "reshape_", "transpose", "t", "moveaxis", "concat",
           "stack", "unstack", "split", "chunk", "tensor_split", "squeeze",
           "squeeze_", "unsqueeze", "unsqueeze_", "flatten", "expand",
           "broadcast_to", "expand_as", "broadcast_shape", "tile",
           "repeat_interleave", "roll", "flip", "reverse", "rot90", "gather",
           "gather_nd", "scatter", "scatter_", "scatter_nd_add",
           "scatter_nd", "index_select", "index_sample", "index_add",
           "take_along_axis", "put_along_axis", "masked_select",
           "masked_fill", "where", "nonzero", "pad", "slice",
           "strided_slice", "as_complex", "as_real", "shard_index"]
