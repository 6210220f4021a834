"""Shape ops (port of the parts of paddle_tpu/ops/manipulation.py that the
eager surface reaches): reshape, transpose, concat, stack, split,
squeeze, unsqueeze and flatten, and the expand, index_select,
take_along_axis and where that nn/decode.py reaches, and pad (the
nn.functional.pad of the vision slice), under the JAX package's op
types. pad's non-constant modes ("reflect", "replicate", "circular":
numpy's reflect, edge and wrap) gather along each padded axis.
Indexing and __setitem__ are the Tensor's own (torch's, on the autograd
graph); in-place writes into a Tensor that other ops saved make
torch's backward refuse, where the JAX package rebinds."""
from __future__ import annotations

import torch

from ..core.dispatch import op

__all__ = ["reshape", "transpose", "concat", "stack", "split", "squeeze",
           "unsqueeze", "flatten", "expand", "index_select",
           "take_along_axis", "where", "pad"]


def _ints(v):
    if torch.is_tensor(v):
        return [int(a) for a in v.tolist()]
    return [int(a.item()) if torch.is_tensor(a) else int(a) for a in v]


def _axis(axis):
    return int(axis.item()) if torch.is_tensor(axis) else axis


@op("reshape")
def _reshape(x, shape):
    return x.reshape(shape)


def reshape(x, shape, name=None):
    """Paddle's reshape: a 0 copies that dimension from x."""
    shape = _ints(shape)
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return _reshape(x, shape)


@op("transpose")
def _transpose(x, perm):
    return x.permute(*perm)


def transpose(x, perm=None, name=None):
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    return _transpose(x, _ints(perm))


@op("concat")
def _concat(xs, axis):
    return torch.cat(list(xs), dim=axis)


def concat(x, axis=0, name=None):
    return _concat(list(x), _axis(axis))


@op("stack")
def _stack(xs, axis):
    return torch.stack(list(xs), dim=axis)


def stack(x, axis=0, name=None):
    return _stack(list(x), _axis(axis))


@op("split")
def _split(x, sections, axis):
    return list(torch.split(x, sections, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """num_or_sections: a count of equal parts, or a list of sizes (one
    may be -1: the rest)."""
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


@op("squeeze")
def _squeeze(x, axes):
    return x.squeeze() if axes is None else x.squeeze(axes)


def squeeze(x, axis=None, name=None):
    if axis is None:
        return _squeeze(x, None)
    axes = [axis] if isinstance(axis, int) else _ints(axis)
    return _squeeze(x, tuple(a for a in axes if x.shape[a] == 1))


@op("unsqueeze")
def _unsqueeze(x, axes):
    for a in sorted(a % (x.ndim + len(axes)) for a in axes):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis, name=None):
    axes = [axis] if isinstance(axis, int) else _ints(axis)
    return _unsqueeze(x, axes)


@op("flatten")
def _flatten(x, start, stop):
    return x.flatten(start, stop)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _flatten(x, start_axis, stop_axis)


@op("expand")
def _expand(x, shape):
    return x.expand(shape)


def expand(x, shape, name=None):
    """x broadcast to `shape` (-1 keeps x's size on that axis)."""
    shape = _ints(shape)
    pad = len(shape) - x.ndim
    shape = [x.shape[i - pad] if s == -1 else s for i, s in enumerate(shape)]
    return _expand(x, shape)


@op("index_select")
def _index_select(x, index, axis):
    return torch.index_select(x, axis, index.long())


def index_select(x, index, axis=0, name=None):
    return _index_select(x, index, axis)


@op("take_along_axis")
def _take_along_axis(x, indices, axis):
    return torch.gather(x, axis, indices.long())


def take_along_axis(arr, indices, axis, name=None):
    return _take_along_axis(arr, indices, axis)


@op("where")
def _where(cond, x, y):
    return torch.where(cond, x, y)


def where(condition, x=None, y=None, name=None):
    """x where condition holds, else y. With neither x nor y, the
    indices of the true entries (one tensor per axis)."""
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    return _where(condition, x, y)


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
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def pad(x, pad, mode="constant", value=0.0, data_format=None, name=None):
    """Paddle's pad: a flat [lo, hi, ...] list of 2 * ndim entries pads
    every axis from axis 0 (with data_format None); a shorter one pads
    the last len(pad) // 2 axes, last axis first (torch's order), or,
    with a channel-last data_format, the spatial axes before the
    channels."""
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
