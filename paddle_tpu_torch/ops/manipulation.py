"""Shape ops (port of the parts of paddle_tpu/ops/manipulation.py that the
eager surface reaches): reshape, transpose, concat, stack, split,
squeeze, unsqueeze and flatten, under the JAX package's op types.
Indexing and __setitem__ are the Tensor's own (torch's, on the autograd
graph); in-place writes into a Tensor that other ops saved make
torch's backward refuse, where the JAX package rebinds."""
from __future__ import annotations

import torch

from ..core.dispatch import op

__all__ = ["reshape", "transpose", "concat", "stack", "split", "squeeze",
           "unsqueeze", "flatten"]


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
