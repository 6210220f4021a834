"""Search, sort and statistics ops (port of paddle_tpu/ops/search.py),
every public name in the reference's order and under the JAX package's
op types. Indices come back int64, as in the reference.

Where torch and the JAX package differ, the JAX package's rule holds, on
the CPU and on CUDA alike:
- `sort`, `argsort`, `topk`, `kthvalue` and `mode` sort stably (torch's
  `stable=True`), so equal values keep their order and their indices are
  the same on both devices: topk takes the lower index first among
  equal values (XLA's TopK);
- `median` averages the two middle values (torch takes the lower one);
  `nanmedian` does the same over the values that are not NaN;
- `mode` returns the smallest of the most frequent values, with the
  index of its last occurrence in stable order (`[1, 2, 2, 1, 3]` gives
  1 at index 3);
- `kthvalue`, `quantile`, `nanquantile` and the rest are computed from
  one stable sort, so their gradients go through the sort;
- `std` and `var` are unbiased unless asked otherwise.
`quantile`'s q as a Tensor is read on the host, as in the JAX package
(ops/__init__.py HOST_READS).
"""
from __future__ import annotations

import math

import torch

from ..core.dispatch import eager, op
from ..core.dtypes import convert_dtype
from ..core.tensor import wrap


@op("arg_max", differentiable=False)
def _argmax(x, axis, keepdim):
    if axis is None:
        return torch.argmax(torch.reshape(x, (-1,)))
    return torch.argmax(x, dim=axis, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """Index of the largest value (over the flattened x when axis is
    None); the first among equal values."""
    return _argmax(wrap(x), axis, keepdim).to(convert_dtype(dtype))


@op("arg_min", differentiable=False)
def _argmin(x, axis, keepdim):
    if axis is None:
        return torch.argmin(torch.reshape(x, (-1,)))
    return torch.argmin(x, dim=axis, keepdim=keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _argmin(wrap(x), axis, keepdim).to(convert_dtype(dtype))


@op("argsort", differentiable=False)
def _argsort(x, axis, descending, stable):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[1]


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    """Stable on every device (stable=False included, as XLA's sort)."""
    return _argsort(wrap(x), axis, descending, stable)


@op("sort")
def _sort(x, axis, descending):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[0]


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return _sort(wrap(x), axis, descending)


@op("top_k_v2")
def _topk(x, k, axis, largest):
    vals, idx = torch.sort(x, dim=axis, descending=largest, stable=True)
    return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    """(values, int64 indices) of the k largest (or smallest) along axis,
    sorted; among equal values the lower index comes first."""
    if torch.is_tensor(k):
        k = int(k.item())
    return _topk(wrap(x), k, -1 if axis is None else axis, largest)


@op("kthvalue")
def _kthvalue(x, k, axis, keepdim):
    vals, idx = torch.sort(x, dim=axis, stable=True)
    vals, idx = vals.select(axis, k - 1), idx.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return _kthvalue(wrap(x), k, axis, keepdim)


@op("mode")
def _mode(x, axis, keepdim):
    # stable sort, then the longest run of equal values: run starts by a
    # running max of the change positions, length = position - start + 1;
    # argmax takes the first longest run (the smallest value)
    vals, order = torch.sort(x, dim=axis, stable=True)
    moved = torch.movedim(vals, axis, -1)
    order = torch.movedim(order, axis, -1)
    n = moved.shape[-1]
    pos = torch.arange(n, device=x.device)
    change = torch.ones(moved.shape, dtype=torch.bool, device=x.device)
    change[..., 1:] = moved[..., 1:] != moved[..., :-1]
    start = torch.cummax(torch.where(change, pos, torch.zeros_like(pos)),
                         moved.ndim - 1).values
    best = torch.argmax(pos - start + 1, dim=-1, keepdim=True)
    out = torch.gather(moved, -1, best)[..., 0]
    idx = torch.gather(order, -1, best)[..., 0]
    if keepdim:
        out, idx = out.unsqueeze(axis), idx.unsqueeze(axis)
    return out, idx


def mode(x, axis=-1, keepdim=False, name=None):
    return _mode(wrap(x), axis, keepdim)


def _interp(s, n, qs, method):
    """Quantiles qs (a list of floats) of the sorted last axis of s over
    its first n entries per row (n: an int, or a tensor of row counts);
    the q axis leads the result."""
    if not torch.is_tensor(n):
        n = torch.full(s.shape[:-1], n, device=s.device)
    nf = n.to(s.dtype if s.is_floating_point() else torch.float32)
    last = (n - 1).clamp_min(0)
    outs = []
    for q in qs:
        pos = q * (nf - 1)
        lo = torch.minimum(torch.floor(pos).long().clamp_min(0), last)
        hi = torch.minimum(torch.ceil(pos).long().clamp_min(0), last)
        a = torch.gather(s, -1, lo[..., None])[..., 0]
        b = torch.gather(s, -1, hi[..., None])[..., 0]
        if method == "linear":
            out = a + (b - a) * (pos - lo.to(pos.dtype)).to(a.dtype)
        elif method == "lower":
            out = a
        elif method == "higher":
            out = b
        elif method == "midpoint":
            out = (a + b) / 2
        elif method == "nearest":
            near = torch.minimum(torch.round(pos).long(), last)
            out = torch.gather(s, -1, near[..., None])[..., 0]
        else:
            raise ValueError(f"unknown interpolation {method!r}")
        outs.append(torch.where(n > 0, out, torch.full_like(out, math.nan)))
    return torch.stack(outs)


def _to_last(x, axis):
    """x with the reduced axes flattened into one last axis, and the
    shape keepdim restores."""
    if axis is None:
        return torch.reshape(x, (-1,)), [1] * x.ndim
    axes = [a % x.ndim for a in ((axis,) if isinstance(axis, int)
                                 else axis)]
    rest = [a for a in range(x.ndim) if a not in axes]
    moved = x.permute(*rest, *axes)
    kept = [1 if a in axes else x.shape[a] for a in range(x.ndim)]
    return moved.reshape(*[x.shape[a] for a in rest], -1), kept


def _quantiles(x, qs, axis, keepdim, method, ignore_nan):
    flat, kept = _to_last(x, axis)
    s = torch.sort(flat, dim=-1, stable=True)[0]
    n = (~torch.isnan(flat)).sum(-1) if ignore_nan else flat.shape[-1]
    out = _interp(s, n, qs, method)
    if keepdim:
        out = out.reshape(len(qs), *kept)
    return out


@op("median")
def _median(x, axis, keepdim):
    return _quantiles(x, [0.5], axis, keepdim and axis is not None,
                      "midpoint", False)[0]


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The middle value (the mean of the two middle values for an even
    count), over the flattened x when axis is None."""
    return _median(wrap(x), axis, keepdim)


@eager
def _nanmedian(x, axis, keepdim):
    return _quantiles(x, [0.5], axis, keepdim and axis is not None,
                      "midpoint", True)[0]


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _nanmedian(wrap(x), axis, keepdim)


def _qlist(q):
    return (list(q), True) if isinstance(q, (list, tuple)) else ([q], False)


@op("quantile")
def _quantile(x, q, axis, keepdim, interpolation):
    qs, many = _qlist(q)
    out = _quantiles(x, [float(v) for v in qs], axis, keepdim,
                     interpolation, False)
    return out if many else out[0]


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    if torch.is_tensor(q):
        q = q.tolist()
    return _quantile(wrap(x), q, axis, keepdim, interpolation)


@eager
def _nanquantile(x, q, axis, keepdim):
    qs, many = _qlist(q)
    out = _quantiles(x, [float(v) for v in qs], axis, keepdim, "linear",
                     True)
    return out if many else out[0]


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    if torch.is_tensor(q):
        q = q.tolist()
    return _nanquantile(wrap(x), q, axis, keepdim)


def _red(x, axis):
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@op("std")
def _std(x, axis, unbiased, keepdim):
    return torch.std(x, _red(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _std(wrap(x), axis, unbiased, keepdim)


@op("var")
def _var(x, axis, unbiased, keepdim):
    return torch.var(x, _red(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _var(wrap(x), axis, unbiased, keepdim)


@op("searchsorted", differentiable=False)
def _searchsorted(sorted_sequence, values, right):
    return torch.searchsorted(sorted_sequence.contiguous(),
                              values.contiguous(), right=right)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq = wrap(sorted_sequence, values)
    out = _searchsorted(seq, wrap(values, seq), right)
    return out.to(torch.int32 if out_int32 else torch.int64)


@op("bucketize", differentiable=False)
def _bucketize(x, boundaries, right):
    return torch.bucketize(x, boundaries.contiguous(), right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    x = wrap(x, sorted_sequence)
    out = _bucketize(x, wrap(sorted_sequence, x), right)
    return out.to(torch.int32 if out_int32 else torch.int64)


__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
           "median", "nanmedian", "quantile", "nanquantile", "std", "var",
           "searchsorted", "bucketize"]
