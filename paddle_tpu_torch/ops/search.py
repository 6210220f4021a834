"""argmax and topk (port of the parts of paddle_tpu/ops/search.py that
nn/decode.py reaches), under the JAX package's op types "arg_max" and
"top_k_v2". Indices come back int64, as in the reference. topk's order
among equal values is torch's (the JAX package's XLA TopK may order
ties otherwise)."""
from __future__ import annotations

import torch

from ..core.dispatch import op
from ..core.dtypes import convert_dtype

__all__ = ["argmax", "topk"]


@op("arg_max", differentiable=False)
def _argmax(x, axis, keepdim):
    if axis is None:
        return x.reshape(-1).argmax()
    return x.argmax(dim=axis, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """Index of the largest value (over the flattened x when axis is
    None)."""
    return _argmax(x, axis, keepdim).to(convert_dtype(dtype))


@op("top_k_v2")
def _topk(x, k, axis, largest):
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return vals, idx


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    """(values, int64 indices) of the k largest (or smallest) along axis,
    sorted."""
    if torch.is_tensor(k):
        k = int(k.item())
    return _topk(x, k, -1 if axis is None else axis, largest)
