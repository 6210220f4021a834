"""Common functionals (port of paddle_tpu/nn/functional/common.py, the
parts the train steps call), registered under the JAX package's op
types: "linear" (on the AMP white list), "lookup_table_v2" and
"dropout".

`linear` keeps Paddle's [in, out] weight layout. `embedding` zeroes the
rows of `padding_idx` as the reference does (a negative index counts
from the end); `sparse` (SelectedRows gradients) is not ported yet.
`dropout` draws its mask from the port's generator of x's device
(core/random.py), so paddle.seed fixes it; the JAX stream cannot be
matched, so no draw is compared with it."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...core import random as _random
from ...core.dispatch import op
from ...core.unported import require_defaults

__all__ = ["linear", "embedding", "dropout"]


@op("linear")
def _linear(x, weight, bias):
    return F.linear(x, weight.t(), bias)


def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight [in, out]."""
    return _linear(x, weight, bias)


@op("lookup_table_v2")
def _embedding(weight, ids, padding_idx):
    out = F.embedding(ids.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids in x; rows of padding_idx come back
    zero (and pass no gradient)."""
    require_defaults("embedding", sparse=(sparse, False))
    if padding_idx is not None and padding_idx < 0:
        padding_idx = weight.shape[0] + padding_idx
    return _embedding(weight, x, padding_idx)


@op("dropout")
def _dropout(x, mask, p):
    return x * mask / (1.0 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Paddle's default upscale_in_train dropout. A mask shared along
    axes (axis) and downscale_in_infer are not ported yet."""
    require_defaults("dropout", axis=(axis, None),
                     mode=(mode, "upscale_in_train"))
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return x * 0.0
    keep = torch.rand(x.shape, generator=_random.generator(x.device),
                      device=x.device) >= p
    return _dropout(x, keep.to(x.dtype), p)
