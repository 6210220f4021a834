"""Common functionals (port of paddle_tpu/nn/functional/common.py, the
parts the GPT train step calls).

`linear` keeps Paddle's [in, out] weight layout."""
from __future__ import annotations

from torch.nn import functional as F

from ...core.unported import require_defaults

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None):
    """x @ weight (+ bias), weight [in, out]."""
    return F.linear(x, weight.t(), bias)


def embedding(x, weight):
    """Rows of `weight` at the ids in x."""
    return F.embedding(x.long(), weight)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Paddle's default upscale_in_train dropout over torch's random
    stream (the JAX stream cannot be matched, so no draw is compared
    with it). A mask shared along axes (axis) and downscale_in_infer
    are not ported yet."""
    require_defaults("dropout", axis=(axis, None),
                     mode=(mode, "upscale_in_train"))
    if not training or p == 0.0:
        return x
    return F.dropout(x, p, training=True)
