"""auto_cast (port of paddle_tpu/amp/auto_cast.py): AMP O1 and O2 over
the op boundary's hook (core/dispatch.py).

Inside `auto_cast(level="O1")` every registered op on the white list
gets its floating tensor arguments in the low-precision dtype, every op
on the black list gets them in float32, and the others take what they
are given. O2 casts every op's arguments to the low-precision dtype but
the black list's. The lists are the reference's, letter for letter
(paddle_tpu/amp/auto_cast.py:20-37), with custom_white_list and
custom_black_list on top. torch.autocast is not used: its lists differ.

On the GPT train step under O1: the "linear" ops hand bf16 q/k/v to
scaled_dot_product_attention (so the flash kernel runs in bf16),
"layer_norm" and "softmax_with_cross_entropy" run in float32, and the
residual adds promote the bf16 branch back to float32, as in the
reference.

The hook is installed only while a context is active, so with AMP off
the op boundary pays one test of it.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ..core import dispatch as _dispatch
from ..core.dtypes import convert_dtype

__all__ = ["auto_cast", "amp_guard", "WHITE_LIST", "BLACK_LIST",
           "white_list", "black_list", "cast_dtype"]

# reference: fluid/contrib/mixed_precision/fp16_lists.py white/black lists
WHITE_LIST = {
    "conv2d", "matmul_v2", "bmm", "mv", "einsum", "mul", "linear",
    "addmm",
}
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "reduce_mean",
    "reduce_sum", "cos_sim", "softmax_with_cross_entropy",
    "softmax_with_cross_entropy_keepdim", "cross_entropy",
    "cross_entropy_probs", "bce_loss", "bce_with_logits",
    "sigmoid_cross_entropy_with_logits", "c_softmax_with_cross_entropy",
    "layer_norm", "batch_norm_train", "batch_norm_infer",
    "fused_bn_add_act_train", "p_norm",
    "frobenius_norm", "softmax", "log_softmax", "logsumexp", "cumsum",
    "nll_loss", "kl_div", "mse_loss", "l1_loss",
}

white_list = WHITE_LIST
black_list = BLACK_LIST


class _AmpState:
    enabled = False
    level = "O1"
    dtype = torch.bfloat16
    white = WHITE_LIST
    black = BLACK_LIST


def cast_dtype(op_type: str, dtype):
    """The dtype the floating arguments of `op_type` take under the
    active auto_cast; `dtype` when no context decides (or AMP is off)."""
    if not _AmpState.enabled:
        return dtype
    if op_type in _AmpState.black:
        return torch.float32
    if _AmpState.level == "O2" or op_type in _AmpState.white:
        return _AmpState.dtype
    return dtype


def _cast(a, dtype):
    if torch.is_tensor(a):
        if a.is_floating_point() and a.dtype != dtype:
            return a.to(dtype)
        return a
    if type(a) in (list, tuple):
        return type(a)(_cast(x, dtype) for x in a)
    return a


def _amp_hook(op_type, args, kwargs):
    dtype = cast_dtype(op_type, None)
    if dtype is None:
        return args, kwargs
    return (tuple(_cast(a, dtype) for a in args),
            {k: _cast(v, dtype) for k, v in kwargs.items()})


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast: O1 or O2 casting of the registered ops'
    arguments inside the context."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level {level!r}: expected 'O1' or 'O2'")
    cw, cb = set(custom_white_list or ()), set(custom_black_list or ())
    with restored((bool(enable), level, convert_dtype(dtype),
                   (WHITE_LIST | cw) - cb, (BLACK_LIST | cb) - cw,
                   _amp_hook if enable else None)):
        yield


def current():
    """The active casting state, as `restored` takes it."""
    return (_AmpState.enabled, _AmpState.level, _AmpState.dtype,
            _AmpState.white, _AmpState.black, _dispatch._State.amp)


@contextmanager
def restored(state):
    """Run the body under a casting state taken by `current` (a
    recomputed forward runs under the casts of its first run), then put
    back the one before."""
    prev = current()
    (_AmpState.enabled, _AmpState.level, _AmpState.dtype, _AmpState.white,
     _AmpState.black, hook) = state
    _dispatch.register_amp_hook(hook)
    try:
        yield
    finally:
        (_AmpState.enabled, _AmpState.level, _AmpState.dtype,
         _AmpState.white, _AmpState.black, hook) = prev
        _dispatch.register_amp_hook(hook)


amp_guard = auto_cast
