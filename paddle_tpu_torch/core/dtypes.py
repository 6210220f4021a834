"""Dtypes (port of paddle_tpu/core/dtypes.py).

The JAX package's dtypes are jnp dtypes under Paddle's names; the
port's are torch dtypes under the same names, so `paddle.float32` is
`torch.float32` and a Tensor's `.dtype` compares equal to it.

Promotion is torch's, which agrees with the rules
tests/test_dtype_promotion.py pins on the JAX package: a Python scalar
is weak (f32 * 2.0 stays f32, bf16 * 2.0 stays bf16), a numpy scalar
does not widen a tensor (f32 * np.float64(2) stays f32), and bool and
integer tensors divide into the default float dtype (int64 / 2 is
float32).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "set_default_dtype", "get_default_dtype"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "fp16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "fp32": float32, "float64": float64, "fp64": float64,
    "complex64": complex64, "complex128": complex128,
}

_FLOATING = {float16, bfloat16, float32, float64}


def convert_dtype(dtype):
    """Any dtype spec (a name, a numpy dtype or type, a torch dtype, or
    None) as a torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise ValueError(f"Unsupported dtype string: {dtype!r}") \
                from None
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"Cannot convert {dtype!r} to a dtype") from None
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"Cannot convert {dtype!r} to a dtype")
    return _NAME_TO_DTYPE[name]


_default_dtype = float32


def set_default_dtype(d):
    """The float dtype that Python floats take in to_tensor and the
    creation ops (torch's own default is left alone)."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in _FLOATING:
        raise TypeError(
            "set_default_dtype only supports floating dtypes, got %s" % d)
    _default_dtype = d


def get_default_dtype():
    return _default_dtype
