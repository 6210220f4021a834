"""Debug ops Print and Assert (port of paddle_tpu/static/debug_ops.py;
reference: operators/print_op.cc, operators/assert_op.cc).

On a Tensor they print or raise at once. On a static Variable they
record an op that does so when the Executor runs it (the JAX package
lowers them to host callbacks inside its compiled program): Print
passes its input through, Assert reads the condition on the host.

Left out: print_tensor_name and print_tensor_lod (accepted; the name
is in the message, there is no LoD).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import plain, to_tensor

__all__ = ["Print", "Assert"]

_print_counts: dict = {}


def _host(t) -> np.ndarray:
    t = plain(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _is_var(t) -> bool:
    from .program import _var_of
    return _var_of(t) is not None


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False, name=None):
    """reference: operators/print_op.cc: an identity op that prints the
    tensor (at most first_n times per site)."""
    key = id(name) if name else message

    def show(t):
        if t.device.type == "meta":   # the capture's shape inference
            return t
        cnt = _print_counts.get(key, 0)
        if first_n >= 0 and cnt >= first_n:
            return t
        _print_counts[key] = cnt + 1
        arr = _host(t)
        parts = [(message or "") + (f" [{name}]" if name else "")]
        if print_tensor_shape:
            parts.append(f"shape={list(arr.shape)}")
        if print_tensor_type:
            parts.append(f"dtype={arr.dtype}")
        parts.append(f"data={arr.reshape(-1)[:summarize].tolist()}")
        print(" ".join(p for p in parts if p))
        return t

    t = input if torch.is_tensor(input) else to_tensor(input)
    if _is_var(t):
        from .program import _record
        return _record("print", show, (t,), {})
    return show(t)


def Assert(cond, data=None, summarize=20, name=None):
    """reference: operators/assert_op.cc: raise AssertionError when cond
    is False, printing the `data` tensors."""
    data = list(data or [])

    def check(c, *tensors):
        if c.device.type == "meta":   # the capture's shape inference
            return c
        if not bool(np.all(_host(c))):
            details = "; ".join(str(_host(d).reshape(-1)[:summarize])
                                for d in tensors)
            raise AssertionError(f"Assert op failed ({name or ''}): "
                                 f"{details}")
        return c

    c = cond if torch.is_tensor(cond) else to_tensor(cond)
    tensors = [d if torch.is_tensor(d) else to_tensor(d) for d in data]
    if _is_var(c) or any(_is_var(d) for d in tensors):
        from .program import _record
        _record("assert", check, (c, *tensors), {})
        return
    check(c, *tensors)
