"""Op registry and the eager call boundary (port of paddle_tpu/core/
dispatch.py).

`@op(op_type)` declares a functional under the op type the JAX package
registers it with ("linear", "matmul_v2", "layer_norm", ...), so the
AMP hook (amp/auto_cast.py) sees the same names and decides the same
casts. A call through the wrapper:
1. applies the AMP hook when auto_cast is active (one flag test when it
   is not), casting the floating tensor arguments;
2. inside a Layer's forward or another op (`_State.depth` > 0), under
   plain dispatch, or when no argument is a Tensor or a parameter (plain
   torch.Tensors, as the serving engine and the train steps pass), calls
   the function on what it got: module bodies and kernels see plain
   torch.Tensors;
3. otherwise (user code handing in Tensors or parameters) converts the
   Tensor arguments to plain aliases, runs the function under plain
   dispatch (core/tensor.py `plain_dispatch`: parameters act as plain
   tensors there) and returns its result as Tensors;
4. at user level checks the result for NaN/Inf under
   FLAGS_check_nan_inf.
There is no tape to record: torch's autograd graph is built by the
function's own torch operations.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from . import flags as _flags
from .tensor import _DIS, Tensor, box, plain

__all__ = ["op", "get_op", "registered_ops", "register_amp_hook",
           "inside", "outermost", "has_tensor", "eager"]

_OP_REGISTRY = {}


class _State:
    # Layer.__call__ and op nesting depth: 0 at user level
    depth = 0
    # the AMP hook, fn(op_type, args, kwargs) -> (args, kwargs), or None
    amp = None
    # static capture (static/program.py, while static mode is on):
    # fn(op_type, fn, args, kwargs, differentiable) -> the recorded
    # outputs, or NotImplemented when no argument is a static Variable
    capture = None


def register_amp_hook(fn):
    """Install (or with None remove) the AMP cast hook."""
    _State.amp = fn


def has_tensor(args, kwargs) -> bool:
    """Whether a call boxes its result: a Tensor or a parameter (not a
    plain torch.Tensor) is among the arguments, or in a list or tuple
    among them, and the caller is not under plain dispatch (the port's
    code there gets plain results, as inside a Layer)."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, Tensor) or type(a) in (list, tuple) and any(
                isinstance(x, Tensor) for x in a):
            return torch._C._is_torch_function_enabled()
    return False


def _plain_arg(a):
    # a parameter passes as itself (an op may write to it, as assign's
    # output does): under _DIS it acts as a plain tensor; a static
    # Variable passes as the plain meta tensor it holds
    if type(a) is Tensor:
        return plain(a)
    return a.__dict__.get("_static_meta", a) if isinstance(a, Tensor) \
        else a


def _unwrap(a):
    if type(a) in (list, tuple):
        return type(a)(_plain_arg(x) for x in a)
    return _plain_arg(a)


def _check_finite(op_type, out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    for a in outs:
        if torch.is_tensor(a) and a.is_floating_point() \
                and not bool(torch.isfinite(a).all()):
            raise FloatingPointError(
                f"Operator {op_type} output contains NaN/Inf "
                "(FLAGS_check_nan_inf is set)")


def inside(fn: Callable, *args, **kwargs):
    """Run fn at depth 1 under plain dispatch (its operations on
    parameters call no __torch_function__), arguments and result as
    they are: Layer.__call__'s boundary for plain tensors."""
    _State.depth += 1
    try:
        with _DIS():
            return fn(*args, **kwargs)
    finally:
        _State.depth -= 1


def outermost(fn: Callable, *args, **kwargs):
    """Run fn `inside` on plain arguments and box its result; the
    boundary of Layer.__call__ and of every op at user level."""
    args = tuple(_unwrap(a) for a in args)
    kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
    return box(inside(fn, *args, **kwargs))


def op(op_type: str, differentiable: bool = True):
    """Declare a functional as op `op_type` (the JAX package's name).
    differentiable marks the outputs of a statically captured call
    stop_gradient; eager torch decides from the operations the function
    runs."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _State.amp is not None:
                args, kwargs = _State.amp(op_type, args, kwargs)
            if _State.capture is not None:
                out = _State.capture(op_type, fn, args, kwargs,
                                     differentiable)
                if out is not NotImplemented:
                    return out
            if _State.depth:
                return fn(*args, **kwargs)
            if has_tensor(args, kwargs):
                out = outermost(fn, *args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if _flags.flag("check_nan_inf"):
                _check_finite(op_type, out)
            return out
        wrapper.op_type = op_type
        wrapper.raw_fn = fn
        _OP_REGISTRY[op_type] = wrapper
        return wrapper
    return deco


def eager(fn: Callable):
    """The call boundary of `op` for a function that has no op type (the
    JAX package computes it outside any registered op): plain tensors
    in and Tensors out at user level, nothing added inside an op or a
    Layer."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _State.depth or not has_tensor(args, kwargs):
            return fn(*args, **kwargs)
        return outermost(fn, *args, **kwargs)
    return wrapper


def get_op(op_type: str):
    return _OP_REGISTRY.get(op_type)


def registered_ops():
    return sorted(_OP_REGISTRY)
