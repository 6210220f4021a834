"""Declarative op-test harness (port of paddle_tpu/testing/op_test.py).

The same contract as the JAX package's, on torch:

- **forward**: call the public API on `to_tensor(inputs)` with `kwargs`,
  compare every output against a numpy oracle (`ref`);
- **backward**: seed a fixed random cotangent on the checked output, run
  torch's autograd (`Tensor.backward`), and compare each requested input
  gradient against central finite differences computed in float64.

The JAX package's third check, jit parity (`check_jit_parity`: the
forward under `jax.jit` against the eager one), has no counterpart: the
port runs eagerly, and `case.check_jit` is accepted and ignored.

A case is data, not a subclass: tests/test_torch_op_suite.py drives the
JAX package's tables through this harness and the JAX one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _to_np(x):
    return np.asarray(x)


def numeric_grad(fn: Callable[..., float], args, wrt: int, eps: float = 1e-5):
    """Central finite differences of scalar-valued fn w.r.t. args[wrt]
    (float64 copies of the floating arguments; one element at a time,
    eps on both sides)."""
    args = [a.astype(np.float64)
            if isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating)
            else a for a in args]
    x = args[wrt]
    g = np.zeros_like(x, dtype=np.float64)
    flat_x = x.reshape(-1)
    flat_g = g.reshape(-1)
    for i in range(flat_x.size):
        orig = flat_x[i]
        flat_x[i] = orig + eps
        up = fn(*args)
        flat_x[i] = orig - eps
        dn = fn(*args)
        flat_x[i] = orig
        flat_g[i] = (up - dn) / (2 * eps)
    return g


@dataclass
class OpTestCase:
    """One declarative op test.

    api:      public API callable (takes Tensors / python scalars).
    args:     positional inputs as numpy arrays or python values.
    kwargs:   attrs (non-Tensor keyword arguments).
    ref:      numpy oracle: ref(*np_args, **kwargs) -> np output (or tuple).
              None skips the value check (smoke + grad only).
    grad:     indices of `args` whose gradients to check by FD.
    out_sel:  if the api returns a tuple, index of the output to diff/check
              for gradients (value check still compares all ref outputs).
    op_types: registered op names this case exercises (for coverage audit).
    """
    api: Callable
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    ref: Optional[Callable] = None
    grad: Sequence[int] = ()
    out_sel: int = 0
    op_types: Sequence[str] = ()
    atol: float = 1e-5
    rtol: float = 1e-4
    grad_atol: float = 1e-3
    grad_rtol: float = 1e-2
    check_jit: bool = False
    name: str = ""

    def __post_init__(self):
        if not self.name:
            self.name = getattr(self.api, "__name__", "op")


def _call_api(case: OpTestCase, np_args, stop_gradient=True):
    import paddle_tpu_torch as paddle
    targs = []
    for a in np_args:
        if isinstance(a, np.ndarray):
            targs.append(paddle.to_tensor(a, stop_gradient=stop_gradient))
        else:
            targs.append(a)
    return case.api(*targs, **case.kwargs), targs


def _flat_outputs(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        flat = []
        for o in out:
            flat.extend(_flat_outputs(o))
        return flat
    return []


def check_output(case: OpTestCase):
    out, _ = _call_api(case, case.args)
    outs = _flat_outputs(out)
    assert outs, f"{case.name}: api returned no Tensors"
    if case.ref is None:
        for o in outs:
            _to_np(o.numpy())  # materialize: smoke check
        return outs
    expected = case.ref(*[a for a in case.args], **case.kwargs)
    if not isinstance(expected, (tuple, list)):
        expected = [expected]
    for o, e in zip(outs, expected):
        if e is None:
            continue
        got = o.numpy()
        e = np.asarray(e)
        if np.issubdtype(e.dtype, np.floating) or np.issubdtype(
                e.dtype, np.complexfloating):
            np.testing.assert_allclose(
                got.astype(np.float64), e.astype(np.float64),
                atol=case.atol, rtol=case.rtol,
                err_msg=f"{case.name}: forward mismatch")
        else:
            np.testing.assert_array_equal(
                got, e, err_msg=f"{case.name}: forward mismatch")
    return outs


def check_grad(case: OpTestCase):
    if not case.grad:
        return
    import paddle_tpu_torch as paddle

    # float64 inputs for a sharp FD oracle
    np_args = []
    for a in case.args:
        if isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating):
            np_args.append(a.astype(np.float64))
        else:
            np_args.append(a)

    out, targs = _call_api(case, np_args, stop_gradient=False)
    target = _flat_outputs(out)[case.out_sel]
    # fixed random cotangent => scalar objective sum(target * w)
    rng = np.random.RandomState(1234)
    w = rng.uniform(0.5, 1.5, size=tuple(target.shape))
    wt = paddle.to_tensor(w, place=target.device).to(target.dtype)
    (target * wt).sum().backward()

    def scalar_fn(*fa):
        o, _ = _call_api(case, list(fa))
        t = _flat_outputs(o)[case.out_sel]
        return float((t.numpy().astype(np.float64) * w).sum())

    for gi in case.grad:
        t = targs[gi]
        got = t.grad.numpy().astype(np.float64)
        ng = numeric_grad(scalar_fn, np_args, gi)
        np.testing.assert_allclose(
            got, ng, atol=case.grad_atol, rtol=case.grad_rtol,
            err_msg=f"{case.name}: grad mismatch for arg {gi}")


def run_case(case: OpTestCase):
    check_output(case)
    check_grad(case)
