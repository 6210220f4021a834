"""Control-flow ops usable eagerly and under static capture (port of
paddle_tpu/ops/control_flow.py; reference fluid/layers/control_flow.py
while_loop:1075, cond:2334, case:2914, switch_case:3129).

Eager calls run Python control flow on the concrete value, as the JAX
package's eager path does: the predicate (a Tensor or a Python bool) is
read on the host and the chosen branch, or the body while the
condition holds, runs on the tensors as they are.

The JAX package's traced case is a jax Tracer inside jax.jit; in the
port it is a static Variable while a capture runs (static/program.py:
to_static's concrete_program, a to_static function called under
static.program_guard, any static-mode code). Then each call records one
op of the type the JAX package names: "while", "conditional_block",
"switch_case", over sub-programs captured by static/nn.py's machinery
(`cond` and `while_loop` are static.nn's; switch_case records one op
over its branches' sub-programs with the same helpers). The Executor
reads the predicate or index on the host and runs the chosen
sub-program eagerly on the device. Constants and Python numbers among
the loop variables and branch results enter the program as "assign"
ops of their values.

`cond` keeps the JAX code's operand rule: `operands` are passed to both
branches, and under capture they are inputs of the recorded op, so
gradients reach every tensor the branches read (the reference's
conditional_block registers its input vars the same way).

Left out: nothing of the JAX module (its private `_while_op`,
`_cond_op` and `_switch_op` are jax.lax lowerings, which the static
ops replace).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.tensor import plain, to_tensor

__all__ = ["while_loop", "cond", "case", "switch_case"]


def _wrap(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _is_traced(*objs) -> bool:
    """Whether a static Variable (or its alias) is among objs' leaves
    while a capture runs: the JAX package's test for a jax Tracer."""
    from ..static import program as _prog
    if not _prog._capturing():
        return False
    return any(isinstance(leaf, torch.Tensor)
               and _prog._var_of(leaf) is not None
               for leaf in pytree.tree_leaves(objs))


def _as_bool(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(plain(x).detach().reshape(()).item())
    return bool(x)


def _as_var(x):
    """x as a Variable of the program being captured: a Variable (or an
    alias of one) as itself, a constant tensor or Python number through
    an "assign" op of its value."""
    from ..static import program as _prog
    if isinstance(x, torch.Tensor):
        v = _prog._var_of(x)
        if v is not None:
            return v
        value = plain(x).detach()
    elif isinstance(x, (bool, int, float, np.number, np.bool_)):
        value = torch.as_tensor(x)
    else:
        raise TypeError(f"control flow under static capture: a branch or "
                        f"loop value is a {type(x).__name__}, not a tensor")
    out = _prog._record("assign", lambda c: c.clone(), (value,), {})
    return _prog._var_of(out)


def _as_vars(out):
    return pytree.tree_map(_as_var, out)


def while_loop(cond: Callable, body: Callable, loop_vars: Sequence,
               is_test=False, name=None) -> List:
    """reference: layers/control_flow.py while_loop:1075 / while_op.cc.
    Eager: a Python loop. Under capture: one "while" op."""
    if _is_traced(loop_vars):
        from ..static import nn as snn

        def body_vars(*a):
            out = body(*a)
            return [_as_var(o) for o in
                    (out if isinstance(out, (tuple, list)) else [out])]
        return list(snn.while_loop(lambda *a: _as_var(cond(*a)), body_vars,
                                   [_as_var(v) for v in loop_vars]))
    lv = [_wrap(v) for v in loop_vars]
    while _as_bool(cond(*lv)):
        out = body(*lv)
        lv = list(out) if isinstance(out, (tuple, list)) else [out]
        lv = [_wrap(v) for v in lv]
    return lv


def cond(pred, true_fn=None, false_fn=None, name=None, *, operands=()):
    """reference: layers/control_flow.py cond:2334 /
    conditional_block_op.cc. Under capture both branches must return
    matching structures (the reference's requirement that both branches
    produce the same out vars)."""
    p = _wrap(pred)
    ops_ = [_wrap(o) for o in operands]
    if _is_traced(p, ops_):
        from ..static import nn as snn

        def branch(fn):
            return lambda: _as_vars(fn(*ops_) if ops_ else fn())
        return snn.cond(_as_var(p), branch(true_fn), branch(false_fn))
    if _as_bool(p):
        return true_fn(*ops_) if ops_ else true_fn()
    return false_fn(*ops_) if ops_ else false_fn()


def case(pred_fn_pairs, default=None, name=None):
    """reference: layers/control_flow.py case:2914: the first true pred
    wins."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must not be empty")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if not rest:
        if default is None:
            return cond(pred, fn, fn)
        return cond(pred, fn, default)
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """reference: layers/control_flow.py switch_case:3129: dispatch on an
    integer index (one "switch_case" op under capture)."""
    idx = _wrap(branch_index)
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = list(enumerate(branch_fns)) \
            if not isinstance(branch_fns[0], (tuple, list)) \
            else sorted(branch_fns)
    keys = [k for k, _ in items]
    fns = [f for _, f in items]
    if default is None:
        default = fns[-1]
    if not _is_traced(idx):
        i = int(plain(idx).reshape(()).item())
        for k, f in items:
            if i == k:
                return f()
        return default()
    # a dense table over the key range; unknown keys and indices out of
    # the range take default (the JAX package's lax.switch table)
    table = {k: f for k, f in items}
    lo, hi = min(keys), max(keys)
    branches = [table.get(k, default) for k in range(lo, hi + 1)]
    branches.append(default)
    return _switch_op(_as_var(idx), lo, hi, branches)


def _switch_op(iv, lo: int, hi: int, branches):
    """One "switch_case" op of the current program over the branches'
    sub-programs (static/nn.py's helpers)."""
    from ..static import nn as snn
    from ..static.program import default_main_program
    prog = default_main_program()
    blk = prog.current_block()
    subs = [snn._capture_subprogram(lambda f=f: _as_vars(f()), [])
            for f in branches]
    outs, tree = subs[0][1], subs[0][2]
    if any(len(s[1]) != len(outs) for s in subs):
        raise ValueError("switch_case: every branch must return the same "
                         "structure (reference switch_case requirement)")
    free = list(dict.fromkeys(n for s in subs for n in snn._free_vars(s[0])))
    table = [(list(s[0].global_block.ops), dict(s[0]._consts),
              [v.name for v in s[1]]) for s in subs]

    def switch_fn(index, *freevals):
        i = int(index.reshape(()))
        ops, consts, names = table[i - lo if lo <= i <= hi else -1]
        env = snn._run_sub(ops, consts, free, freevals)
        return tuple(env[n] for n in names)

    return snn._outputs(blk, prog, "switch_case.out", outs, "switch_case",
                        switch_fn, [iv.name] + free, tree)
