"""append_backward and gradients for static programs (port of
paddle_tpu/static/backward.py).

Each appends ONE `backward` OpDesc. The JAX Executor differentiates a
re-interpretation of the recorded forward with jax.grad and XLA merges
the two copies; the port's Executor runs the forward once, on an
autograd graph over the parameters (or the gradients() inputs), and
the backward op is torch.autograd.grad on that graph, so no forward op
runs twice. Gradient Variables are named '<param>@GRAD'.

Left out: append_backward's `callbacks` (accepted and ignored, as in
the JAX package).
"""
from __future__ import annotations

from .program import OpDesc, Variable

__all__ = ["append_backward", "gradients"]


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """[(param_var, grad_var)] (reference: backward.py append_backward)."""
    if not isinstance(loss, Variable):
        raise TypeError("append_backward expects a static Variable loss; "
                        "got a dygraph Tensor (call loss.backward() there)")
    prog = loss.block.program
    blk = prog.global_block
    if parameter_list:
        params = [blk.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in prog.all_parameters()
                  if getattr(p, "trainable", True)]
    if no_grad_set:
        drop = {n if isinstance(n, str) else n.name for n in no_grad_set}
        params = [p for p in params if p.name not in drop]
    if not params:
        raise ValueError("append_backward found no trainable parameters")

    pnames = [p.name for p in params]
    grad_vars = [blk.create_var(name=p.name + "@GRAD", shape=p.shape,
                                dtype=p.dtype, stop_gradient=True)
                 for p in params]
    blk.append_op(OpDesc("backward", "backward", None, [loss.name] + pnames,
                         [g.name for g in grad_vars],
                         payload=(loss.name, pnames)))
    return list(zip(params, grad_vars))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of (several, possibly non-scalar) targets with respect
    to any inputs (reference: backward.py calc_gradient).
    target_gradients are the targets' cotangents (ones when None); the
    targets' contributions add up. The result is aligned with `inputs`
    (None for an input in no_grad_set, which also passes no gradient
    through)."""
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    target_gradients = list(target_gradients) if isinstance(
        target_gradients, (list, tuple)) else [target_gradients]
    if len(target_gradients) != len(targets):
        raise ValueError(
            f"target_gradients length {len(target_gradients)} != "
            f"targets length {len(targets)} (reference calc_gradient "
            "same contract)")
    prog = targets[0].block.program
    blk = prog.global_block
    drop = ({n if isinstance(n, str) else n.name for n in no_grad_set}
            if no_grad_set else set())
    diff_inputs = [v for v in inputs if v.name not in drop]
    inames = [v.name for v in diff_inputs]
    tnames = [t.name for t in targets]
    tg_names = [None if tg is None else tg.name for tg in target_gradients]
    grad_vars = []
    for v in diff_inputs:
        gname = v.name + "@GRAD"
        n = 0
        while blk.has_var(gname):  # repeated gradients() calls must not
            gname = f"{v.name}@GRAD_{n}"  # clobber earlier grad vars
            n += 1
        grad_vars.append(blk.create_var(name=gname, shape=v.shape,
                                        dtype=v.dtype, stop_gradient=True))
    dep_tgs = [n for n in tg_names if n is not None]
    blk.append_op(OpDesc(
        "backward", "backward", None, tnames + inames + dep_tgs,
        [g.name for g in grad_vars],
        payload=("vjp", tnames, inames, tg_names, sorted(drop))))
    by_name = dict(zip(inames, grad_vars))
    return [by_name.get(v.name) for v in inputs]
