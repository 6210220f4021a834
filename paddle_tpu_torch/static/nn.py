"""paddle.static.nn, the static-graph layer functions (port of
paddle_tpu/static/nn.py).

fc, embedding, conv2d and batch_norm create their parameters in the
default programs (static/program.py create_parameter) and call the
port's functionals, which the capture records. persistable_buffer,
static_assign and create_global_var make and write persistables.

Control flow records sub-programs: cond, while_loop, case and
switch_case capture each branch or body into a Program of its own, and
one op of the outer program runs them (the JAX package lowers them to
lax.cond / lax.while_loop inside its compiled program; the port's
Executor reads the predicate on the host and runs the chosen branch,
or the body while the condition holds, eagerly on the device). The
sub-programs read the outer Variables they use by name.

dropout records one op that draws a fresh mask at every run.

Left out: nothing of the JAX module; `is_sparse` of embedding and
`force_cpu` of create_global_var are accepted and ignored, as there.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import dtypes as _dt
from ..core.tensor import Tensor, plain
from .program import (OpDesc, Program, Variable, _record, _user_level,
                      create_parameter, default_main_program,
                      default_startup_program, program_guard)

__all__ = ["fc", "embedding", "conv2d", "batch_norm", "dropout",
           "persistable_buffer", "static_assign", "create_global_var",
           "cond", "while_loop", "case", "switch_case", "StaticRNN",
           "DynamicRNN", "py_reader", "read_file"]


def _flatten_to_2d(x, num_flatten_dims):
    from ..ops import manipulation as M
    if x.ndim == 2 and num_flatten_dims == 1:
        return x
    lead = int(np.prod([d for d in x.shape[:num_flatten_dims]]))
    tail = int(np.prod([d for d in x.shape[num_flatten_dims:]]))
    return M.reshape(x, [lead if lead > 0 else -1, tail])


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """reference: python/paddle/static/nn/common.py fc."""
    from ..nn import initializer as I
    from ..nn.layer.base import ParamAttr
    from ..ops import linalg as L
    in_dim = int(np.prod([d for d in x.shape[num_flatten_dims:]]))
    wa = weight_attr if isinstance(weight_attr, ParamAttr) else ParamAttr()
    w = create_parameter([in_dim, size], x.dtype, name=wa.name,
                         initializer=wa.initializer, trainable=wa.trainable)
    x2 = _flatten_to_2d(x, num_flatten_dims)
    out = L.matmul(x2, w)
    if bias_attr is not False:
        ba = bias_attr if isinstance(bias_attr, ParamAttr) else ParamAttr()
        b = create_parameter([size], x.dtype, name=ba.name,
                             initializer=ba.initializer or I.Constant(0.0),
                             trainable=ba.trainable)
        out = out + b
    if activation:
        from ..nn import functional as F
        out = getattr(F, activation)(out)
    if num_flatten_dims != 1 or x.ndim != 2:
        from ..ops import manipulation as M
        out = M.reshape(out, [d for d in x.shape[:num_flatten_dims]] + [size])
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """reference: static/nn embedding (lookup_table_v2)."""
    from ..nn import functional as F
    from ..nn import initializer as I
    from ..nn.layer.base import ParamAttr
    pa = param_attr if isinstance(param_attr, ParamAttr) else ParamAttr()
    w = create_parameter(list(size), dtype, name=pa.name,
                         initializer=pa.initializer or I.XavierNormal(),
                         trainable=pa.trainable)
    return F.embedding(input, w, padding_idx=padding_idx)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    """reference: fluid/layers/nn.py conv2d."""
    from ..nn import functional as F
    from ..nn import initializer as I
    from ..nn.layer.base import ParamAttr
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    c_in = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    pa = param_attr if isinstance(param_attr, ParamAttr) else ParamAttr()
    w = create_parameter(
        [num_filters, c_in // groups] + list(filter_size), input.dtype,
        name=pa.name, initializer=pa.initializer or I.KaimingNormal(),
        trainable=pa.trainable)
    b = None
    if bias_attr is not False:
        ba = bias_attr if isinstance(bias_attr, ParamAttr) else ParamAttr()
        b = create_parameter([num_filters], input.dtype, name=ba.name,
                             initializer=ba.initializer or I.Constant(0.0),
                             trainable=ba.trainable)
    out = F.conv2d(input, w, bias=b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    if act:
        out = getattr(F, act)(out)
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None):
    """reference: fluid/layers/nn.py batch_norm (the running statistics
    are persistables the recorded op updates in place)."""
    from ..nn import functional as F
    from ..nn import initializer as I
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype
    scale = create_parameter([c], dtype, initializer=I.Constant(1.0))
    bias = create_parameter([c], dtype, initializer=I.Constant(0.0))
    mean = persistable_buffer(torch.zeros(c, dtype=dtype), "bn_mean")
    var = persistable_buffer(torch.ones(c, dtype=dtype), "bn_var")
    out = F.batch_norm(input, mean, var, weight=scale, bias=bias,
                       training=not is_test, momentum=momentum,
                       epsilon=epsilon, data_format=data_layout)
    if act:
        out = getattr(F, act)(out)
    return out


def _dropout(x, p, upscale):
    keep = torch.rand(x.shape, device=x.device) >= p
    out = x * keep.to(x.dtype)
    return out / (1.0 - p) if upscale else out


def dropout(x, dropout_prob=0.5, is_test=False, name=None):
    """reference: fluid/layers/nn.py dropout (upscale_in_train): one
    "dropout" op that draws its mask at every run."""
    from ..nn import functional as F
    if is_test or dropout_prob == 0.0 or not isinstance(x, Variable):
        return F.dropout(x, p=dropout_prob, training=not is_test)
    return _record("dropout", _dropout, (x, float(dropout_prob), True), {})


def _as_cpu(value, dtype=None) -> torch.Tensor:
    if torch.is_tensor(value):
        t = plain(value).detach().cpu()
    else:
        a = np.asarray(value)
        t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def persistable_buffer(value, prefix="buffer", name=None):
    """A persistable (non-parameter) Variable whose startup value is
    `value`: the static home of running statistics and counters."""
    main = default_main_program()
    startup = default_startup_program()
    value = _as_cpu(value)
    name = name or main.unique_name(prefix)
    v = main.global_block.create_var(name=name, shape=tuple(value.shape),
                                     dtype=value.dtype, persistable=True)
    startup.global_block.create_var(name=name, shape=tuple(value.shape),
                                    dtype=value.dtype, persistable=True)
    startup.global_block.append_op(OpDesc(
        "init", "fill_buffer",
        lambda device, _v=value: _v.to(device, copy=True), [], [name]))
    return v


def static_assign(target: Variable, value):
    """Record an op that rebinds `target`'s name to `value` (the static
    form of an in-place buffer write)."""
    target.block.append_op(OpDesc("op", "assign_out", lambda v: v,
                                  [value.name], [target.name]))
    return target


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """reference: fluid/layers/tensor.py create_global_var."""
    arr = torch.full(tuple(shape), value, dtype=_dt.convert_dtype(dtype))
    return persistable_buffer(arr, name=name or None, prefix="global_var")


# ------------------------------------------------------------- control flow
def _capture_subprogram(fn, arg_vars):
    """Capture `fn` over fresh Variables (named as `arg_vars`) into a
    sub-Program: (sub_program, flat outputs, output structure)."""
    sub = Program()
    with program_guard(sub):
        blk = sub.global_block
        inner = [blk.create_var(name=v.name, shape=v.shape, dtype=v.dtype)
                 for v in arg_vars]
        out = fn(*inner) if inner else fn()
    flat, tree = pytree.tree_flatten(out)
    return sub, flat, tree


def _free_vars(sub, bound=()):
    """Inputs of the sub-program's ops that none of its ops produce."""
    produced = set(sub._consts) | set(bound)
    free = []
    for od in sub.global_block.ops:
        for n in od.input_names:
            if n not in produced and n not in free:
                free.append(n)
        produced.update(od.output_names)
    return free


def _run_sub(ops, consts, free, freevals, extra=()):
    from .executor import _interpret
    device = freevals[0].device if freevals else torch.device("cpu")
    env = {k: v.to(device) for k, v in consts.items()}
    env.update(zip(free, freevals))
    env.update(extra)
    return _interpret(ops, env, device, grad=torch.is_grad_enabled())


def _outputs(blk, prog, prefix, like, op_type, fn, in_names, tree=None):
    outs = [blk.create_var(name=prog.unique_name(prefix),
                           shape=tuple(v.shape), dtype=v.dtype)
            for v in like]
    blk.append_op(OpDesc("op", op_type, fn, in_names,
                         [v.name for v in outs]))
    if not _user_level():
        outs = [v._static_meta for v in outs]
    return outs if tree is None else pytree.tree_unflatten(outs, tree)


def cond(pred, true_fn=None, false_fn=None, name=None):
    """reference: control_flow.py cond (conditional_block_op.cc)."""
    prog = default_main_program()
    blk = prog.current_block()
    true_sub, t_out, t_tree = _capture_subprogram(true_fn, [])
    false_sub, f_out, _ = _capture_subprogram(false_fn, [])
    if len(t_out) != len(f_out):
        raise ValueError("cond: true_fn and false_fn must return the same "
                         "structure (reference cond requirement)")
    free = list(dict.fromkeys(_free_vars(true_sub) + _free_vars(false_sub)))
    branches = (
        (list(false_sub.global_block.ops), dict(false_sub._consts),
         [v.name for v in f_out]),
        (list(true_sub.global_block.ops), dict(true_sub._consts),
         [v.name for v in t_out]))

    def cond_fn(predv, *freevals):
        ops, consts, names = branches[bool(predv.reshape(()))]
        env = _run_sub(ops, consts, free, freevals)
        return tuple(env[n] for n in names)

    return _outputs(blk, prog, "cond.out", t_out, "conditional_block",
                    cond_fn, [pred.name] + free, t_tree)


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """reference: control_flow.py while_loop (while_op.cc)."""
    prog = default_main_program()
    blk = prog.current_block()
    loop_vars = list(loop_vars)
    c_sub, c_out, _ = _capture_subprogram(lambda *a: cond_fn(*a), loop_vars)
    b_sub, b_out, _ = _capture_subprogram(lambda *a: body_fn(*a), loop_vars)
    if len(b_out) != len(loop_vars):
        raise ValueError("while_loop body must return the same number of "
                         "vars as loop_vars")
    lnames = [v.name for v in loop_vars]
    free = list(dict.fromkeys(_free_vars(c_sub, lnames)
                              + _free_vars(b_sub, lnames)))
    c_ops, c_consts = list(c_sub.global_block.ops), dict(c_sub._consts)
    b_ops, b_consts = list(b_sub.global_block.ops), dict(b_sub._consts)
    c_name = c_out[0].name
    b_names = [v.name for v in b_out]

    def while_fn(*args):
        carry = list(args[:len(lnames)])
        freevals = list(args[len(lnames):])
        while True:
            env = _run_sub(c_ops, c_consts, free, freevals + carry,
                           zip(lnames, carry))
            if not bool(env[c_name].reshape(())):
                return tuple(carry)
            env = _run_sub(b_ops, b_consts, free, freevals + carry,
                           zip(lnames, carry))
            carry = [env[n] for n in b_names]

    return _outputs(blk, prog, "while.out", loop_vars, "while", while_fn,
                    lnames + free)


def case(pred_fn_pairs, default=None, name=None):
    """reference: control_flow.py case (chained conds)."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if not rest:
        return cond(pred, fn, fn if default is None else default)
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """reference: control_flow.py switch_case."""
    pairs = [(branch_index == idx, fn) for idx, fn in (
        branch_fns.items() if isinstance(branch_fns, dict)
        else enumerate(branch_fns))]
    return case(pairs, default=default)


# block-style RNN authoring and the async reader (reference: fluid.layers
# StaticRNN / DynamicRNN / py_reader), re-exported where fluid.layers
# kept them
from .rnn_shims import (StaticRNN, DynamicRNN, py_reader,  # noqa: F401,E402
                        read_file)
