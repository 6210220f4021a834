"""Static-graph automatic mixed precision (port of paddle_tpu/static/
amp.py; reference: contrib/mixed_precision/fp16_utils.py
rewrite_program and decorator.py decorate).

rewrite_program wraps each recorded op's closure by its type, with the
JAX package's lists: white-listed ops (matmuls, linear, conv,
scaled_dot_product_attention, embedding lookups) take their float32
tensor inputs in bfloat16 (or float16), black-listed ops (softmax,
cross-entropy, reductions, the norms) take low-precision inputs back
in float32, and the rest run on what arrives. Parameters stay float32
in the Scope: that is the master-weight scheme (float32 masters,
low-precision compute). On the GPT's path the white-listed
`scaled_dot_product_attention` therefore gets bf16 q/k/v and launches
K1's bf16 kernels.

decorate's OptimizerWithMixedPrecision records the loss scaling: a
scaled loss, the backward of it, one check_finite_and_unscale op (the
gradients back to float32, unscaled, and a found_inf flag), the dynamic
loss-scale state machine as one op over three persistables, and the
optimizer's update ops gated on found_inf. The flag stays on the
device: nothing here reads it on the host.

Left out: `custom_black_varnames`, `use_pure_fp16` and
`use_fp16_guard` are accepted and ignored, as in the JAX package.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import _pytree as pytree

from .program import OpDesc, default_startup_program

__all__ = ["AutoMixedPrecisionLists", "bf16_lists", "rewrite_program",
           "decorate", "OptimizerWithMixedPrecision"]


class AutoMixedPrecisionLists:
    """reference: fp16_lists.py AutoMixedPrecisionLists."""

    white_list = {
        "matmul", "matmul_v2", "mul", "bmm", "einsum", "linear", "fc",
        "conv2d", "conv3d", "depthwise_conv2d", "conv2d_transpose",
        "scaled_dot_product_attention", "lookup_table", "lookup_table_v2",
    }
    black_list = {
        "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
        "softmax_with_cross_entropy", "softmax_with_cross_entropy_keepdim",
        "sigmoid_cross_entropy_with_logits", "cross_entropy",
        "cross_entropy2", "cross_entropy_probs", "reduce_mean",
        "reduce_sum", "layer_norm", "batch_norm_train", "batch_norm_infer",
        "log_softmax", "nll_loss", "bce_loss", "bce_with_logits",
        "mse_loss", "l1_loss",
    }

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(self.white_list)
        self.black_list = set(self.black_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
        overlap = self.white_list & self.black_list
        if overlap:
            raise ValueError(f"ops in both white and black lists: {overlap}")


bf16_lists = AutoMixedPrecisionLists  # paddle.static.amp.bf16's name


def _cast_leaves(args, src, dst):
    def cast(a):
        if isinstance(a, torch.Tensor) and a.dtype in src:
            return a.to(dst)
        return a
    return [pytree.tree_map(cast, a) for a in args]


def rewrite_program(program, amp_lists=None, dest_dtype="bfloat16"):
    """reference: fp16_utils.py rewrite_program: every recorded forward
    op's closure computes white-listed ops in dest_dtype and pins
    black-listed ones to float32."""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    low = torch.bfloat16 if dest_dtype in ("bfloat16", "bf16") \
        else torch.float16
    for od in program.global_block.ops:
        if od.kind != "op" or od.fn is None:
            continue
        if od.op_type in amp_lists.white_list:
            od.fn = _wrap_cast(od.fn, (torch.float32,), low)
        elif od.op_type in amp_lists.black_list:
            od.fn = _wrap_cast(od.fn, (torch.bfloat16, torch.float16),
                               torch.float32)
    return program


def _wrap_cast(fn, src, dst):
    @functools.wraps(fn)
    def wrapped(*xs):
        return fn(*_cast_leaves(xs, src, dst))
    return wrapped


def _unscale(*vals):
    """check_finite_and_unscale (paddle_tpu/ops/amp_ops.py:24-32) over
    the gradients made float32: (unscaled..., found_inf)."""
    gs, scale = vals[:-1], vals[-1].float()
    inv = 1.0 / scale
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for g in gs:
        g = g.float()
        found = found | ~torch.isfinite(g).all()
        outs.append(g * inv)
    return tuple(outs) + (found,)


def _update_scaling(found, scale, good, bad, incr_every_n, decr_every_n,
                    incr_ratio, decr_ratio):
    """update_loss_scaling (paddle_tpu/ops/amp_ops.py:43-72) as selects
    on the device: after decr_every_n overflows the scale shrinks
    (clamped at 1), after incr_every_n good steps it grows (kept when
    the growth overflows)."""
    zg, zb = torch.zeros_like(good), torch.zeros_like(bad)
    new_bad, new_good = bad + 1, good + 1
    decay = new_bad >= decr_every_n
    inf_scale = torch.where(decay, torch.clamp(scale * decr_ratio, min=1.0),
                            scale)
    inf_bad = torch.where(decay, zb, new_bad)
    bump = new_good >= incr_every_n
    grown = scale * incr_ratio
    ok_scale = torch.where(bump & torch.isfinite(grown), grown, scale)
    ok_good = torch.where(bump, zg, new_good)
    return (torch.where(found, inf_scale, ok_scale),
            torch.where(found, zg, ok_good),
            torch.where(found, inf_bad, zb))


class OptimizerWithMixedPrecision:
    """reference: decorator.py OptimizerWithMixedPrecision: an optimizer
    with loss scaling over the rewritten program."""

    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 dest_dtype):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = bool(use_dynamic_loss_scaling)
        self._incr_every_n = int(incr_every_n_steps)
        self._decr_every_n = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._dest_dtype = dest_dtype
        self._loss_scaling_var = None

    def get_loss_scaling(self):
        return self._loss_scaling_var

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        from . import backward as _B
        prog = loss.block.program
        blk = prog.global_block
        startup = startup_program or default_startup_program()

        rewrite_program(prog, self._amp_lists, self._dest_dtype)

        def persistable(name, value, dtype):
            v = blk.create_var(name=name, shape=(), dtype=dtype,
                               persistable=True)
            startup.global_block.create_var(name=name, shape=(),
                                            dtype=dtype, persistable=True)
            startup.global_block.append_op(OpDesc(
                "init", "fill_constant",
                lambda device, _v=value, _d=dtype: torch.tensor(
                    _v, dtype=_d, device=device), [], [name]))
            return v

        scale_v = persistable(prog.unique_name("loss_scaling"),
                              self._init_loss_scaling, torch.float32)
        good_v = persistable(prog.unique_name("good_steps"), 0, torch.int32)
        bad_v = persistable(prog.unique_name("bad_steps"), 0, torch.int32)
        self._loss_scaling_var = scale_v

        scaled = blk.create_var(name=prog.unique_name("scaled_loss"),
                                shape=loss.shape, dtype="float32",
                                stop_gradient=False)
        blk.append_op(OpDesc("op", "elementwise_mul",
                             lambda l, s: l.float() * s,
                             [loss.name, scale_v.name], [scaled.name]))

        params_grads = _B.append_backward(scaled, parameters, no_grad_set)

        gnames = [g.name for _, g in params_grads]
        found_v = blk.create_var(name=prog.unique_name("found_inf"),
                                 shape=(), dtype="bool")
        blk.append_op(OpDesc("op", "check_finite_and_unscale", _unscale,
                             gnames + [scale_v.name],
                             gnames + [found_v.name]))

        if self._use_dynamic:
            blk.append_op(OpDesc(
                "op", "update_loss_scaling", functools.partial(
                    _update_scaling_op, args=(
                        self._incr_every_n, self._decr_every_n,
                        self._incr_ratio, self._decr_ratio)),
                [found_v.name, scale_v.name, good_v.name, bad_v.name],
                [scale_v.name, good_v.name, bad_v.name]))

        return self._optimizer._static_minimize(
            scaled, startup_program=startup, parameters=parameters,
            no_grad_set=no_grad_set, params_grads=params_grads,
            found_inf=found_v)


def _update_scaling_op(found, scale, good, bad, args):
    return _update_scaling(found, scale, good, bad, *args)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5,
             use_dynamic_loss_scaling=True, dest_dtype="bfloat16",
             use_pure_fp16=False, use_fp16_guard=None):
    """reference: decorator.py decorate: the wrapped optimizer; call
    .minimize(loss) as usual."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio,
        decr_ratio, dest_dtype)
