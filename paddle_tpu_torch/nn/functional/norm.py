"""layer_norm, batch_norm and batch_norm_act (port of paddle_tpu/nn/
functional/norm.py).

layer_norm: statistics and the scale/shift math run in f32 and the
result comes back in x's dtype, the JAX package's numerics for
low-precision activations: torch's layer_norm does exactly that for
bf16 inputs on CUDA and computes in x's own f32 on the CPU.

Batch norm keeps the JAX package's recipe, which neither torch's
batch_norm nor its running-stat update computes:
- `_fold` / `_apply_scale_shift` (norm.py:43-60): the per-channel scale
  and shift are computed in f32 (f64 for f64 inputs), then applied in
  x's own dtype, so under AMP O2 the full-tensor pass stays bf16;
- `_bn_stats` (:68-81): bf16/f16 inputs take one pass of
  E[x^2] - E[x]^2 accumulated in f32, with no f32 copy of x;
- `_BNCore` (`_bn_core`, :84-146) is an autograd Function whose backward
  is the affine dx = a*gy + k*x + m with per-channel f32 a, k, m;
- `_BNActCore` (`_bn_act_core`, :177-220) is relu(bn(x) (+ z)) saving
  only x and z: the backward recomputes the relu mask from the same
  fold as the forward and sums dz back to a broadcast z;
- `_update_running_stats` (:249-271): running = momentum * running +
  (1 - momentum) * batch with the biased batch variance, REBINDING the
  buffer to the result's dtype as the JAX package does, so buffers cast
  to bf16 by amp.decorate(level="O2") become f32 after the first
  training step (bf16 * float stays bf16, + the f32 batch stat
  promotes). The rebinding goes through `.data`, so the module's buffer
  entry stays the same tensor object.

Both Functions run inside a `batch_norm` profiler range (forward and
backward), which tools/train_bench.py --profile reads. Neither is a TPU
kernel in the JAX package (XLA fused them), so they stay plain torch.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...core.dispatch import op

__all__ = ["layer_norm", "batch_norm", "batch_norm_act"]


@op("layer_norm")
def _layer_norm(x, normalized_shape, weight, bias, epsilon):
    return F.layer_norm(x, normalized_shape, weight, bias, epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return _layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def _channel_axis(x, data_format) -> int:
    """The channel axis under a Paddle data_format string; 2-D inputs are
    [N, C] whatever the tag."""
    if x.ndim == 2:
        return 1
    return x.ndim - 1 if data_format in ("NHWC", "NLC", "NDHWC") else 1


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _bshape(x, c_axis):
    shape = [1] * x.ndim
    shape[c_axis] = x.shape[c_axis]
    return shape


def _fold(x, mean, var, weight, bias, eps):
    """Per-channel (scale, shift) in f32 (f64 for f64 x)."""
    f = _acc_dtype(x)
    scale = torch.rsqrt(var.to(f) + eps)
    if weight is not None:
        scale = scale * weight.to(f)
    shift = -mean.to(f) * scale
    if bias is not None:
        shift = shift + bias.to(f)
    return scale, shift


def _apply_scale_shift(x, mean, var, weight, bias, eps, c_axis):
    """x * scale + shift with the f32 fold cast to x's dtype."""
    scale, shift = _fold(x, mean, var, weight, bias, eps)
    shape = _bshape(x, c_axis)
    return (x * scale.to(x.dtype).reshape(shape)
            + shift.to(x.dtype).reshape(shape))


def _bn_stats(x, axes):
    """Biased batch mean and variance over `axes`, in f32 for low-precision
    x (one pass, f32 accumulation of x and of x*x in x's dtype)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        mean = torch.mean(x, dim=axes, dtype=torch.float32)
        mean_sq = torch.mean(x * x, dim=axes, dtype=torch.float32)
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    else:
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, correction=0)
    return mean, var


def _axes(x, c_axis):
    return tuple(i for i in range(x.ndim) if i != c_axis)


def _bn_core_bwd(x, weight, bias, mean, var, eps, c_axis, gy, g_mean,
                 g_var):
    """(dx, dweight, dbias) of bn(x) = x * scale + shift under batch stats:
    per-channel reductions accumulate in f32, and the full-tensor pass is
    affine in x, dx = a * gy + k * x + m, in the activation dtype."""
    f = _acc_dtype(x)
    axes = _axes(x, c_axis)
    n = 1
    for i in axes:
        n *= x.shape[i]
    shape = _bshape(x, c_axis)
    inv = torch.rsqrt(var.to(f) + eps)
    gysum = torch.sum(gy, dim=axes, dtype=f)
    gxsum = torch.sum(gy * x, dim=axes, dtype=f)
    mean_f = mean.to(f)
    dgamma = (gxsum - mean_f * gysum) * inv
    dbeta = gysum
    a = inv if weight is None else weight.to(f) * inv
    k = -a * dgamma * inv / n
    m = -a * dbeta / n - k * mean_f
    # cotangents of the mean/var outputs (zeros when only the running
    # stats read them, which is the usual case)
    k = k + 2.0 * g_var.to(f) / n
    m = m - 2.0 * g_var.to(f) * mean_f / n + g_mean.to(f) / n
    dx = (gy * a.to(gy.dtype).reshape(shape)
          + x * k.to(x.dtype).reshape(shape)
          + m.to(x.dtype).reshape(shape)).to(x.dtype)
    dw = None if weight is None else dgamma.to(weight.dtype)
    db = None if bias is None else dbeta.to(bias.dtype)
    return dx, dw, db


class _BNCore(torch.autograd.Function):
    """bn(x) under batch statistics -> (out, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, c_axis):
        with torch.profiler.record_function("batch_norm"):
            mean, var = _bn_stats(x, _axes(x, c_axis))
            out = _apply_scale_shift(x, mean, var, weight, bias, eps, c_axis)
        ctx.save_for_backward(x, weight, bias, mean, var)
        ctx.eps, ctx.c_axis = eps, c_axis
        return out, mean, var

    @staticmethod
    def backward(ctx, gy, g_mean, g_var):
        x, weight, bias, mean, var = ctx.saved_tensors
        with torch.profiler.record_function("batch_norm"):
            dx, dw, db = _bn_core_bwd(x, weight, bias, mean, var, ctx.eps,
                                      ctx.c_axis, gy, g_mean, g_var)
        return dx, dw, db, None, None


def _sum_to(g, shape):
    """g summed back to a shape it was broadcast from."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    lead = g.ndim - len(shape)
    axes = tuple(range(lead)) + tuple(
        lead + i for i, d in enumerate(shape)
        if d == 1 and g.shape[lead + i] != 1)
    return torch.sum(g, dim=axes).reshape(shape)


class _BNActCore(torch.autograd.Function):
    """relu(bn(x) (+ z)) under batch statistics -> (out, mean, var); z may
    be None or broadcast to x's shape."""

    @staticmethod
    def forward(ctx, x, z, weight, bias, eps, c_axis):
        with torch.profiler.record_function("batch_norm"):
            mean, var = _bn_stats(x, _axes(x, c_axis))
            out = _apply_scale_shift(x, mean, var, weight, bias, eps, c_axis)
            if z is not None:
                out = out + z
            out = torch.relu(out)
        ctx.save_for_backward(x, z, weight, bias, mean, var)
        ctx.eps, ctx.c_axis = eps, c_axis
        return out, mean, var

    @staticmethod
    def backward(ctx, gy, g_mean, g_var):
        x, z, weight, bias, mean, var = ctx.saved_tensors
        with torch.profiler.record_function("batch_norm"):
            # the pre-relu value, recomputed with the forward's fold so
            # the mask is the forward's bit for bit
            pre = _apply_scale_shift(x, mean, var, weight, bias, ctx.eps,
                                     ctx.c_axis)
            if z is not None:
                pre = pre + z
            gym = torch.where(pre > 0, gy, torch.zeros((), dtype=gy.dtype,
                                                       device=gy.device))
            del pre
            dz = None if z is None else _sum_to(gym, z.shape).to(z.dtype)
            dx, dw, db = _bn_core_bwd(x, weight, bias, mean, var, ctx.eps,
                                      ctx.c_axis, gym, g_mean, g_var)
        return dx, dz, dw, db, None, None


@torch.no_grad()
def _update_running_stats(running_mean, running_var, mean, var, momentum):
    """running = momentum * running + (1 - momentum) * batch (biased var),
    rebound to the result's dtype (see the module docstring)."""
    if running_mean is None:
        return
    running_mean.data = momentum * running_mean + (1 - momentum) * mean
    running_var.data = momentum * running_var + (1 - momentum) * var


def _use_stats(training, use_global_stats):
    return (not training) if use_global_stats is None else use_global_stats


class _Stats:
    """The running mean and variance, handed to the ops in a holder the
    AMP hook does not cast (their EMA rebinds the buffers in place)."""

    __slots__ = ("mean", "var")

    def __init__(self, mean, var):
        self.mean, self.var = mean, var


@op("batch_norm_infer")
def _bn_infer(x, stats, weight, bias, epsilon, c_axis, add, act):
    out = _apply_scale_shift(x, stats.mean, stats.var, weight, bias,
                             epsilon, c_axis)
    if add is not None:
        out = out + add
    return torch.relu(out) if act else out


@op("batch_norm_train")
def _bn_train(x, stats, weight, bias, momentum, epsilon, c_axis):
    out, mean, var = _BNCore.apply(x, weight, bias, epsilon, c_axis)
    _update_running_stats(stats.mean, stats.var, mean, var, momentum)
    return out


@op("fused_bn_add_act_train")
def _bn_act_train(x, stats, weight, bias, momentum, epsilon, c_axis, add):
    out, mean, var = _BNActCore.apply(x, add, weight, bias, epsilon, c_axis)
    _update_running_stats(stats.mean, stats.var, mean, var, momentum)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Paddle's batch_norm: batch statistics (and the running-stat EMA)
    when training or use_global_stats is False, else the running stats;
    use_global_stats=None follows `training`."""
    c_axis = _channel_axis(x, data_format)
    stats = _Stats(running_mean, running_var)
    if _use_stats(training, use_global_stats):
        return _bn_infer(x, stats, weight, bias, epsilon, c_axis, None,
                         False)
    return _bn_train(x, stats, weight, bias, momentum, epsilon, c_axis)


def batch_norm_act(x, running_mean, running_var, weight=None, bias=None,
                   training=False, momentum=0.9, epsilon=1e-5,
                   data_format="NCHW", add=None, use_global_stats=None,
                   name=None):
    """relu(batch_norm(x) (+ add)) with the residual-light backward; the
    statistics follow batch_norm's rule exactly."""
    c_axis = _channel_axis(x, data_format)
    stats = _Stats(running_mean, running_var)
    if _use_stats(training, use_global_stats):
        return _bn_infer(x, stats, weight, bias, epsilon, c_axis, add, True)
    return _bn_act_train(x, stats, weight, bias, momentum, epsilon, c_axis,
                         add)
