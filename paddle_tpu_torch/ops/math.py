"""Elementwise math, reductions and the cumulative ops (port of
paddle_tpu/ops/math.py), every public name in the reference's order and
under the JAX package's op types.

Promotion is torch's, which gives the rules the JAX package pins
(core/dtypes.py): Python scalars are weak (a Python number beside a
tensor becomes a 0-d tensor, which never widens a tensor of its own
kind), numpy scalars do not widen a tensor, and int/bool division gives
the default float dtype. "reduce_sum", "reduce_mean", "exp", "log",
"logsumexp", "cumsum" and "square" are on the AMP black list, so under
auto_cast they run in float32, as in the reference.

Where torch and the JAX package differ, the JAX package's rule holds:
- `round` and `rint` round half to even and `remainder` takes the
  divisor's sign (both packages agree);
- `logsumexp` and `cumsum` with axis None reduce or flatten all axes;
- `clip` with neither bound returns x; tensor bounds stay on the device;
- `max`/`min`/`amax`/`amin` spread the gradient evenly over ties
  (torch.amax), as jnp.max does;
- `cummax`'s index is the first position that attains each running
  maximum (torch.cummax takes the last);
- `outer` flattens its inputs, `real`/`imag` take real tensors too,
  `conj` returns a physical copy.
`take(mode="raise")` reads whether an index is out of range on the host,
as the JAX package does (ops/__init__.py HOST_READS).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import eager, op
from ..core.dtypes import convert_dtype
from ..core.tensor import wrap


def _weak_scalar(v) -> bool:
    # Python int/float (not bool, not numpy scalars) stay weak
    return isinstance(v, (int, float)) and not isinstance(
        v, (bool, np.generic))


def _tensor(v, like):
    """A Python number as a 0-d tensor on `like`'s device (its dtype
    then never widens `like`'s, as a weak scalar in the JAX package)."""
    if torch.is_tensor(v):
        return v
    return torch.tensor(v, device=like.device if torch.is_tensor(like)
                        else None)


def _binop(name, fn):
    wrapped = op(name)(fn)

    def api(x, y, name=None):
        if not _weak_scalar(x) or not torch.is_tensor(y):
            x = wrap(x, y)
        if not _weak_scalar(y) or not torch.is_tensor(x):
            y = wrap(y, x)
        return wrapped(x, y)
    api.__name__ = name
    return api


def _both(fn):
    """fn over two tensors: a Python number becomes a 0-d tensor."""
    return lambda x, y: fn(_tensor(x, y), _tensor(y, x))


# -- elementwise binary ------------------------------------------------------
add = _binop("elementwise_add", lambda x, y: torch.add(_tensor(x, y), y))
subtract = _binop("elementwise_sub", lambda x, y: torch.sub(_tensor(x, y), y))
multiply = _binop("elementwise_mul", lambda x, y: torch.mul(_tensor(x, y), y))
divide = _binop("elementwise_div",
                lambda x, y: torch.true_divide(_tensor(x, y), y))
floor_divide = _binop("elementwise_floordiv", _both(torch.floor_divide))
remainder = _binop("elementwise_mod", _both(torch.remainder))
mod = remainder
floor_mod = remainder
pow_ = _binop("elementwise_pow", lambda x, y: torch.pow(x, y))
maximum = _binop("elementwise_max", _both(torch.maximum))
minimum = _binop("elementwise_min", _both(torch.minimum))
fmax = _binop("elementwise_fmax", _both(torch.fmax))
fmin = _binop("elementwise_fmin", _both(torch.fmin))
atan2 = _binop("atan2", _both(torch.atan2))
hypot = _binop("hypot", _both(torch.hypot))
logaddexp = _binop("logaddexp", _both(torch.logaddexp))
nextafter = _binop("nextafter", _both(torch.nextafter))
copysign = _binop("copysign", _both(torch.copysign))
heaviside = _binop("elementwise_heaviside", _both(
    lambda x, y: torch.heaviside(x, y.to(x.dtype))))
gcd = _binop("gcd", _both(torch.gcd))
lcm = _binop("lcm", _both(torch.lcm))
inner = _binop("inner", _both(torch.inner))
outer = _binop("outer", _both(
    lambda x, y: torch.outer(torch.reshape(x, (-1,)),
                            torch.reshape(y, (-1,)))))
kron = _binop("kron", _both(torch.kron))


def pow(x, y, name=None):  # noqa: A001 - paddle api name
    return pow_(x, y)


def divide_no_nan(x, y, name=None):
    x = wrap(x, y)
    return _divide_no_nan(x, wrap(y, x))


@op("divide_no_nan")
def _divide_no_nan(x, y):
    zero = y == 0
    safe = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(x * y), x / safe)


# -- unary -------------------------------------------------------------------
def _unop(name, fn):
    wrapped = op(name)(fn)

    def api(x, name=None):
        return wrapped(wrap(x))
    api.__name__ = name
    return api


abs = _unop("abs", torch.abs)  # noqa: A001
neg = _unop("neg", torch.neg)
exp = _unop("exp", torch.exp)
expm1 = _unop("expm1", torch.expm1)
log = _unop("log", torch.log)
log2 = _unop("log2", torch.log2)
log10 = _unop("log10", torch.log10)
log1p = _unop("log1p", torch.log1p)
sqrt = _unop("sqrt", torch.sqrt)
rsqrt = _unop("rsqrt", torch.rsqrt)
square = _unop("square", torch.square)
sin = _unop("sin", torch.sin)
cos = _unop("cos", torch.cos)
tan = _unop("tan", torch.tan)
asin = _unop("asin", torch.asin)
acos = _unop("acos", torch.acos)
atan = _unop("atan", torch.atan)
sinh = _unop("sinh", torch.sinh)
cosh = _unop("cosh", torch.cosh)
tanh = _unop("tanh", torch.tanh)
asinh = _unop("asinh", torch.asinh)
acosh = _unop("acosh", torch.acosh)
atanh = _unop("atanh", torch.atanh)
floor = _unop("floor", torch.floor)
ceil = _unop("ceil", torch.ceil)
round = _unop("round", torch.round)  # noqa: A001
trunc = _unop("trunc", torch.trunc)
frac = _unop("frac", lambda x: x - torch.trunc(x))
sign = _unop("sign", torch.sign)
sgn = sign
reciprocal = _unop("reciprocal", torch.reciprocal)
erf = _unop("erf", torch.erf)
erfinv = _unop("erfinv", torch.erfinv)
lgamma = _unop("lgamma", torch.lgamma)
def _trigamma(x):
    """psi'(x) to float64 precision (torch's polygamma(1, .) is off by
    ~5e-10 relative, jax.scipy's is exact): reflection below 1/2, the
    recurrence psi'(x) = psi'(x + 1) + 1/x^2 up to 10, then the
    asymptotic series."""
    neg = x < 0.5
    z = torch.where(neg, 1.0 - x, x)
    acc = torch.zeros_like(z)
    for _ in range(10):
        low = z < 10.0
        acc = acc + torch.where(low, 1.0 / (z * z), torch.zeros_like(z))
        z = torch.where(low, z + 1.0, z)
    r = 1.0 / (z * z)
    t = 1.0 / z
    series = t + t * t / 2 + t ** 3 * (1.0 / 6 - r * (1.0 / 30 - r * (
        1.0 / 42 - r * (1.0 / 30 - r * (5.0 / 66 - r * 691.0 / 2730)))))
    out = series + acc
    refl = (math.pi / torch.sin(math.pi * x)) ** 2 - out
    return torch.where(neg, refl, out)


class _Digamma(torch.autograd.Function):
    """digamma with the precise trigamma as its derivative."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.digamma(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _trigamma(x)


digamma = _unop("digamma", _Digamma.apply)
i0 = _unop("i0", torch.special.i0)
i0e = _unop("i0e", torch.special.i0e)
i1 = _unop("i1", torch.special.i1)
i1e = _unop("i1e", torch.special.i1e)
deg2rad = _unop("deg2rad", torch.deg2rad)
rad2deg = _unop("rad2deg", torch.rad2deg)
angle = _unop("angle", torch.angle)
conj = _unop("conj", torch.conj_physical)
real = _unop("real", lambda x: torch.real(x) if x.is_complex() else x)
imag = _unop("imag", lambda x: torch.imag(x) if x.is_complex()
             else torch.zeros_like(x))
_stanh = op("stanh")(lambda x, a, b: b * torch.tanh(a * x))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    """b * tanh(a * x) (the reference's STanh, scale_a 0.67)."""
    return _stanh(wrap(x), scale_a, scale_b)


softsign = _unop("softsign", lambda x: x / (1 + torch.abs(x)))
rint = _unop("rint", torch.round)


@op("isnan", differentiable=False)
def _isnan(x):
    return torch.isnan(x)


@op("isinf", differentiable=False)
def _isinf(x):
    return torch.isinf(x)


@op("isfinite", differentiable=False)
def _isfinite(x):
    return torch.isfinite(x)


def isnan(x, name=None):
    return _isnan(wrap(x))


def isinf(x, name=None):
    return _isinf(wrap(x))


def isfinite(x, name=None):
    return _isfinite(wrap(x))


@op("scale")
def _scale(x, scale, bias, bias_after_scale):
    # out = scale * x + bias (the reference's scale_op)
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def scale(x, scale_=1.0, bias=0.0, bias_after_scale=True, act=None, name=None,
          **kw):
    if "scale" in kw:
        scale_ = kw["scale"]
    out = _scale(wrap(x), scale_, bias, bias_after_scale)
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


@op("increment")
def _increment(x, value):
    return torch.Tensor.add_(x, value)


def increment(x, value=1.0, name=None):
    """x += value in place (torch's in-place add: a leaf that needs
    grad refuses it, as the JAX package's check does); returns x."""
    _increment(x, value)
    return x


@op("clip")
def _clip(x, mn, mx):
    if mn is None and mx is None:
        return x
    return torch.clamp(x, mn, mx)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    """x clamped to [min, max]; a None bound is open, and with neither
    bound x comes back unchanged. Tensor bounds stay on the device."""
    x = wrap(x)
    if torch.is_tensor(min) or torch.is_tensor(max):
        min = None if min is None else wrap(min, x).to(x.dtype)
        max = None if max is None else wrap(max, x).to(x.dtype)
    return _clip(x, min, max)


@op("lerp")
def _lerp(x, y, w):
    return x + w * (y - x)


def lerp(x, y, weight, name=None):
    x = wrap(x)
    return _lerp(x, wrap(y, x), wrap(weight, x))


@op("add_n")
def _add_n(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def add_n(inputs, name=None):
    """The sum of a list of tensors (the reference's sum_op)."""
    if torch.is_tensor(inputs):
        return inputs
    return _add_n(list(inputs))


def sum_n(inputs):
    return add_n(inputs)


# -- reductions --------------------------------------------------------------
def _norm_axis(axis):
    """An axis argument as an int, a tuple of ints or None (a Tensor
    axis is read on the host, as in the JAX package)."""
    if axis is None:
        return None
    if torch.is_tensor(axis):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """torch's dim for a reduction over `axis` (all axes for None)."""
    if axis is None:
        return tuple(range(x.ndim))
    return axis


def _reduction(name, fn):
    wrapped = op(name)(fn)

    def api(x, axis=None, keepdim=False, name=None):
        return wrapped(wrap(x), _norm_axis(axis), keepdim)
    api.__name__ = name
    return api


def _prod_all(x, axis, keepdim):
    if axis is None:
        out = torch.prod(x)
        return out.reshape([1] * x.ndim) if keepdim else out
    axes = sorted(a % x.ndim for a in ((axis,) if isinstance(axis, int)
                                       else axis))
    for a in reversed(axes):
        x = torch.prod(x, a, keepdim)
    return x


_sum_op = op("reduce_sum")(
    lambda x, axis, keepdim: torch.sum(x, _dims(x, axis), keepdim))


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    """dtype casts the input first (Paddle's rule)."""
    x = wrap(x)
    if dtype is not None:
        x = cast(x, dtype)
    return _sum_op(x, _norm_axis(axis), keepdim)


mean = _reduction("reduce_mean", lambda x, axis, keepdim:
                  torch.mean(x, _dims(x, axis), keepdim))
max = _reduction("reduce_max", lambda x, axis, keepdim:  # noqa: A001
                 torch.amax(x, () if axis is None else axis, keepdim))
min = _reduction("reduce_min", lambda x, axis, keepdim:  # noqa: A001
                 torch.amin(x, () if axis is None else axis, keepdim))
_prod_op = op("reduce_prod")(_prod_all)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = wrap(x)
    if dtype is not None:
        x = cast(x, dtype)
    return _prod_op(x, _norm_axis(axis), keepdim)


amax = _reduction("reduce_amax", lambda x, axis, keepdim:
                  torch.amax(x, () if axis is None else axis, keepdim))
amin = _reduction("reduce_amin", lambda x, axis, keepdim:
                  torch.amin(x, () if axis is None else axis, keepdim))
nansum = _reduction("reduce_nansum", lambda x, axis, keepdim:
                    torch.nansum(x, _dims(x, axis), keepdim))
nanmean = _reduction("reduce_nanmean", lambda x, axis, keepdim:
                     torch.nanmean(x, _dims(x, axis), keepdim))


def logsumexp(x, axis=None, keepdim=False, name=None):
    """log(sum(exp(x))) over axis (every axis when None)."""
    return _logsumexp(wrap(x), _norm_axis(axis), keepdim)


@op("logsumexp")
def _logsumexp(x, axis, keepdim):
    if x.ndim == 0:
        return x.clone()
    return torch.logsumexp(x, _dims(x, axis), keepdim)


@op("all", differentiable=False)
def _all(x, axis, keepdim):
    if axis is None:
        out = torch.all(x)
        return out.reshape([1] * x.ndim) if keepdim else out
    return torch.all(x, dim=axis, keepdim=keepdim)


@op("any", differentiable=False)
def _any(x, axis, keepdim):
    if axis is None:
        out = torch.any(x)
        return out.reshape([1] * x.ndim) if keepdim else out
    return torch.any(x, dim=axis, keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """Whether every entry is true (over `axis`, or all of x)."""
    return _all(wrap(x), _norm_axis(axis), keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _any(wrap(x), _norm_axis(axis), keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = wrap(x)
    return sum(cast(x != 0, "int64"), axis=axis, keepdim=keepdim)


# -- cumulative --------------------------------------------------------------
@op("cumsum")
def _cumsum(x, axis):
    if axis is None:
        return torch.cumsum(torch.reshape(x, (-1,)), 0)
    return torch.cumsum(x, axis)


def cumsum(x, axis=None, dtype=None, name=None):
    """Running sum along axis (over the flattened x when None)."""
    out = _cumsum(wrap(x), None if axis is None else int(axis))
    if dtype is not None:
        out = cast(out, dtype)
    return out


@op("cumprod")
def _cumprod(x, dim):
    if dim is None:
        return torch.cumprod(torch.reshape(x, (-1,)), 0)
    return torch.cumprod(x, dim)


def cumprod(x, dim=None, dtype=None, name=None):
    out = _cumprod(wrap(x), None if dim is None else int(dim))
    if dtype is not None:
        out = cast(out, dtype)
    return out


@eager
def _flat(x):
    return torch.reshape(x, (-1,))


@op("cummax")
def _cummax(x, axis, dtype):
    """(running max, index of the first position attaining it). The
    index is found without the graph; the values are gathered through
    it, so the gradient goes to the attaining element."""
    xs = x.detach()
    vals = torch.cummax(xs, axis).values
    shape = [-1 if i == axis else 1 for i in range(x.ndim)]
    ar = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    prev = torch.roll(vals, 1, axis)
    is_new = (xs == vals) & ((ar == 0) | (xs > prev))
    idx = torch.cummax(torch.where(is_new, ar, torch.zeros_like(ar)),
                       axis).values
    return torch.gather(x, axis, idx), idx.to(convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    x = wrap(x)
    if axis is None:
        x, axis = _flat(x), 0
    axis = axis + x.ndim if axis < 0 else axis
    return _cummax(x, axis, dtype)


@op("logcumsumexp")
def _logcumsumexp(x, axis):
    return torch.logcumsumexp(x, axis)


def logcumsumexp(x, axis=None, name=None):
    x = wrap(x)
    if axis is None:
        x, axis = _flat(x), 0
    return _logcumsumexp(x, int(axis))


@op("trace")
def _trace(x, offset, axis1, axis2):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _trace(wrap(x), offset, axis1, axis2)


@op("diagonal")
def _diagonal(x, offset, axis1, axis2):
    return torch.diagonal(x, offset, axis1, axis2)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return _diagonal(wrap(x), offset, axis1, axis2)


@op("cast")
def _cast(x, dtype):
    return x.to(dtype)


def cast(x, dtype):
    return _cast(wrap(x), convert_dtype(dtype))


# -- paddle 2.x math tail ----------------------------------------------------
@op("complex")
def _complex(real, imag):
    return torch.complex(real, imag)


def complex(real, imag, name=None):  # noqa: A001
    real = wrap(real)
    return _complex(real, wrap(imag, real))


@op("polar")
def _polar(r, theta):
    return torch.complex(r * torch.cos(theta), r * torch.sin(theta))


def polar(abs, angle, name=None):  # noqa: A002
    abs = wrap(abs)
    return _polar(abs, wrap(angle, abs))


@op("logit")
def _logit(x, eps):
    z = torch.clamp(x, eps, 1 - eps) if eps else x
    return torch.log(z) - torch.log1p(-z)


def logit(x, eps=None, name=None):
    return _logit(wrap(x), float(eps) if eps else 0.0)


@op("diff")
def _diff(x, n, axis):
    return torch.diff(x, n, axis)


@eager
def _joined(parts, axis):
    return torch.cat(parts, axis)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    t = wrap(x)
    parts = [t]
    if prepend is not None:
        parts.insert(0, wrap(prepend, t))
    if append is not None:
        parts.append(wrap(append, t))
    if len(parts) > 1:
        t = _joined(parts, axis)
    return _diff(t, int(n), int(axis))


@op("trapezoid")
def _trapezoid(y, x, dx, axis):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=dx, dim=axis)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = wrap(y)
    return _trapezoid(y, None if x is None else wrap(x, y),
                      1.0 if dx is None else float(dx), int(axis))


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = wrap(y)
    return _cumtrap(y, None if x is None else wrap(x, y),
                    1.0 if dx is None else float(dx), int(axis))


@op("cumulative_trapezoid")
def _cumtrap(y, x, dx, axis):
    n = y.shape[axis]
    y0, y1 = y.narrow(axis, 0, n - 1), y.narrow(axis, 1, n - 1)
    if x is not None:
        if x.ndim == 1 and y.ndim > 1:
            # 1-D sample points broadcast along `axis` (paddle semantics)
            shape = [1] * y.ndim
            shape[axis] = n - 1
            steps = torch.diff(x).reshape(shape)
        else:
            m = x.shape[axis]
            steps = x.narrow(axis, 1, m - 1) - x.narrow(axis, 0, m - 1)
    else:
        steps = dx
    return torch.cumsum((y0 + y1) * steps / 2.0, axis)


@op("vander")
def _vander(x, n, increasing):
    # powers as a running product (torch.vander's backward fails on
    # its own in-place writes)
    cols = [torch.ones(*x.shape, 1 if n else 0, dtype=x.dtype,
                       device=x.device)]
    if n > 1:
        cols.append(torch.cumprod(torch.unsqueeze(x, -1).expand(
            *x.shape, n - 1), -1))
    v = torch.cat(cols, -1)
    return v if increasing else v.flip(-1)


def vander(x, n=None, increasing=False, name=None):
    t = wrap(x)
    return _vander(t, int(n) if n is not None else t.shape[0],
                   bool(increasing))


@op("renorm")
def _renorm(x, p, axis, max_norm):
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(torch.abs(flat) ** p, 1) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    out = flat * factor[:, None]
    return torch.movedim(out.reshape(moved.shape), 0, axis)


def renorm(x, p, axis, max_norm, name=None):
    # reference: renorm_op.cc
    return _renorm(wrap(x), float(p), int(axis), float(max_norm))


@op("take")
def _take(x, index, mode):
    flat = torch.reshape(x, (-1,))
    idx = index.to(torch.int64)
    n = flat.shape[0]
    if mode == "wrap":
        idx = ((idx % n) + n) % n
    else:
        idx = torch.clamp(idx, -n, n - 1)
        idx = torch.where(idx < 0, idx + n, idx)
    return flat[idx]


def take(x, index, mode="raise", name=None):
    """x flattened, gathered at index. mode "raise" checks the range on
    the host first (as the JAX package does); "wrap" wraps, "clip"
    clamps."""
    xt = wrap(x)
    it = wrap(index, xt)
    if mode == "raise":
        n = torch.numel(xt)
        if torch.numel(it) and ((it < -n) | (it >= n)).any().item():
            raise IndexError(
                f"paddle.take(mode='raise'): index out of range for a "
                f"tensor of {n} elements")
    return _take(xt, it, mode)


@op("nan_to_num")
def _nan_to_num(x, nan, posinf, neginf):
    return torch.nan_to_num(x, nan, posinf, neginf)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return _nan_to_num(wrap(x), float(nan), posinf, neginf)


@op("signbit", differentiable=False)
def _signbit(x):
    return torch.signbit(x)


def signbit(x, name=None):
    return _signbit(wrap(x))


@op("ldexp")
def _ldexp(x, y):
    return x * torch.pow(2.0, y).to(x.dtype)


def ldexp(x, y, name=None):
    x = wrap(x)
    return _ldexp(x, wrap(y, x))


@op("frexp", differentiable=False)
def _frexp(x):
    m, e = torch.frexp(x)
    return m, e


def frexp(x, name=None):
    return _frexp(wrap(x))


__all__ = [n for n in dir() if not n.startswith("_") and n not in (
    "annotations", "math", "np", "torch", "op", "eager", "wrap",
    "convert_dtype")]
