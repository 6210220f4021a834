"""The op corpus and Paddle's Tensor methods (port of
paddle_tpu/ops/__init__.py).

The eight modules of the core corpus (creation, math, logic,
manipulation, linalg, search, array_ops, random_ops) are star-exported
here and at the package's top level, with the names that shadow Python
builtins bound again for explicit use, as in the JAX package.

`_attach_tensor_methods` is the port of the JAX package's method table
(paddle_tpu/ops/__init__.py:167): every name of its list that the
port's Tensor does not define itself becomes a method that runs the
Paddle function, so `x.split(2)`, `x.median()` or `x.max(axis=1)`
answer as in the JAX package where torch has a method of the same name.
The in-place variants of the JAX package's list are torch's own
methods (`add_`, `floor_`, ...: the same arithmetic), but `clip_`
(which takes no bounds), `scale_` and `cast_`, which are the table's;
so are `fill_`, `uniform_` and `normal_` (the port's generators). `Tensor.size` stays torch's
method (the JAX package's is a property; torch code calls `size()` on
tensors), and parameters keep torch's methods for the names in
core/tensor.py's TORCH_ON_PARAMETERS; core/tensor.py's docstring gives
the rules. torch's dunders stay: their promotion is the JAX package's.
`reshape` and `expand` also take torch's spelling with the sizes as
separate arguments (`x.reshape(2, 3)`), which Paddle's never is.

HOST_READS names the functions of the eight modules that copy a device
value to the host, each where the JAX op reads a host value itself
(shapes, axes and offsets given as Tensors, a range check);
tests/test_torch_op_names.py holds the modules to it.
"""
from __future__ import annotations

import functools

import torch

from ..core import random as _random
from ..core.dtypes import convert_dtype
from ..core.tensor import Tensor

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .array_ops import *  # noqa: F401,F403
from .random_ops import *  # noqa: F401,F403

from . import (creation, math, logic, manipulation, linalg, search,  # noqa: F401,E501
               array_ops, random_ops, control_flow, extra_ops, vision_ops)

# re-bind names that collide with builtins for explicit use
from .math import sum, max, min, abs, all, any, round, pow  # noqa: F401,A004
from .manipulation import slice  # noqa: F401,A004

# (module, function) -> why the function reads a device value on the host
HOST_READS = {
    ("math", "_norm_axis"): "a reduction axis given as a Tensor",
    ("math", "take"): "mode='raise' checks the index range",
    ("search", "topk"): "k given as a Tensor",
    ("search", "quantile"): "q given as a Tensor",
    ("search", "nanquantile"): "q given as a Tensor",
    ("manipulation", "_ints"): "a shape, axis or offset list as a Tensor",
    ("manipulation", "_axis"): "an axis given as a Tensor",
    ("creation", "_shape"): "a shape given as a Tensor",
    ("creation", "full"): "fill_value given as a Tensor",
    ("creation", "arange"): "start, end or step given as a Tensor",
    ("creation", "_scalar"): "linspace/logspace bounds as Tensors",
    ("linalg", "matrix_rank"): "tol given as a Tensor",
    ("array_ops", "_host_ints"): "crop's shape or offsets as Tensors",
    ("array_ops", "_index"): "a TensorArray index given as a Tensor",
}

# the JAX package's tensor_method_func list (paddle_tpu/ops/__init__.py)
METHOD_NAMES = [
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "abs", "neg", "exp", "expm1", "log", "log2", "log10", "log1p",
    "sqrt", "rsqrt", "square", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "floor",
    "ceil", "round", "trunc", "frac", "sign", "sgn", "reciprocal", "erf",
    "erfinv", "lgamma", "digamma", "deg2rad", "rad2deg", "angle", "conj",
    "real", "imag", "isnan", "isinf", "isfinite", "scale", "clip",
    "lerp", "sum", "mean", "max", "min", "prod", "amax", "amin",
    "nansum", "nanmean", "logsumexp", "all", "any", "count_nonzero",
    "cumsum", "cumprod", "logcumsumexp", "trace", "diagonal", "cast",
    "increment", "atan2", "heaviside", "kron", "inner", "outer",
    "divide_no_nan", "hypot", "copysign",
    # logic
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "equal_all", "allclose", "isclose", "is_empty",
    # manipulation
    "reshape", "reshape_", "transpose", "t", "moveaxis", "concat",
    "stack", "unstack", "split", "chunk", "tensor_split", "squeeze",
    "squeeze_", "unsqueeze", "unsqueeze_", "flatten", "expand",
    "broadcast_to", "expand_as", "tile", "repeat_interleave", "roll",
    "flip", "rot90", "gather", "gather_nd", "scatter", "scatter_",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "take_along_axis", "put_along_axis", "masked_select", "masked_fill",
    "where", "nonzero", "pad", "slice", "strided_slice", "unique",
    "unique_consecutive", "as_complex", "as_real", "numel", "crop",
    # linalg
    "matmul", "mm", "bmm", "dot", "mv", "addmm", "norm", "dist",
    "cross", "cholesky", "cholesky_solve", "inverse", "pinv", "det",
    "slogdet", "matrix_power", "solve", "triangular_solve", "multi_dot",
    "histogram", "bincount", "tensordot",
    # search/stat
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
    "median", "nanmedian", "quantile", "nanquantile", "std", "var",
    "searchsorted", "bucketize",
    # creation-ish
    "tril", "triu", "diag", "diagflat", "bernoulli", "multinomial",
    "zeros_like", "ones_like",
]

# the JAX package's in-place arithmetic variants; torch's own methods
# of these names compute the same, but for the three _PADDLE_INPLACE
INPLACE_NAMES = ("add", "subtract", "multiply", "divide", "clip", "scale",
                 "floor", "ceil", "exp", "sqrt", "reciprocal", "round",
                 "remainder", "tanh", "cast")
_PADDLE_INPLACE = ("clip", "scale", "cast")


def _method_sources():
    """name -> the Paddle function, from the modules in the JAX
    package's order (the first module that defines a name wins)."""
    sources = {}
    for mod in (creation, math, logic, manipulation, linalg, search):
        for name in dir(mod):
            f = getattr(mod, name)
            if not name.startswith("_") and callable(f) \
                    and not isinstance(f, type):
                sources.setdefault(name, f)
    return sources


def _make_inplace(fname):
    """x.clip_(...), x.scale_(...) or x.cast_(dtype): x changed in place
    (the other in-place variants of the JAX package's list are torch's
    own methods, which compute the same in-place arithmetic). A leaf
    that needs grad refuses clip_ and scale_ as the JAX package's check
    does; cast_ changes the dtype outside the graph."""
    if fname == "cast":
        def inplace(self, *args, **kwargs):
            (dtype,) = args or (kwargs["dtype"],)
            with torch.no_grad():
                self.data = self.detach().to(convert_dtype(dtype))
            return self
    elif fname == "clip":
        def inplace(self, *args, **kwargs):
            bounds = dict(zip(("min", "max"), args), **kwargs)
            lo, hi = bounds.get("min"), bounds.get("max")
            if lo is not None or hi is not None:
                torch.Tensor.clamp_(self, lo, hi)
            return self
    else:
        def inplace(self, *args, **kwargs):
            torch.Tensor.copy_(self, math.scale(self, *args, **kwargs))
            return self
    inplace.__name__ = fname + "_"
    inplace.__qualname__ = "Tensor." + inplace.__name__
    return inplace


def fill_(self, value):
    """Every entry set to value (outside the graph, as the JAX package
    writes the value)."""
    with torch.no_grad():
        torch.Tensor.fill_(self, value)
    return self


def uniform_(self, min=-1.0, max=1.0, seed=0, *, generator=None):  # noqa: A002
    """Refill with U[min, max) draws from the port's generator of the
    Tensor's device (or a generator of its own for a nonzero seed)."""
    if generator is None:
        generator = random_ops._gen(self.device, seed)
    with torch.no_grad():
        torch.Tensor.uniform_(self, min, max, generator=generator)
    return self


def normal_(self, mean=0.0, std=1.0, *, generator=None):
    """Refill with N(mean, std) draws from the port's generator."""
    if generator is None:
        generator = _random.generator(self.device)
    with torch.no_grad():
        torch.Tensor.normal_(self, mean, std, generator=generator)
    return self


def _torch_varargs(fn, torch_fn):
    """fn as a method that also takes torch's spelling, x.reshape(2, 3)
    or x.expand(4, -1): a second size after `shape` is never Paddle's
    (its next parameter is the name), so such a call means torch's."""
    @functools.wraps(fn)
    def method(x, shape, *sizes, name=None):
        if sizes:
            return torch_fn(x, (shape, *sizes))
        return fn(x, shape, name)
    return method


# the table's names whose torch spelling (sizes as separate arguments)
# the port's own torch-style code uses on Tensors
_TORCH_VARARGS = {
    "reshape": lambda x, sizes: torch.reshape(x, sizes),
    "expand": lambda x, sizes: torch.Tensor.expand(x, sizes),
}


def _attach_tensor_methods():
    T = Tensor
    own = set(T.__dict__)
    sources = _method_sources()
    for name in METHOD_NAMES:
        f = sources.get(name)
        if f is not None and name not in own:
            if name in _TORCH_VARARGS:
                f = _torch_varargs(f, _TORCH_VARARGS[name])
            setattr(T, name, f)
    for fname in _PADDLE_INPLACE:
        setattr(T, fname + "_", _make_inplace(fname))
    T.fill_ = fill_
    T.uniform_ = uniform_
    T.normal_ = normal_


_attach_tensor_methods()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Print options of tensors (torch's, which print the port's)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def tanh_(x, name=None):
    """In-place tanh (paddle.tensor.tanh_)."""
    return x.tanh_()


__all__ = sorted(
    {n for m in (creation, math, logic, manipulation, linalg, search,
                 array_ops, random_ops) for n in m.__all__}
    | {"set_printoptions", "tanh_", "creation", "math", "logic",
       "manipulation", "linalg", "search", "array_ops", "random_ops"})
