"""The core op corpus's replayed cases, for runs with no JAX.

tests/test_torch_op_suite.py, tests/test_torch_op_grad_suite.py and
tests/test_torch_op_tail.py hold the port to the JAX package on the CPU,
case by case. op_cases.json and op_cases.npz beside this file are those
cases written out (the api's name or the case's lambda source, its
inputs, kwargs and the arguments whose gradients are checked;
tests/test_torch_op_suite.py holds the files to the JAX tables), so
that chip_smoke.py's phase 31 and tests/test_torch_cuda.py replay the
same cases on CUDA, against the port's own CPU results:

- `load_cases()` -> the cases, each with a callable over the port;
- `run(case, device)` -> its outputs, and its gradients at float64
  inputs for a fixed random cotangent, as numpy arrays;
- `compare(got, want, case)` -> the first disagreement or None, and
  `agree(got, want)` for one array, at the stated limits: integer, bool and index outputs exactly; float32
  (complex64) |got - want| <= 1e-5 * (|want| + max |want|); float64
  the same at 1e-10; decompositions defined up to sign or basis (qr,
  svd, eig, eigh) after fixing each column's sign or phase, at 1e-4
  (cuSOLVER against LAPACK).
"""
from __future__ import annotations

import ast
import importlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

F32_TOL, F64_TOL, DECOMP_TOL = 1e-5, 1e-10, 1e-4
_FILE = Path(__file__).parent / "op_cases"


@dataclass
class Case:
    name: str
    fn: Callable
    args: list
    kwargs: dict
    grad: tuple
    out_sel: int
    decomposition: Optional[str]


def _decode(v, arrays):
    if "array" in v:
        return arrays[v["array"]]
    if "list" in v:
        return [_decode(a, arrays) for a in v["list"]]
    return v["value"]


def _callable(spec, arrays):
    import paddle_tpu_torch as paddle
    if spec["api"]:
        mod, attr = spec["api"].split(".")
        return getattr(importlib.import_module(
            f"paddle_tpu_torch.ops.{mod}"), attr)
    ns = {"paddle": paddle, "F": paddle.nn.functional, "np": np}
    for g in spec["globals"]:
        ns[g] = arrays[f"{spec['name']}/global/{g}"]
    defaults = [_decode(d, arrays) for d in spec["defaults"] or []]
    node = ast.parse(spec["lambda"], mode="eval").body
    # a default's own expression names the loop variable it was bound
    # from; bind those names, then set the recorded values
    for d in node.args.defaults:
        for n in ast.walk(d):
            if isinstance(n, ast.Name):
                ns.setdefault(n.id, None)
    fn = eval(compile(ast.Expression(node), spec["name"], "eval"), ns)
    if defaults:
        fn.__defaults__ = tuple(defaults)
    if spec["takes_pkg"]:
        return lambda *a, **k: fn(paddle, *a, **k)
    return fn


def load_cases():
    """Every replayed case, in the JAX tables' order."""
    specs = json.loads(_FILE.with_suffix(".json").read_text())
    with np.load(_FILE.with_suffix(".npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return [Case(s["name"], _callable(s, arrays),
                 [_decode(a, arrays) for a in s["args"]],
                 {k: _decode(v, arrays) for k, v in s["kwargs"].items()},
                 tuple(s["grad"]), s["out_sel"], s["decomposition"])
            for s in specs]


def flat(out):
    """The tensors of an op's result (nested lists and tuples flattened)."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat(o)]
    return []


def _tensors(args, device, stop_gradient, f64=False):
    import paddle_tpu_torch as paddle

    def one(a):
        if isinstance(a, np.ndarray):
            if f64 and a.dtype == np.float32:
                a = a.astype(np.float64)
            return paddle.to_tensor(a, place=device,
                                    stop_gradient=stop_gradient)
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [one(x) for x in a]
        return a
    return [one(a) for a in args]


def host(t):
    """A tensor as a host array (bfloat16 as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def run(case, device):
    """(outputs, gradients, devices of the outputs) of the case on
    `device`; the gradients are None without case.grad."""
    import paddle_tpu_torch as paddle
    from ..core.place import default_device
    with default_device(device):
        outs = flat(case.fn(*_tensors(case.args, device, True),
                             **case.kwargs))
        got = [host(t) for t in outs]
        devices = {str(t.device) for t in outs}
        grads = None
        if case.grad:
            targs = _tensors(case.args, device, False, f64=True)
            out = flat(case.fn(*targs, **case.kwargs))[case.out_sel]
            w = np.random.RandomState(1234).uniform(
                0.5, 1.5, size=tuple(out.shape))
            (out * paddle.to_tensor(w, place=device).to(out.dtype)) \
                .sum().backward()
            grads = [None if targs[i].grad is None else host(targs[i].grad)
                     for i in case.grad]
    return got, grads, devices


def agree(got, want, tol=None):
    """None when got equals want within the stated limits (tol
    overrides the dtype's), else what differs."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return f"shape {got.shape} != {want.shape}"
    if want.dtype.kind in "iub":
        return None if np.array_equal(got, want) else "values differ"
    if tol is None:
        tol = F64_TOL if want.dtype in (np.float64, np.complex128) \
            else F32_TOL
    scale = float(np.nanmax(np.abs(want))) if want.size else 0.0
    scale = scale if np.isfinite(scale) else 0.0
    bad = ~np.isclose(got.astype(want.dtype), want, rtol=tol,
                      atol=tol * scale, equal_nan=True)
    if bad.any():
        err = np.nanmax(np.abs(got - want)[bad])
        return f"max |diff| {err:.3g} over the limit ({tol:g} relative)"
    return None


def _col_fix(m):
    idx = np.abs(m).argmax(-2)
    pick = np.take_along_axis(m, idx[..., None, :], -2)
    return m / (pick / np.where(np.abs(pick) == 0, 1, np.abs(pick)))


def gauge(name, outs):
    """Outputs with each column's sign or phase fixed."""
    outs = [np.asarray(o) for o in outs]
    if name == "qr":
        if len(outs) == 1:
            return [np.abs(outs[0])]
        d = np.sign(np.diagonal(outs[1], axis1=-2, axis2=-1))
        return [outs[0] * d[..., None, :], outs[1] * d[..., :, None]]
    if name == "svd":
        u, s, v = outs
        f = np.sign(np.take_along_axis(u, np.abs(u).argmax(-2)[..., None, :],
                                       -2))
        return [u * f, s, v[..., :, :s.shape[-1]] * f]
    if name == "eigh":
        return [outs[0], _col_fix(outs[1])]
    if name == "eig":
        o = np.argsort(outs[0].real)
        return [outs[0][o], _col_fix(outs[1][:, o])]
    return outs


def compare(got, want, case, grads=False):
    """The first disagreement of got with want (a message), or None."""
    if len(got) != len(want):
        return f"{len(got)} outputs, want {len(want)}"
    tol = None
    if case.decomposition and not grads:
        got, want = gauge(case.decomposition, got), gauge(
            case.decomposition, want)
        tol = DECOMP_TOL
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None or g is None:
            if (w is None) != (g is None) and np.any(g if w is None else w):
                return f"output {i}: gradient missing on one side"
            continue
        msg = agree(g, w, tol)
        if msg:
            return f"{'grad' if grads else 'output'} {i}: {msg}"
    return None


# ------------------------------------------------- the Tensor method table
# One row per method of the JAX package's Tensor method table and per
# method its Tensor defines itself: (name, call(env), kinds, random).
# call takes a MethodEnv of either package (its x is the receiver);
# kinds says which inputs the method takes ("f" float32, "i" int64);
# random rows are held to shape, dtype and range only.
# tests/test_torch_tensor_methods.py holds each row to the JAX package on
# the CPU; chip_smoke.py's phase 31 runs each on a CUDA Tensor and a CUDA
# parameter against the CPU.
METHOD_X = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.float32)
_Y = np.array([[2, 1, 4, 3], [6, 8, 5, 7]], np.float32)
_SPD = np.array([[4, 1, 0], [1, 3, 1], [0, 1, 2]], np.float32)


class MethodEnv:
    """The inputs of a row in one package (P, paddle_tpu or the port):
    x, the receiver of most rows, and helpers of x's dtype; derived
    inputs are made here so that each row calls one method on one
    receiver. parameters=True makes every tensor a parameter (the port's
    EagerParamBase, trainable when it is float), and fresh() a new
    non-trainable parameter, as chip_smoke.py's phase 31 calls the
    table on parameters."""

    def __init__(self, P, dtype, parameters=False):
        self.P = P
        self._dtype = dtype
        self._parameters = parameters
        t = lambda a, d=dtype: P.to_tensor(np.asarray(a).astype(d))  # noqa
        self.x = t(METHOD_X)
        self.y = t(_Y)
        self.small = t(METHOD_X / 10, "float32")
        self.i = t([1, 0], "int64")
        self.i2 = t([[0, 1], [1, 3]], "int64")
        self.col = t([[3], [0]], "int64")
        self.mask = t(METHOD_X > 4, "bool")
        self.spd = t(_SPD, "float32")
        self.vec = t([1, 2, 3, 4], dtype)
        self.sq = t(METHOD_X[:, :2], dtype)
        self.seq = t([1, 3, 5, 7], dtype)
        self.cplx = t(METHOD_X.reshape(2, 2, 2), "float32")
        self.x1 = t(METHOD_X + 1)
        self.x10 = t(METHOD_X / 10)
        self.xf = t(METHOD_X.reshape(-1))
        self.yt = t(_Y.T)
        self.xu = t(METHOD_X[None])
        self.ytu = t(_Y.T[None])
        self.spdt = t(_SPD.T, "float32")
        self.chol = t(np.linalg.cholesky(_SPD), "float32")
        self.tri = t(np.triu(_SPD), "float32")
        self.b = t(_SPD[:, :1], "float32")
        self.yc = t(_Y[:, :1])
        self.v2 = t([1, 2], dtype)
        self.cplxc = P.as_complex(self.cplx)
        if parameters:
            from ..core.tensor import EagerParamBase
            for k, v in vars(self).items():
                if torch.is_tensor(v):
                    setattr(self, k, EagerParamBase(
                        v, v.is_floating_point() and not v.is_complex()))

    def fresh(self, shape=None):
        """A new receiver equal to x (reshaped to shape), for the rows
        that change their receiver in place."""
        a = METHOD_X if shape is None else METHOD_X.reshape(shape)
        t = self.P.to_tensor(a.astype(self._dtype))
        if self._parameters:
            from ..core.tensor import EagerParamBase
            t = EagerParamBase(t, False)
        return t


def _row(name, call, kinds="f", random=False):
    return (name, call, kinds, random)


_UNARY_F = ["abs", "neg", "exp", "expm1", "log", "log2", "log10", "log1p",
            "sqrt", "rsqrt", "square", "sin", "cos", "tan", "atan", "sinh",
            "cosh", "tanh", "asinh", "floor", "ceil", "round", "trunc",
            "frac", "sign", "sgn", "reciprocal", "erf", "lgamma", "digamma",
            "deg2rad", "rad2deg", "angle", "conj", "real", "imag", "isnan",
            "isinf", "isfinite", "sum", "mean", "max", "min", "prod", "amax",
            "amin", "nansum", "nanmean", "logsumexp", "all", "any",
            "count_nonzero", "cumsum", "cumprod", "logcumsumexp", "trace",
            "diagonal", "t", "flatten", "unique", "numel", "argmax",
            "argmin", "argsort", "sort", "median", "nanmedian", "std", "var",
            "tril", "triu", "diag", "zeros_like", "ones_like", "nonzero",
            "unique_consecutive", "norm", "squeeze", "transpose",
            "is_empty", "histogram"]
_INT_OK = {"abs", "neg", "sign", "sgn", "sum", "max", "min", "prod", "amax",
           "amin", "all", "any", "count_nonzero", "cumsum", "cumprod",
           "trace", "diagonal", "t", "flatten", "unique", "numel", "argmax",
           "argmin", "argsort", "sort", "tril", "triu", "diag", "zeros_like",
           "ones_like", "nonzero", "unique_consecutive", "squeeze",
           "transpose", "is_empty", "isnan", "isinf", "isfinite", "square",
           "floor", "ceil", "round", "trunc", "real", "imag"}
_BINARY = ["add", "subtract", "multiply", "divide", "floor_divide",
           "remainder", "mod", "floor_mod", "pow", "maximum", "minimum",
           "fmax", "fmin", "atan2", "heaviside", "hypot", "copysign",
           "divide_no_nan", "equal", "not_equal", "greater_than",
           "greater_equal", "less_than", "less_equal", "logical_and",
           "logical_or", "logical_xor", "equal_all", "allclose", "isclose",
           "kron", "inner", "outer"]
_BIN_INT_OK = {"add", "subtract", "multiply", "floor_divide", "remainder",
               "mod", "floor_mod", "pow", "maximum", "minimum", "equal",
               "not_equal", "greater_than", "greater_equal", "less_than",
               "less_equal", "logical_and", "logical_or", "logical_xor",
               "equal_all", "kron", "divide"}

METHOD_ROWS = [
    *[_row(n, lambda e, n=n: getattr(e.x, n)(),
        "fi" if n in _INT_OK else "f") for n in _UNARY_F],
    *[_row(n, lambda e, n=n: getattr(e.small, n)(), "f")
      for n in ("asin", "acos", "atanh", "erfinv")],
    _row("acosh", lambda e: e.x1.acosh()),
    *[_row(n, lambda e, n=n: getattr(e.x, n)(e.y),
        "fi" if n in _BIN_INT_OK else "f") for n in _BINARY],
    *[_row(n, lambda e, n=n: getattr(e.x, n)(e.y), "i")
      for n in ("bitwise_and", "bitwise_or", "bitwise_xor")],
    _row("bitwise_not", lambda e: e.x.bitwise_not(), "i"),
    _row("logical_not", lambda e: e.mask.logical_not()),
    _row("scale", lambda e: e.x.scale(2.0, 1.0)),
    _row("clip", lambda e: e.x.clip(2.0, 6.0), "fi"),
    _row("lerp", lambda e: e.x.lerp(e.y, 0.25)),
    _row("cast", lambda e: e.x.cast("int32"), "fi"),
    _row("increment", lambda e: e.fresh().increment(2.0)),
    _row("reshape", lambda e: e.x.reshape([4, 2]), "fi"),
    _row("reshape_", lambda e: e.fresh().reshape_([4, 2]), "fi"),
    _row("moveaxis", lambda e: e.x.moveaxis(0, 1), "fi"),
    # concat and stack take the list first: x.concat(...) is the function
    _row("concat", lambda e: type(e.x).concat([e.x, e.y], axis=1), "fi"),
    _row("stack", lambda e: type(e.x).stack([e.x, e.y], axis=0), "fi"),
    _row("unstack", lambda e: e.x.unstack(axis=1), "fi"),
    _row("split", lambda e: e.x.split(2), "fi"),
    _row("chunk", lambda e: e.x.chunk(2, axis=1), "fi"),
    _row("tensor_split", lambda e: e.x.tensor_split(3, axis=1), "fi"),
    _row("squeeze_", lambda e: e.fresh([1, 2, 4]).squeeze_(0), "fi"),
    _row("unsqueeze", lambda e: e.x.unsqueeze(0), "fi"),
    _row("unsqueeze_", lambda e: e.fresh().unsqueeze_(0), "fi"),
    _row("expand", lambda e: e.vec.expand([3, 4]), "fi"),
    _row("broadcast_to", lambda e: e.vec.broadcast_to([3, 4]), "fi"),
    _row("expand_as", lambda e: e.vec.expand_as(e.x), "fi"),
    _row("tile", lambda e: e.x.tile([2, 1]), "fi"),
    _row("repeat_interleave", lambda e: e.x.repeat_interleave(2, axis=1), "fi"),
    _row("roll", lambda e: e.x.roll(1, axis=1), "fi"),
    _row("flip", lambda e: e.x.flip(axis=1), "fi"),
    _row("rot90", lambda e: e.x.rot90(), "fi"),
    _row("gather", lambda e: e.x.gather(e.i), "fi"),
    _row("gather_nd", lambda e: e.x.gather_nd(e.i2), "fi"),
    _row("scatter", lambda e: e.x.scatter(e.i, e.y), "fi"),
    _row("scatter_", lambda e: e.fresh().scatter_(e.i, e.y), "fi"),
    _row("scatter_nd_add", lambda e: e.x.scatter_nd_add(e.i2, e.v2), "fi"),
    _row("index_select", lambda e: e.x.index_select(e.i, axis=1), "fi"),
    _row("index_sample", lambda e: e.x.index_sample(e.i2), "fi"),
    _row("index_add", lambda e: e.x.index_add(e.i, 0, e.y), "fi"),
    _row("take_along_axis", lambda e: e.x.take_along_axis(e.col, 1), "fi"),
    _row("put_along_axis", lambda e: e.x.put_along_axis(e.col, e.yc, 1),
      "fi"),
    _row("masked_select", lambda e: e.x.masked_select(e.mask), "fi"),
    _row("masked_fill", lambda e: e.x.masked_fill(e.mask, 0), "fi"),
    _row("where", lambda e: e.mask.where(e.x, e.y), "fi"),
    _row("pad", lambda e: e.x.pad([1, 0, 0, 2]), "fi"),
    _row("strided_slice", lambda e: e.x.strided_slice([1], [3], [0], [-1]),
      "fi"),
    _row("as_complex", lambda e: e.cplx.as_complex()),
    _row("as_real", lambda e: e.cplxc.as_real()),
    _row("crop", lambda e: e.x.crop([1, 2], [1, 1]), "fi"),
    _row("matmul", lambda e: e.x.matmul(e.yt)),
    _row("mm", lambda e: e.x.mm(e.yt)),
    _row("bmm", lambda e: e.xu.bmm(e.ytu)),
    _row("dot", lambda e: e.x.dot(e.y)),
    _row("mv", lambda e: e.x.mv(e.vec)),
    _row("addmm", lambda e: e.sq.addmm(e.sq, e.sq)),
    _row("dist", lambda e: e.x.dist(e.y)),
    _row("cross", lambda e: e.spd.cross(e.spdt)),
    _row("cholesky", lambda e: e.spd.cholesky()),
    _row("cholesky_solve", lambda e: e.spd.cholesky_solve(e.chol)),
    _row("inverse", lambda e: e.spd.inverse()),
    _row("pinv", lambda e: e.x.pinv()),
    _row("det", lambda e: e.spd.det()),
    _row("slogdet", lambda e: e.spd.slogdet()),
    _row("matrix_power", lambda e: e.spd.matrix_power(2)),
    _row("solve", lambda e: e.spd.solve(e.b)),
    _row("triangular_solve", lambda e: e.tri.triangular_solve(e.spd)),
    _row("multi_dot", lambda e: type(e.x).multi_dot([e.x, e.yt, e.x])),
    _row("bincount", lambda e: e.xf.bincount(), "i"),
    _row("tensordot", lambda e: e.x.tensordot(e.yt, 1)),
    _row("topk", lambda e: e.x.topk(2), "fi"),
    _row("kthvalue", lambda e: e.x.kthvalue(2), "f"),
    _row("mode", lambda e: e.x.mode(), "fi"),
    _row("quantile", lambda e: e.x.quantile(0.3, axis=1)),
    _row("nanquantile", lambda e: e.x.nanquantile(0.3, axis=1)),
    _row("searchsorted", lambda e: e.seq.searchsorted(e.vec), "fi"),
    _row("bucketize", lambda e: e.vec.bucketize(e.seq), "fi"),
    _row("diagflat", lambda e: e.vec.diagflat(), "fi"),
    _row("bernoulli", lambda e: e.x10.bernoulli(), random=True),
    _row("multinomial", lambda e: e.x.multinomial(2), random=True),
    _row("slice", lambda e: e.x.slice([1], [1], [3]), "fi"),
    # the in-place arithmetic variants
    *[_row(n + "_", lambda e, n=n: getattr(e.fresh(), n + "_")(e.y),
        "fi" if n in ("add", "subtract", "multiply", "remainder") else "f")
      for n in ("add", "subtract", "multiply", "divide", "remainder")],
    *[_row(n + "_", lambda e, n=n: getattr(e.fresh(), n + "_")())
      for n in ("floor", "ceil", "exp", "sqrt", "reciprocal", "round",
                "tanh")],
    _row("clip_", lambda e: e.fresh().clip_(2.0, 6.0)),
    _row("scale_", lambda e: e.fresh().scale_(2.0, 1.0)),
    _row("cast_", lambda e: e.fresh().cast_("int32")),
    _row("fill_", lambda e: e.fresh().fill_(3.0), "fi"),
    _row("uniform_", lambda e: e.fresh().uniform_(), random=True),
    _row("normal_", lambda e: e.fresh().normal_(), random=True),
    # the JAX Tensor's own methods
    _row("rank", lambda e: e.P.to_tensor(e.x.rank()), "fi"),
    _row("dim", lambda e: e.P.to_tensor(e.x.dim()), "fi"),
    _row("value", lambda e: e.x.value(), "fi"),
    _row("get_tensor", lambda e: e.x.get_tensor(), "fi"),
    _row("item", lambda e: e.P.to_tensor([e.x.item(5), e.x.item(1, 2)]), "fi"),
    _row("tolist", lambda e: e.P.to_tensor(e.x.tolist()), "fi"),
    _row("numpy", lambda e: e.P.to_tensor(e.x.numpy()), "fi"),
    _row("astype", lambda e: e.x.astype("float64"), "fi"),
    _row("detach", lambda e: e.x.detach(), "fi"),
    _row("clone", lambda e: e.x.clone(), "fi"),
    _row("zero_", lambda e: e.fresh().zero_(), "fi"),
    _row("set_value", lambda e: e.fresh().set_value(np.zeros((2, 4))), "fi"),
    _row("cpu", lambda e: e.x.cpu(), "fi"),
]
