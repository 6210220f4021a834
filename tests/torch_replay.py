"""Replaying the JAX package's op cases against the port, on the CPU.

Shared by tests/test_torch_op_suite.py and tests/test_torch_op_tail.py
(this file holds no tests). A case's inputs go through the JAX package
and the port alike; their outputs, and the gradients that each
package's autograd gives for a fixed random cotangent, must agree:

- integer, bool and index outputs: exactly;
- float32 (and complex64) outputs: |port - jax| <= 1e-5 * (|jax| +
  max |jax|), a relative bound with a floor at the output's scale;
- float64 (gradients are taken at float64 inputs, as the JAX harness
  takes them): the same with 1e-10;
- decompositions and solves defined only up to sign or basis (qr, svd,
  eig, eigh) are compared after fixing each column's sign or phase, at
  1e-4.
"""
from __future__ import annotations

import ast
import functools
import importlib
import types
from pathlib import Path

import numpy as np
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.testing import op_cases

SLICE = ("creation", "math", "logic", "manipulation", "linalg", "search",
         "array_ops", "random_ops")
JMODS = {m: importlib.import_module(f"paddle_tpu.ops.{m}") for m in SLICE}
TMODS = {m: importlib.import_module(f"paddle_tpu_torch.ops.{m}")
         for m in SLICE}

DECOMP_TOL = op_cases.DECOMP_TOL
DECOMPOSITIONS = {"qr", "svd", "eig", "eigh"}


def slice_op_types():
    """The op types the eight JAX modules register."""
    from paddle_tpu.core.dispatch import get_op, registered_ops
    mods = {f"paddle_tpu.ops.{m}" for m in SLICE}
    return {t for t in registered_ops()
            if get_op(t).raw_fn.__module__ in mods}


def _slice_name(api):
    for m in SLICE:
        for n, o in vars(JMODS[m]).items():
            if o is api and not n.startswith("_"):
                return m, n
    return None


def reaches_slice(case) -> bool:
    """The case's api is a function of the eight modules, or it is a
    lambda over ops that they register."""
    if _slice_name(case.api) is not None:
        return True
    return bool(set(case.op_types) & slice_op_types()) and \
        getattr(case.api, "__name__", "") == "<lambda>"


def port_api(api):
    """The port's counterpart of a JAX case's api: the function of the
    same name in the port's module, or the lambda itself with `paddle`
    and `F` bound to the port."""
    found = _slice_name(api)
    if found is not None:
        return getattr(TMODS[found[0]], found[1])
    g = dict(api.__globals__)
    g.update(paddle=tpaddle, F=TF)
    return types.FunctionType(api.__code__, g, api.__name__,
                              api.__defaults__, api.__closure__)


def flat(out):
    if torch.is_tensor(out) or isinstance(out, jpaddle.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat(o)]
    return []


def to_numpy(t):
    return np.asarray(t.numpy())


def assert_close(got, want, what, tol=None):
    msg = op_cases.agree(got, want, tol)
    assert msg is None, (what, msg)


def assert_decomposition(name, got, want, what):
    got, want = op_cases.gauge(name, got), op_cases.gauge(name, want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"{what} output {i}", DECOMP_TOL)


def _tensor_args(pkg, args, stop_gradient):
    return [pkg.to_tensor(a, stop_gradient=stop_gradient)
            if isinstance(a, np.ndarray) else a for a in args]


def _f64(args):
    return [a.astype(np.float64)
            if isinstance(a, np.ndarray) and a.dtype == np.float32 else a
            for a in args]


def gradients(api, pkg, args, kwargs, wrt, out_sel):
    """d sum(out[out_sel] * w) / d args[i] for i in wrt, at float64
    inputs, w a fixed random cotangent."""
    targs = _tensor_args(pkg, _f64(args), False)
    out = flat(api(*targs, **kwargs))[out_sel]
    w = np.random.RandomState(1234).uniform(0.5, 1.5,
                                            size=tuple(out.shape))
    (out * pkg.to_tensor(w.astype(to_numpy(out).dtype))).sum().backward()
    return [None if targs[i].grad is None else to_numpy(targs[i].grad)
            for i in wrt]


def replay(case):
    """Run one JAX OpTestCase on both packages and hold the port to the
    JAX package's forward and gradients."""
    tapi = port_api(case.api)
    replay_call(case.name, lambda P, *a: (case.api if P is jpaddle else tapi)(
        *a, **case.kwargs), case.args, case.grad, case.out_sel,
        case.api.__name__ if case.api.__name__ in DECOMPOSITIONS else None)


def replay_call(name, fn, args, grad=(), out_sel=0, decomposition=None):
    """fn(pkg, *tensors) on both packages (the ndarray args as Tensors,
    the rest as they are): outputs, and gradients for the args in grad,
    held to the JAX package's as replay() holds them."""
    want = [to_numpy(t) for t in flat(fn(jpaddle, *_tensor_args(
        jpaddle, args, True)))]
    got = [to_numpy(t) for t in flat(fn(tpaddle, *_tensor_args(
        tpaddle, args, True)))]
    assert want and len(got) == len(want), (name, len(got), len(want))
    if decomposition:
        assert_decomposition(decomposition, got, want, name)
    else:
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{name} output {i}")
    if grad:
        grads = [gradients(functools.partial(fn, P), P, args, {}, grad,
                           out_sel) for P in (jpaddle, tpaddle)]
        for i, w, g in zip(grad, *grads):
            if w is None:
                assert g is None or not np.any(g), (name, i)
                continue
            assert g is not None, (name, i, "no gradient")
            assert_close(g, w, f"{name} grad of arg {i}")


__all__ = ["SLICE", "JMODS", "TMODS", "slice_op_types", "reaches_slice",
           "port_api", "replay", "replay_call", "assert_close", "flat",
           "to_numpy", "JF", "TF"]


# ------------------------------------------ the case table of the chip
# The replayed cases, written out for runs with no JAX (chip_smoke.py's
# phase 31 and tests/test_torch_cuda.py replay them on CUDA against the
# port's CPU): paddle_tpu_torch/testing/op_cases.json (names, apis or
# lambda sources, kwargs) and op_cases.npz (the inputs).
# tests/test_torch_op_suite.py holds the committed files to the tables;
# `python tests/torch_replay.py` writes them again.
CASE_FILE = Path(tpaddle.__file__).parent / "testing" / "op_cases"


def _lambda_source(fn):
    src_file = fn.__code__.co_filename
    tree = ast.parse(Path(src_file).read_text())
    src = Path(src_file).read_text()
    names = list(fn.__code__.co_varnames[:fn.__code__.co_argcount])
    for node in ast.walk(tree):
        if isinstance(node, ast.Lambda) and \
                node.lineno == fn.__code__.co_firstlineno and \
                [a.arg for a in node.args.args] == names:
            return ast.get_source_segment(src, node)
    raise LookupError(f"no source for {fn} in {src_file}")


def _encode(v, key, arrays):
    if isinstance(v, np.ndarray):
        arrays[key] = v
        return {"array": key}
    if isinstance(v, (list, tuple)) and any(isinstance(a, np.ndarray)
                                            for a in v):
        return {"list": [_encode(a, f"{key}.{i}", arrays)
                         for i, a in enumerate(v)]}
    if isinstance(v, np.generic):
        return {"value": v.item()}
    return {"value": v}


def _spec(name, api, args, kwargs, grad, out_sel, decomposition, arrays,
          takes_pkg=False):
    spec = {"name": name, "api": None, "lambda": None,
            "takes_pkg": takes_pkg, "defaults": None, "globals": [],
            "args": [_encode(a, f"{name}/{i}", arrays)
                     for i, a in enumerate(args)],
            "kwargs": {k: _encode(v, f"{name}/{k}", arrays)
                       for k, v in kwargs.items()},
            "grad": list(grad), "out_sel": out_sel,
            "decomposition": decomposition}
    found = _slice_name(api)
    if found is not None:
        spec["api"] = ".".join(found)
        return spec
    spec["lambda"] = _lambda_source(api)
    if api.__defaults__:
        spec["defaults"] = [_encode(d, f"{name}/default{i}", arrays)
                            for i, d in enumerate(api.__defaults__)]
    for g in api.__code__.co_names:
        if isinstance(api.__globals__.get(g), np.ndarray):
            arrays[f"{name}/global/{g}"] = api.__globals__[g]
            spec["globals"].append(g)
    return spec


def case_spec():
    """(specs, arrays) of every replayed case, in the tables' order."""
    import test_op_grad_suite as grad_suite
    import test_op_suite as suite
    import test_torch_op_tail as tail
    specs, arrays = [], {}
    for src, table in (("op_suite", suite.ALL_CASES),
                       ("op_grad_suite", grad_suite.GRAD_CASES)):
        for i, c in enumerate(table):
            if reaches_slice(c):
                specs.append(_spec(
                    f"{src}:{i}:{c.name}", c.api, c.args, c.kwargs, c.grad,
                    c.out_sel, c.api.__name__ if c.api.__name__ in
                    DECOMPOSITIONS else None, arrays))
    for p in tail.CASES:
        fn, args, grad, out_sel = p.values
        specs.append(_spec(f"op_tail:{p.id}", fn, args, {}, grad, out_sel,
                           None, arrays, takes_pkg=True))
    return specs, arrays


def write_case_spec():
    import json
    specs, arrays = case_spec()
    CASE_FILE.with_suffix(".json").write_text(
        "[\n" + ",\n".join(json.dumps(s) for s in specs) + "\n]\n")
    np.savez_compressed(CASE_FILE.with_suffix(".npz"), **arrays)


if __name__ == "__main__":
    write_case_spec()
