"""Paddle's Tensor methods on the port's Tensor, against the JAX package.

`ROWS` (paddle_tpu_torch/testing/op_cases.py METHOD_ROWS, which
chip_smoke.py's phase 31 also runs on the card) is a declarative table
with one row per method of the JAX
package's Tensor method table (paddle_tpu/ops/__init__.py
`_attach_tensor_methods`: the function names, the in-place variants,
fill_/uniform_/normal_) and per method the JAX Tensor defines itself.
Each row calls the method with Paddle-style arguments on the same
float32 (and, where the method takes integers, int64) inputs in both
packages, and the port's result must equal the JAX package's at the
tolerances of tests/torch_replay.py (float32 1e-5 relative, integer
and index outputs exact). Random methods are held to shape, dtype and
range here and in distribution in tests/test_torch_random_ops.py.

Then: every public name of the JAX Tensor exists on the port's Tensor
but `tpu` (this card has no TPU; `cuda()` stands in); `size` stays
torch's method (core/tensor.py). Each example of ROADMAP Queue 3 item
8, where the port answered with torch's method or raised, is a case of
its own; every result survives repr, pickle and deepcopy; parameters
keep exactly TORCH_ON_PARAMETERS of torch's methods and take the
Paddle table for every other name; and `paddle.clip(x)` / `x.clip()`
with no bounds return x (Queue 3 item 9).
"""
import copy
import io
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core.tensor import TORCH_ON_PARAMETERS, EagerParamBase
from paddle_tpu_torch.ops import INPLACE_NAMES, METHOD_NAMES
from paddle_tpu_torch.testing import op_cases
from torch_replay import assert_close, flat, to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_device():
    from paddle_tpu_torch.core import place
    prev = place._default
    tpaddle.set_device("cpu")
    yield
    place._default = prev


X = op_cases.METHOD_X
ROWS = [pytest.param(*row, id=row[0]) for row in op_cases.METHOD_ROWS]
Env = op_cases.MethodEnv


# the JAX package's slice() and strided_slice() fail in the JAX package
# itself (`_slice` and `_strided_slice` call the module's own `slice`
# for Python's builtin, ROADMAP Queue 3 item 6): the port's rows are
# held to numpy
NUMPY_REFERENCE = {"slice": lambda x: x[:, 1:3],
                   "strided_slice": lambda x: x[:, 3:0:-1]}

# names with no row: autograd and device plumbing, exercised by
# tests/test_torch_eager.py and tests/test_torch_autograd.py (backward,
# grads, hooks, clear_grad), `to`/`cuda`/`pin_memory` (devices), `tpu`
# (not ported), `size` (torch's)
NO_ROW = {"backward", "register_hook", "retain_grads", "clear_grad",
          "clear_gradient", "to", "cuda", "pin_memory", "tpu", "size"}


def _outputs(name, call, P, dtype):
    out = call(Env(P, dtype))
    return [to_numpy(t) for t in flat(out)] if flat(out) else \
        [np.asarray(out)]


ROW_CASES = [pytest.param(*p.values, dtype, id=f"{p.id}-{dtype}")
             for p in ROWS for k, dtype in (("f", "float32"),
                                            ("i", "int64"))
             if k in p.values[2]]


@pytest.mark.parametrize("name,call,kinds,random,dtype", ROW_CASES)
def test_method_row_matches_jax(name, call, kinds, random, dtype):
    got = _outputs(name, call, tpaddle, dtype)
    if name in NUMPY_REFERENCE:
        want = [NUMPY_REFERENCE[name](X.astype(dtype))]
    else:
        want = _outputs(name, call, jpaddle, dtype)
    assert len(got) == len(want), (name, len(got), len(want))
    for g, w in zip(got, want):
        if random:
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert np.isfinite(g).all(), name
            continue
        assert_close(g, w, f"{name}[{dtype}]")


def test_rows_cover_the_jax_tensor():
    """Every public method of the JAX Tensor has a row, or is in NO_ROW
    with its reason; every name of the port's table has a row."""
    rows = {p.values[0] for p in ROWS}
    jax_methods = {n for n in dir(jpaddle.Tensor) if not n.startswith("_")
                   and callable(getattr(jpaddle.Tensor, n, None))}
    missing = sorted(jax_methods - rows - NO_ROW)
    assert not missing, missing
    table = set(METHOD_NAMES) | {n + "_" for n in INPLACE_NAMES} | {
        "fill_", "uniform_", "normal_"}
    assert table <= rows | {"transpose", "clip", "cast"}, sorted(
        table - rows)


def test_every_jax_tensor_name_exists():
    """Every public name of the JAX Tensor exists on the port's Tensor,
    but tpu; size is torch's method (a property in the JAX package)."""
    names = {n for n in dir(jpaddle.Tensor) if not n.startswith("_")}
    missing = sorted(n for n in names - {"tpu"}
                     if not hasattr(tpaddle.Tensor, n))
    assert not missing, missing
    assert tpaddle.Tensor.size is torch.Tensor.size
    assert not hasattr(tpaddle.Tensor, "tpu")


# ---------------------------------------------- ROADMAP Queue 3 item 8
QUEUE3_ITEM8 = {
    "median": lambda P, x: x.median(),
    "split(2)": lambda P, x: x.split(2),
    "max(axis=1)": lambda P, x: x.max(axis=1),
    "min(axis=1)": lambda P, x: x.min(axis=1),
    "sort": lambda P, x: x.sort(),
    "histogram": lambda P, x: x.histogram(),
    "numel": lambda P, x: x.numel(),
    "cumsum": lambda P, x: x.cumsum(),
    "logsumexp": lambda P, x: x.logsumexp(),
    "flip(axis=1)": lambda P, x: x.flip(axis=1),
    "norm(axis=1)": lambda P, x: x.norm(axis=1),
    "unique(axis=1)": lambda P, x: x.unique(axis=1),
    "split(2, axis=1)": lambda P, x: x.split(2, axis=1),
    "gather": lambda P, x: x.gather(P.to_tensor(np.array([1]))),
    "item(0)": lambda P, x: P.to_tensor(x.item(0)),
    "scale": lambda P, x: x.scale(3.0),
    "stack": lambda P, x: type(x).stack([x, x]),
    "unstack": lambda P, x: x.unstack(),
    "mod": lambda P, x: x.mod(P.to_tensor(np.float32(3))),
    "equal_all": lambda P, x: x.equal_all(x),
    "reshape_": lambda P, x: x.clone().reshape_([4, 2]),
    "is_empty": lambda P, x: x.is_empty(),
}


@pytest.mark.parametrize("example", sorted(QUEUE3_ITEM8))
def test_queue3_item8_example_matches_jax(example):
    """Each example the port answered with torch's method (or raised
    on, or lacked) now gives the JAX package's result."""
    fn = QUEUE3_ITEM8[example]
    want = flat(fn(jpaddle, jpaddle.to_tensor(X)))
    got = flat(fn(tpaddle, tpaddle.to_tensor(X)))
    assert len(got) == len(want), example
    for g, w in zip(got, want):
        assert isinstance(g, tpaddle.Tensor), (example, type(g))
        assert_close(to_numpy(g), to_numpy(w), example)


def test_stack_and_unstack_are_methods():
    """x.stack and x.unstack exist as in the JAX package (Paddle's
    stack(x, axis) takes the list as its first argument)."""
    x = tpaddle.to_tensor(X)
    assert tpaddle.Tensor.stack is tpaddle.stack
    np.testing.assert_array_equal(tpaddle.Tensor.stack([x, x], 1).numpy(),
                                  np.stack([X, X], 1))
    assert [u.shape for u in x.unstack(axis=1)] == [[2]] * 4


@pytest.mark.parametrize("name,call,kinds,random", ROWS)
def test_method_result_reprs_pickles_and_deepcopies(name, call, kinds,
                                                     random):
    """Every row's result prints, pickles (pickle and torch.save) and
    deep-copies, and comes back a Tensor with the same values."""
    out = call(Env(tpaddle, "float32" if "f" in kinds else "int64"))
    for t in flat(out):
        assert "Tensor(" in repr(t)
        back = pickle.loads(pickle.dumps(t))
        assert type(back) is type(t)
        np.testing.assert_array_equal(to_numpy(back), to_numpy(t))
        buf = io.BytesIO()
        torch.save(t, buf)
        buf.seek(0)
        assert type(torch.load(buf, weights_only=False)) is type(t)
        if t.requires_grad and not t.is_leaf:
            t = t.detach()
        dup = copy.deepcopy(t)
        assert type(dup) is type(t)
        np.testing.assert_array_equal(to_numpy(dup), to_numpy(t))


# ----------------------------------------------------- the parameter rule
def test_parameters_keep_exactly_the_stated_torch_methods():
    """EagerParamBase keeps torch's method for TORCH_ON_PARAMETERS and
    takes the Paddle table for every other name, as a JAX parameter
    does."""
    assert set(TORCH_ON_PARAMETERS) == {"numel", "size"}
    table = set(METHOD_NAMES) | {n + "_" for n in INPLACE_NAMES} | {
        "fill_", "uniform_", "normal_"}
    kept = {n for n in vars(EagerParamBase)
            if getattr(torch.Tensor, n, None) is vars(EagerParamBase)[n]}
    assert kept == set(TORCH_ON_PARAMETERS), kept
    for n in sorted(table - set(TORCH_ON_PARAMETERS)):
        assert getattr(EagerParamBase, n) is getattr(tpaddle.Tensor, n), n
    p = tpaddle.nn.Linear(4, 3).weight
    assert p.numel() == 12 and isinstance(p.numel(), int)
    assert p.size() == torch.Size([4, 3])
    x = tpaddle.to_tensor(X)
    assert isinstance(x.numel(), tpaddle.Tensor)
    parts = p.split(3, axis=1)  # Paddle's count, not torch's size
    assert len(parts) == 3
    np.testing.assert_allclose(to_numpy(parts[0].detach()),
                               to_numpy(p.detach())[:, :1])
    got = p.max(axis=0)
    assert torch.is_tensor(got) and list(got.shape) == [3]


def test_parameter_repr_pickle_deepcopy():
    p = tpaddle.nn.Linear(2, 3).weight
    assert repr(p).startswith("Parameter containing:\nEagerParamBase(")
    dup = copy.deepcopy(p)
    assert type(dup) is EagerParamBase and dup.name == p.name
    np.testing.assert_array_equal(to_numpy(dup.detach()),
                                  to_numpy(p.detach()))
    back = pickle.loads(pickle.dumps(p))
    np.testing.assert_array_equal(back.detach().numpy(),
                                  p.detach().numpy())


# -------------------------------------------------- ROADMAP Queue 3 item 9
def test_clip_with_no_bounds_returns_x():
    for P in (jpaddle, tpaddle):
        x = P.to_tensor(X)
        np.testing.assert_array_equal(to_numpy(P.clip(x)), X)
        np.testing.assert_array_equal(to_numpy(x.clip()), X)
    x = tpaddle.to_tensor(X)
    assert x.clip_() is x
    np.testing.assert_array_equal(to_numpy(x), X)
