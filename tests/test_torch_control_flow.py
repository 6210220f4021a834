"""ops/control_flow.py of the port against the JAX package's, on the CPU.

Eagerly, while_loop / cond / case / switch_case run Python control flow
on the concrete values in both packages: the results and the gradients
through cond's operands agree (float32, 1e-6). Under static capture the
port records the op types the JAX package names ("while",
"conditional_block", "switch_case") over sub-programs (the JAX package
lowers a traced call to lax.while_loop / lax.cond / lax.switch
instead); the port's Executor gives the JAX package's eager results
from the same inputs, and append_backward its eager gradients through
the captured cond.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import place as _place

PKGS = (paddle_tpu, paddle_tpu_torch)
X = np.array([0.5, -1.5, 2.0, 0.25], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    _place._default = prev


def _cf(pkg):
    return pkg.ops.control_flow


def _np(t):
    return np.asarray(t.numpy())


def _loop(cf, x, bound):
    """sum of x over `bound` trips and the trip count."""
    return cf.while_loop(lambda i, s: i < bound,
                         lambda i, s: (i + 1, s + x.sum()),
                         [x.sum() * 0.0, x.sum() * 0.0])


def _branches(cf, x):
    return cf.cond(x.sum() > 0, lambda a: (a * 3.0).sum(),
                   lambda a: (a * 5.0).sum(), operands=[x])


def _switch(cf, i, x):
    return cf.switch_case(i, {1: lambda: x * 2.0, 3: lambda: x + 1.0},
                          default=lambda: x * 0.0)


def _case(cf, x):
    return cf.case([(x.sum() > 10, lambda: x * 10.0),
                    (x.sum() > 0, lambda: x - 1.0)], default=lambda: -x)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_eager_forms_match_jax(sign):
    out = []
    for pkg in PKGS:
        cf = _cf(pkg)
        x = pkg.to_tensor(sign * X)
        i, s = _loop(cf, x, 4.0)
        res = [_np(i), _np(s), _np(_branches(cf, x)), _np(_case(cf, x))]
        for idx in (0, 1, 2, 3, 7):
            res.append(_np(_switch(cf, pkg.to_tensor(idx), x)))
        res.append(_np(cf.switch_case(pkg.to_tensor(1),
                                      [lambda: x, lambda: x * 4.0])))
        out.append(res)
    for w, g in zip(*out):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_allclose(out[1][1], 4 * (sign * X).sum(), rtol=1e-6)


def test_cond_operands_carry_gradients():
    """The operand rule: the gradient reaches the tensor both branches
    read, through the branch taken."""
    grads = []
    for pkg in PKGS:
        cf = _cf(pkg)
        x = pkg.to_tensor(X, stop_gradient=False)
        w = pkg.to_tensor(np.full(4, 2.0, np.float32), stop_gradient=False)
        out = cf.cond(x.sum() > 0, lambda a, b: (a * b).sum(),
                      lambda a, b: (a - b).sum(), operands=[x, w])
        grads.append([_np(g) for g in pkg.grad(out, [x, w])])
    for w, g in zip(*grads):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_allclose(grads[1][0], np.full(4, 2.0))


def test_empty_case_raises_in_both():
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _cf(pkg).case([])


def _jax_eager(fn, *arrays):
    return [np.asarray(o.numpy()) for o in fn(_cf(paddle_tpu), *[
        paddle_tpu.to_tensor(a) for a in arrays])]


def _captured(build, feeds, with_grad=False):
    """build(control_flow, x, i) on static.data Variables in the port:
    (op types, Executor outputs for each feed dict)."""
    pt = paddle_tpu_torch
    static = pt.static
    main, startup = static.Program(), static.Program()
    pt.enable_static()
    try:
        with static.program_guard(main, startup):
            x = static.data("x", [4], "float32")
            x.stop_gradient = False
            i = static.data("i", [], "int64")
            outs = list(build(_cf(pt), x, i))
            if with_grad:
                outs += [g for g in static.gradients([outs[0]], [x])]
    finally:
        pt.disable_static()
    exe = static.Executor(pt.CPUPlace())
    return ([od.type for od in main.ops],
            [exe.run(main, feed=f, fetch_list=outs) for f in feeds])


def test_captured_ops_match_jax_eager_results():
    """Under capture: one "while", one "switch_case" and two
    "conditional_block" ops in the program (cond's, and case's first
    pair: its second lies in that op's false branch), and the
    Executor's values for several inputs equal the JAX package's eager
    ones."""
    def build(cf, x, i):
        trips, total = _loop(cf, x, 3.0)
        return (total, trips, _branches(cf, x), _switch(cf, i, x),
                _case(cf, x))

    feeds = [{"x": s * X, "i": np.array(k, np.int64)}
             for s, k in ((1.0, 1), (-1.0, 3), (1.0, 2), (4.0, 9))]
    types, runs = _captured(build, feeds)
    assert types.count("while") == 1 and types.count("switch_case") == 1
    assert types.count("conditional_block") == 2
    for f, got in zip(feeds, runs):
        def jax_build(cf, x, i):
            trips, total = _loop(cf, x, 3.0)
            return [total, trips, _branches(cf, x), _switch(cf, i, x),
                    _case(cf, x)]
        want = _jax_eager(jax_build, f["x"], f["i"])
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-6)


def test_captured_cond_gradient_matches_jax_eager():
    """static.gradients through a captured cond (the operands are the
    op's inputs) equal the JAX package's eager gradient."""
    def build(cf, x, i):
        return [_branches(cf, x * x)]

    feeds = [{"x": s * X, "i": np.array(0, np.int64)} for s in (1.0, -1.0)]
    types, runs = _captured(build, feeds, with_grad=True)
    assert "conditional_block" in types
    for f, (val, grad) in zip(feeds, runs):
        x = paddle_tpu.to_tensor(f["x"], stop_gradient=False)
        out = _branches(_cf(paddle_tpu), x * x)
        (g,) = paddle_tpu.grad(out, [x])
        np.testing.assert_allclose(val, _np(out), rtol=1e-6)
        np.testing.assert_allclose(grad, _np(g), rtol=1e-6)


def test_ops_namespace_has_control_flow():
    for pkg in PKGS:
        assert pkg.ops.control_flow.__name__.endswith("ops.control_flow")


def _static_nn_cond_grad(P, xv):
    static = P.static
    x = static.data("x", [4], "float32")
    x.stop_gradient = False
    y = x * x
    out = static.nn.cond(y.sum() > 0, lambda: (y * 3.0).sum(),
                         lambda: (y * 5.0).sum())
    grads = static.gradients([out], [x])
    exe = P.exe()
    return exe.run(static.default_main_program(), feed={"x": xv},
                   fetch_list=[out] + list(grads))


def test_static_nn_cond_gradient_matches_the_jax_program():
    """static.nn.cond inside a program that static.gradients
    differentiates: the branch's sub-program runs with autograd on, so
    the gradient reaches x (the port's Executor ran sub-programs without
    autograd and gave zeros until the repair of ROADMAP Queue 3 item
    14); both packages' programs agree."""
    from torch_static_twins import run_both
    j, t = run_both(_static_nn_cond_grad, X)
    for w, g in zip(j, t):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_allclose(t[1], 6.0 * X, rtol=1e-6)
