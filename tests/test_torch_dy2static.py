"""Twins of tests/test_dy2static.py on the port's jit.to_static and
dy2static, on the CPU.

Each case runs the same module-level functions on `paddle_tpu` and on
`paddle_tpu_torch` (`P` is the package a case runs on: the converted
code reads the live module globals, so a function names its package
through it) from the same numpy inputs, holds the port to the JAX
package's results (float32, 1e-6 unless a case says otherwise) and to
the original's assertions. The JAX package compiles the converted
function with jax.jit; the port runs it eagerly, and lowers a Variable
predicate to the static ops only under a capture: concrete_program's
Program has the op types of the JAX package's static capture of the
same function, and a converted if / while captured under
static.program_guard runs in the Executor with the eager results.

The port differs on purpose in one place (ROADMAP Queue 3 item 6): the
JAX StaticFunction calls its compiled function outside the eager tape,
so a to_static Layer gives its parameters no gradient; the port's keeps
autograd, as reference Paddle's run_program op does.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import place as _place
from torch_static_twins import run_both

PKGS = (paddle_tpu, paddle_tpu_torch)
P = None  # the package the running case's functions use


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


def _on(pkg):
    global P
    P = pkg
    return pkg


def _both(fn, *args):
    eager = fn(*args)
    static = P.jit.to_static(fn)(*args)
    return eager, static


def _twin(body, rtol=1e-6, atol=1e-6):
    """body(paddle) -> list of arrays; the port's must match the JAX
    package's."""
    want, got = (body(_on(p)) for p in PKGS)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return got


# ----------------------------------------------------------- the functions
def _if_else(x):
    if x.mean() > 0:
        y = x * 2
    else:
        y = x - 1
    return y.sum()


def _if_augmented(x):
    y = x * 1.0
    if x.sum() > 0:
        y += 10.0
    return y.sum()


def _while_tensor_counter(x):
    i = P.to_tensor(0)
    s = (x * 0.0).sum()
    while i < 5:
        s = s + x.sum()
        i = i + 1
    return s


def _collatz_steps(n):
    steps = P.to_tensor(0)
    v = n * 1
    while v > 1:
        nxt_even = v // 2
        nxt_odd = v * 3 + 1
        is_even = (v % 2) == 0
        v = P.where(is_even, nxt_even, nxt_odd)
        steps = steps + 1
    return steps


def _while_body_local(x):
    i = 0
    while i < 3:
        last = x * (i + 1)
        i = i + 1
    return last.sum()


def _nested_if_in_while(x):
    i = P.to_tensor(0)
    acc = (x * 0.0).sum()
    while i < 4:
        if i % 2 == 0:
            acc = acc + x.sum()
        else:
            acc = acc - 1.0
        i = i + 1
    return acc


def _python_flag(x, flag):
    if flag:
        return x * 2
    return x * 3


def _grad_of_branchy(x):
    x.stop_gradient = False
    with P.enable_grad():
        if x.sum() > 0:
            y = x * 3.0
        else:
            y = x * 5.0
        (g,) = P.grad(y.sum(), [x])
    return g


def _untaken(x):
    if x.sum() > 100:
        y = x * 2
    return y  # noqa: F821  (intentional: y may be unbound)


def _uses_late_helper(x):
    if x.sum() > 0:
        z = _late_helper(x)
    else:
        z = x.sum()
    return z


def _late_helper(x):
    return x.sum() * 2


def _times_two_sum(x):
    return (x * 2).sum()


def _left_alone(x):
    if x.sum() > 0:
        y = x
    else:
        y = -x
    return y.sum()


def _gated_net(pkg):
    """test_dy2static.py's GatedNet over pkg's Layer."""
    class GatedNet(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = pkg.nn.Linear(4, 4)
            self.b = pkg.nn.Linear(4, 4)

        def forward(self, x):
            h = self.a(x)
            if h.mean() > 0:
                out = self.b(h)
            else:
                out = h * 0.5
            return out.sum()
    return GatedNet


# ------------------------------------------------------------------ twins
def test_data_dependent_if():
    def body(paddle):
        out = []
        for v in (2.0, -2.0):
            e, s = _both(_if_else, paddle.to_tensor(np.full(4, v,
                                                            np.float32)))
            np.testing.assert_allclose(s.numpy(), e.numpy(), rtol=1e-6)
            out.append(s.numpy())
        assert float(out[0]) == 16.0 and float(out[1]) == -12.0
        return out
    _twin(body)


def test_if_augmented_assignment_and_else_missing():
    def body(paddle):
        out = []
        for a in (np.ones(3, np.float32), -np.ones(3, np.float32)):
            e, s = _both(_if_augmented, paddle.to_tensor(a))
            np.testing.assert_allclose(s.numpy(), e.numpy(), rtol=1e-6)
            out.append(s.numpy())
        return out
    _twin(body)


def test_data_dependent_while():
    def body(paddle):
        e, s = _both(_while_tensor_counter,
                     paddle.to_tensor(np.ones(4, np.float32)))
        np.testing.assert_allclose(s.numpy(), e.numpy())
        np.testing.assert_allclose(e.numpy(), 20.0)
        return [s.numpy()]
    _twin(body)


def test_while_with_tensor_bound():
    def body(paddle):
        e, s = _both(_collatz_steps, paddle.to_tensor(np.array(6)))
        assert int(e.numpy()) == int(s.numpy()) == 8
        return [s.numpy()]
    _twin(body)


def test_while_body_local_survives_eager_path():
    def body(paddle):
        e, s = _both(_while_body_local,
                     paddle.to_tensor(np.ones(2, np.float32)))
        np.testing.assert_allclose(s.numpy(), e.numpy())
        np.testing.assert_allclose(e.numpy(), 6.0)
        return [s.numpy()]
    _twin(body)


def test_nested_if_in_while():
    def body(paddle):
        e, s = _both(_nested_if_in_while,
                     paddle.to_tensor(np.ones(3, np.float32)))
        np.testing.assert_allclose(s.numpy(), e.numpy())
        np.testing.assert_allclose(e.numpy(), 4.0)
        return [s.numpy()]
    _twin(body)


def test_python_if_on_concrete_values_untouched():
    def body(paddle):
        x = paddle.to_tensor(np.ones(2, np.float32))
        a = paddle.jit.to_static(_python_flag)(x, True).numpy()
        b = paddle.jit.to_static(_python_flag)(x, False).numpy()
        np.testing.assert_allclose(a, 2.0 * np.ones(2))
        np.testing.assert_allclose(b, 3.0 * np.ones(2))
        return [a, b]
    _twin(body)


def test_grad_through_converted_control_flow():
    def body(paddle):
        eager = _grad_of_branchy(paddle.to_tensor(np.ones(3, np.float32)))
        np.testing.assert_allclose(eager.numpy(), np.full(3, 3.0))
        fn = paddle.jit.to_static(_grad_of_branchy)
        pos = fn(paddle.to_tensor(np.ones(3, np.float32))).numpy()
        neg = fn(paddle.to_tensor(-np.ones(3, np.float32))).numpy()
        np.testing.assert_allclose(pos, np.full(3, 3.0))
        np.testing.assert_allclose(neg, np.full(3, 5.0))
        return [pos, neg]
    _twin(body)


def test_layer_forward_with_control_flow():
    """The same weights in both packages (the JAX net's, copied), the
    converted forward against the eager one, and the original's strict
    parity between two nets built under one seed and name guard."""
    x = np.random.RandomState(0).randn(2, 4).astype("float32")
    state = {}

    def body(paddle):
        GatedNet = _gated_net(paddle)
        paddle.seed(0)
        net = GatedNet()
        snet = paddle.jit.to_static(GatedNet())
        if not state:
            state.update({k: np.asarray(v.numpy())
                          for k, v in net.state_dict().items()})
        net.set_state_dict(state)
        snet.set_state_dict(state)
        xt = paddle.to_tensor(x)
        eager, static = net(xt).numpy(), snet(xt).numpy()
        np.testing.assert_allclose(static, eager, rtol=1e-5)
        paddle.seed(0)
        with paddle.utils.unique_name.guard():
            net1 = GatedNet()
        paddle.seed(0)
        with paddle.utils.unique_name.guard():
            net2 = paddle.jit.to_static(GatedNet())
        np.testing.assert_allclose(net2(xt).numpy(), net1(xt).numpy(),
                                   rtol=1e-5)
        return [eager, static]
    _twin(body, rtol=1e-5)


def test_untaken_branch_variable_is_loud():
    """The JAX package's traced if raises ValueError; the port's eager
    run raises UnboundLocalError where the unassigned name is returned,
    as dygraph does."""
    for pkg in PKGS:
        _on(pkg)
        fn = pkg.jit.to_static(_untaken)
        with pytest.raises((ValueError, UnboundLocalError)):
            fn(pkg.to_tensor(np.zeros(2, np.float32)))


def test_late_defined_global_helper_visible():
    def body(paddle):
        out = paddle.jit.to_static(_uses_late_helper)(
            paddle.to_tensor(np.ones(2, np.float32))).numpy()
        np.testing.assert_allclose(out, 4.0)
        return [out]
    _twin(body)


def _capture_types(P_, fn, shape):
    """Op types of fn captured over static.data("x", shape) (the
    scenario of run_both)."""
    x = P_.static.data("x", shape, "float32")
    fn(x)
    return [od.type for od in P_.static.default_main_program().ops]


def test_concrete_program_inspection():
    """The port's concrete_program is a static Program (the JAX package
    returns the lowered HLO text) with the op types of the JAX package's
    static capture of the same function, and it runs in the Executor
    with the eager result."""
    _on(paddle_tpu)
    txt = paddle_tpu.jit.to_static(_times_two_sum).concrete_program(
        paddle_tpu.to_tensor(np.ones(3, np.float32)))
    assert "module" in txt or "stablehlo" in txt
    _on(paddle_tpu_torch)
    x = np.arange(3, dtype=np.float32)
    prog = paddle_tpu_torch.jit.to_static(_times_two_sum).concrete_program(
        paddle_tpu_torch.to_tensor(x))
    jax_types, _ = run_both(_capture_types, _times_two_sum, [3])
    assert [od.type for od in prog.ops] == jax_types
    assert [v.name for v in prog.inputs] == ["x"]
    exe = paddle_tpu_torch.static.Executor(paddle_tpu_torch.CPUPlace())
    (got,) = exe.run(prog, feed={"x": x}, fetch_list=[prog.outputs])
    np.testing.assert_allclose(got, 6.0)


# ------------------------------------------------------ beyond the twins
def test_layer_concrete_program_binds_parameters_and_matches_jax():
    """concrete_program of a to_static Linear + ReLU + Linear: the
    parameters are persistable Variables named as the parameters (no
    constants), the op types are the JAX package's static capture of the
    same layer's forward, and the Program run from its startup program
    gives the eager output; the live parameters come back after the
    capture."""
    _on(paddle_tpu_torch)
    x = np.random.RandomState(1).randn(2, 4).astype("float32")
    paddle_tpu_torch.seed(0)
    net = paddle_tpu_torch.nn.Sequential(
        paddle_tpu_torch.nn.Linear(4, 8), paddle_tpu_torch.nn.ReLU(),
        paddle_tpu_torch.nn.Linear(8, 2))
    params = list(net.parameters())
    want = net(paddle_tpu_torch.to_tensor(x)).numpy()
    snet = paddle_tpu_torch.jit.to_static(net)
    prog = snet._static_function.concrete_program(
        paddle_tpu_torch.to_tensor(x))
    assert list(net.parameters()) == params
    assert all(type(p).__name__ == "EagerParamBase" for p in params)
    assert not prog._consts
    persist = {v.name for v in prog.list_vars() if v.persistable}
    assert persist == {p.name for p in params}

    def jax_layer(P_, shape):
        seq = P_.p.nn.Sequential(P_.p.nn.Linear(4, 8), P_.p.nn.ReLU(),
                                 P_.p.nn.Linear(8, 2))
        return _capture_types(P_, seq, shape)

    jax_types, port_types = run_both(jax_layer, [2, 4])
    assert [od.type for od in prog.ops] == jax_types == port_types
    exe = paddle_tpu_torch.static.Executor(paddle_tpu_torch.CPUPlace())
    scope = paddle_tpu_torch.static.Scope()
    exe.run(prog.startup_program, scope=scope)
    (got,) = exe.run(prog, feed={"x": x}, fetch_list=[prog.outputs],
                     scope=scope)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_converted_control_flow_under_program_guard():
    """A to_static function called on Variables under static.program_guard
    records its if as a conditional_block and its while as a while op;
    the Executor's results equal the eager ones on both signs."""
    _on(paddle_tpu_torch)
    pt = paddle_tpu_torch
    static = pt.static
    main, startup = static.Program(), static.Program()
    pt.enable_static()
    try:
        with static.program_guard(main, startup):
            x = static.data("x", [4], "float32")
            out_if = pt.jit.to_static(_if_else)(x)
            out_while = pt.jit.to_static(_nested_if_in_while)(x)
    finally:
        pt.disable_static()
    types = [od.type for od in main.ops]
    assert "conditional_block" in types and "while" in types
    exe = static.Executor(pt.CPUPlace())
    for v in (2.0, -2.0):
        xv = np.full(4, v, np.float32)
        got = exe.run(main, feed={"x": xv}, fetch_list=[out_if, out_while])
        want = [_if_else(pt.to_tensor(xv)).numpy(),
                _nested_if_in_while(pt.to_tensor(xv)).numpy()]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)


def test_to_static_layer_gives_its_parameters_gradients():
    """The port's to_static Layer keeps autograd: loss.backward() reaches
    the weights with the undecorated layer's gradients. The JAX
    package's leaves them None (its StaticFunction calls the compiled
    function outside the eager tape: ROADMAP Queue 3 item 6)."""
    x = np.random.RandomState(2).randn(3, 4).astype("float32")
    grads = []
    for pkg in PKGS:
        lin = pkg.nn.Linear(4, 2)
        w0 = np.asarray(lin.weight.numpy())
        out = pkg.jit.to_static(lin)(pkg.to_tensor(x))
        out.sum().backward()
        grads.append(lin.weight.grad)
    assert grads[0] is None
    np.testing.assert_allclose(grads[1].numpy(),
                               np.tile(x.sum(0)[:, None], (1, 2)), rtol=1e-6)
    assert w0.shape == (4, 2)


def test_translator_switch_code_level_and_not_to_static(capsys):
    """enable_to_static(False) runs the raw function, set_code_level
    prints the transformed source at conversion, not_to_static leaves a
    function unconverted and a function without source warns: in both
    packages. The port runs both of those as written (the JAX package's
    jax.jit cannot trace their tensor `if`)."""
    for pkg in PKGS:
        _on(pkg)
        x = pkg.to_tensor(np.full(4, 2.0, np.float32))
        pkg.jit.enable_to_static(False)
        try:
            assert not pkg.jit.ProgramTranslator.get_instance().enabled
            assert float(pkg.jit.to_static(_if_else)(x).numpy()) == 16.0
        finally:
            pkg.jit.enable_to_static(True)
        pkg.jit.set_code_level(100)
        try:
            pkg.jit.to_static(_if_augmented)
        finally:
            pkg.jit.dy2static.CODE_LEVEL = None
        text = capsys.readouterr().out
        assert "transformed code for _if_augmented" in text
        assert "__jst_ifelse" in text
        fn = pkg.jit.to_static(pkg.jit.not_to_static(_left_alone))
        ns = {}
        exec("def g(x):\n    if x.sum() > 0:\n        y = x\n    else:\n"
             "        y = -x\n    return y.sum()\n", ns)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            g = pkg.jit.to_static(ns["g"])
        assert any("unavailable" in str(m.message) for m in w)
        if pkg is paddle_tpu_torch:
            assert fn._converted is _left_alone
            assert float(fn(x).numpy()) == 8.0
            assert g._converted is ns["g"]
            assert float(g(x).numpy()) == 8.0
