"""The port's static graph against the JAX package's, on the CPU: the
cases of tests/test_static.py (capture, the Executor's feed / fetch,
append_backward training, dygraph parity, control flow, save / load,
the inference artifact, clone, gradients, static AMP, program
persistence), each run on both packages from the same numpy inputs and
the same scope (the port's takes the JAX scope's values by name after
each startup run). float32 results are held to 1e-5 relative unless a
case says otherwise; the port's own contract (mode switches, the
capture's refusals, the Executor's device) follows.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import static as tstatic
from torch_static_twins import assert_close, run_both, static_mode


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------- test_static.py cases
def _capture_and_run(P):
    x = P.static.data("x", [4], "float32")
    y = x * 2.0 + 1.0
    assert len(P.static.default_main_program().ops) >= 1
    return P.exe().run(feed={"x": np.arange(4, dtype=np.float32)},
                       fetch_list=[y])


def test_capture_and_run():
    j, t = run_both(_capture_and_run)
    assert_close(j, t)
    np.testing.assert_allclose(t[0], np.arange(4) * 2.0 + 1.0)


def _feed_shape_flex(P):
    x = P.static.data("x", [-1, 3], "float32")
    y = (x * x).sum()
    exe = P.exe()
    rs = np.random.RandomState(0)
    return [exe.run(feed={"x": rs.randn(n, 3).astype(np.float32)},
                    fetch_list=[y])[0] for n in (2, 5)]


def test_feed_shape_flex_and_cache():
    j, t = run_both(_feed_shape_flex)
    assert_close(j, t)


def _missing_feed(P):
    x = P.static.data("x", [2], "float32")
    y = x + 1.0
    with pytest.raises(ValueError, match="feed is missing"):
        P.exe().run(fetch_list=[y])


def _uninitialized(P):
    lin = P.p.nn.Linear(3, 2)
    x = P.static.data("x", [-1, 3], "float32")
    out = lin(x)
    with pytest.raises(RuntimeError, match="not initialized"):
        P.exe().run(feed={"x": np.zeros((1, 3), np.float32)},
                    fetch_list=[out])


@pytest.mark.parametrize("scenario", [_missing_feed, _uninitialized],
                         ids=["missing_feed", "uninitialized_param"])
def test_executor_refusals(scenario):
    run_both(scenario)


def _append_backward(P):
    x = P.static.data("x", [8, 3], "float32")
    y = P.static.data("y", [8, 1], "float32")
    lin = P.p.nn.Linear(3, 1)
    loss = ((lin(x) - y) ** 2).mean()
    params_grads = P.static.append_backward(loss)
    assert len(params_grads) == 2
    assert params_grads[0][1].name.endswith("@GRAD")
    exe = P.exe()
    P.startup(exe)
    rs = np.random.RandomState(1)
    xs = rs.randn(8, 3).astype(np.float32)
    ys = xs @ np.array([[2.0], [-1.0], [0.5]], np.float32)
    return exe.run(P.static.default_main_program(),
                   feed={"x": xs, "y": ys},
                   fetch_list=[loss] + [g.name for _, g in params_grads])


def test_append_backward_and_sgd_training():
    j, t = run_both(_append_backward)
    assert_close(j, t)


_W0 = np.random.RandomState(0).randn(4, 8).astype(np.float32) * 0.1
_W1 = np.random.RandomState(1).randn(8, 1).astype(np.float32) * 0.1


def _static_vs_dygraph(P):
    rs = np.random.RandomState(0)
    xs = rs.randn(16, 4).astype(np.float32)
    w = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    ys = (xs @ w + 0.3).astype(np.float32)
    b0, b1 = np.zeros(8, np.float32), np.zeros(1, np.float32)
    x = P.static.data("x", [16, 4], "float32")
    y = P.static.data("y", [16, 1], "float32")
    l1, l2 = P.p.nn.Linear(4, 8), P.p.nn.Linear(8, 1)
    h = P.p.nn.functional.relu(l1(x))
    loss = ((l2(h) - y) ** 2).mean()
    P.p.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = P.exe()
    P.startup(exe)
    scope = P.static.global_scope()
    for p, v in ((l1.weight, _W0), (l1.bias, b0), (l2.weight, _W1),
                 (l2.bias, b1)):
        scope.set(p.name, torch.from_numpy(v.copy()) if P.port
                  else paddle_tpu.to_tensor(v)._value)
    static_losses = [float(exe.run(feed={"x": xs, "y": ys},
                                   fetch_list=[loss])[0]) for _ in range(5)]
    P.p.disable_static()
    try:
        d1, d2 = P.p.nn.Linear(4, 8), P.p.nn.Linear(8, 1)
        for p, v in ((d1.weight, _W0), (d1.bias, b0), (d2.weight, _W1),
                     (d2.bias, b1)):
            p.set_value(v)
        opt = P.p.optimizer.SGD(learning_rate=0.1, parameters=list(
            d1.parameters()) + list(d2.parameters()))
        dyg = []
        for _ in range(5):
            out = d2(P.p.nn.functional.relu(d1(P.p.to_tensor(xs))))
            loss_d = ((out - P.p.to_tensor(ys)) ** 2).mean()
            loss_d.backward()
            opt.step()
            opt.clear_grad()
            dyg.append(float(loss_d.numpy()))
    finally:
        P.p.enable_static()
    return static_losses, dyg


def test_static_matches_dygraph_losses():
    """Same weights and data: the static loop equals the eager one in
    each package, and the port's equals the JAX package's."""
    j, t = run_both(_static_vs_dygraph)
    np.testing.assert_allclose(t[0], t[1], rtol=1e-6)
    assert_close(j, t)


def _adam(P):
    x = P.static.data("x", [32, 10], "float32")
    y = P.static.data("y", [32, 1], "int64")
    lin = P.p.nn.Linear(10, 4)
    loss = P.p.nn.functional.cross_entropy(lin(x), y)
    P.p.optimizer.Adam(learning_rate=0.05).minimize(loss)
    exe = P.exe()
    P.startup(exe)
    rs = np.random.RandomState(1)
    xs = rs.randn(32, 10).astype(np.float32)
    ys = rs.randint(0, 4, (32, 1)).astype(np.int64)
    return [float(exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])[0])
            for _ in range(40)]


def test_adam_training_converges():
    j, t = run_both(_adam)
    assert t[-1] < t[0] * 0.3
    assert_close(j, t, rtol=1e-4, atol=1e-6)


def _lr_scheduler(P):
    x = P.static.data("x", [4, 2], "float32")
    lin = P.p.nn.Linear(2, 1)
    loss = lin(x).mean()
    sched = P.p.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                       gamma=0.5)
    P.p.optimizer.SGD(learning_rate=sched).minimize(loss)
    exe = P.exe()
    P.startup(exe)
    xs = np.ones((4, 2), np.float32)
    out = [exe.run(feed={"x": xs}, fetch_list=[loss])[0]]
    n = len(exe._cache)
    sched.step()
    out.append(exe.run(feed={"x": xs}, fetch_list=[loss])[0])
    out.append(exe.run(feed={"x": xs}, fetch_list=[loss])[0])
    assert len(exe._cache) == n  # the learning rate is read at each run
    return out


def test_lr_scheduler_no_recompile():
    j, t = run_both(_lr_scheduler)
    assert_close(j, t)


def _batch_norm(P):
    x = P.static.data("x", [8, 3], "float32")
    bn = P.p.nn.BatchNorm1D(3)
    out = bn(x)
    exe = P.exe()
    P.startup(exe)
    xs = (np.random.RandomState(2).randn(8, 3) * 2 + 5).astype(np.float32)
    got = exe.run(feed={"x": xs}, fetch_list=[out])[0]
    return got, P.value(bn._mean.name), P.value(bn._variance.name), xs


def test_batch_norm_updates_running_stats():
    j, t = run_both(_batch_norm)
    xs = t[3]
    np.testing.assert_allclose(t[1], 0.1 * xs.mean(0), rtol=1e-4)
    assert_close(j[:3], t[:3], rtol=1e-5, atol=1e-5)


def _cond(P):
    x = P.static.data("x", [], "float32")
    out = P.static.nn.cond(x > 0.0, lambda: x * 2.0, lambda: x - 1.0)
    exe = P.exe()
    return [exe.run(feed={"x": np.float32(v)}, fetch_list=[out])[0]
            for v in (3.0, -3.0)]


def _while_loop(P):
    i = P.static.data("i", [], "int64")
    s = P.static.data("s", [], "float32")
    iv, sv = P.static.nn.while_loop(lambda i, s: i < 5,
                                    lambda i, s: [i + 1, s * 2.0], [i, s])
    return P.exe().run(feed={"i": np.int64(0), "s": np.float32(1.0)},
                       fetch_list=[iv, sv])


def _case(P):
    x = P.static.data("x", [], "float32")
    idx = P.static.data("idx", [], "int64")
    c = P.static.nn.case([(x > 1.0, lambda: x * 10.0),
                          (x > 0.0, lambda: x * 100.0)],
                         default=lambda: x - 5.0)
    s = P.static.nn.switch_case(idx, {0: lambda: x + 1.0,
                                      1: lambda: x + 2.0},
                                default=lambda: x + 3.0)
    exe = P.exe()
    return [exe.run(feed={"x": np.float32(v), "idx": np.int64(k)},
                    fetch_list=[c, s])
            for v, k in ((2.0, 0), (0.5, 1), (-1.0, 7))]


@pytest.mark.parametrize("scenario", [_cond, _while_loop, _case],
                         ids=["cond", "while_loop", "case_switch_case"])
def test_control_flow(scenario):
    j, t = run_both(scenario)
    assert_close(j, t)


def test_cond_and_while_values():
    _, t = run_both(_cond)
    assert float(t[0]) == 6.0 and float(t[1]) == -4.0
    _, t = run_both(_while_loop)
    assert t[0] == 5 and t[1] == 32.0


def _save_load(P, tmp):
    x = P.static.data("x", [-1, 3], "float32")
    lin = P.p.nn.Linear(3, 2)
    lin(x)
    prog = P.static.default_main_program()
    exe = P.exe()
    P.startup(exe)
    scope = P.static.global_scope()
    orig = P.value(lin.weight.name)
    path = os.path.join(tmp, "jax" if not P.port else "port", "model")
    P.static.save(prog, path)
    scope.set(lin.weight.name, scope.find_var(lin.weight.name) * 0)
    P.static.load(prog, path)
    np.testing.assert_allclose(P.value(lin.weight.name), orig)
    return path


def test_static_save_load(tmp_path):
    """Each package restores its own save, and the .pdparams / .pdopt
    pickles are the same {name: ndarray} in both."""
    import pickle
    jpath, tpath = run_both(_save_load, str(tmp_path))
    for suffix in (".pdparams", ".pdopt"):
        with open(jpath + suffix, "rb") as f:
            j = pickle.load(f)
        with open(tpath + suffix, "rb") as f:
            t = pickle.load(f)
        assert_close({k: np.asarray(v) for k, v in j.items()}, t, rtol=0,
                     atol=0)


def _inference_model(P, tmp):
    x = P.static.data("x", [-1, 4], "float32")
    lin = P.p.nn.Linear(4, 2)
    out = P.p.nn.functional.softmax(lin(x))
    exe = P.exe()
    P.startup(exe)
    xs = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    (want,) = exe.run(feed={"x": xs}, fetch_list=[out])
    prefix = os.path.join(tmp, "port" if P.port else "jax", "infer")
    P.static.save_inference_model(prefix, [x], [out], exe)
    prog, feeds, fetches = P.static.load_inference_model(prefix)
    assert feeds == ["x"] and fetches == [out.name]
    got = np.asarray(prog(xs)[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got5 = np.asarray(prog(np.concatenate([xs, xs[:2]]))[0])
    return want, got, got5


def test_save_load_inference_model(tmp_path):
    """The artifact runs the forward at the saved batch and another (the
    -1 dim exports as a dynamic dim)."""
    j, t = run_both(_inference_model, str(tmp_path))
    assert_close(j, t)
    np.testing.assert_allclose(t[2][:3], t[1], rtol=1e-6)


def _guard_isolation(P):
    outer = P.static.default_main_program()
    p, s = P.static.Program(), P.static.Program()
    with P.static.program_guard(p, s):
        x = P.static.data("x", [2], "float32")
        _ = x + 1.0
        assert P.static.default_main_program() is p
    assert P.static.default_main_program() is outer
    return [od.op_type for od in p.ops]


def test_program_guard_isolation():
    j, t = run_both(_guard_isolation)
    assert j == t == ["elementwise_add"]


def _clone_for_test(P):
    x = P.static.data("x", [4, 2], "float32")
    lin = P.p.nn.Linear(2, 1)
    loss = lin(x).mean()
    n_fwd = len(P.static.default_main_program().ops)
    P.p.optimizer.SGD(learning_rate=0.1).minimize(loss)
    prog = P.static.default_main_program()
    test_prog = prog.clone(for_test=True)
    assert len(prog.ops) > n_fwd and len(test_prog.ops) == n_fwd
    exe = P.exe()
    P.startup(exe)
    before = P.value(lin.weight.name)
    got = exe.run(test_prog, feed={"x": np.ones((4, 2), np.float32)},
                  fetch_list=[test_prog.global_block.var(loss.name)])
    np.testing.assert_allclose(before, P.value(lin.weight.name))
    return got, [od.op_type for od in prog.ops]


def test_clone_for_test_strips_training_tail():
    j, t = run_both(_clone_for_test)
    assert j[1] == t[1]
    assert_close(j[0], t[0])


def _gradients(P):
    x = P.static.data("x", [3], "float32")
    y = (x ** 2).sum()
    (gx,) = P.static.gradients(y, x)
    return P.exe().run(feed={"x": np.array([1.0, 2.0, 3.0], np.float32)},
                       fetch_list=[gx])


def _gradients_multi(P):
    static = P.static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [3, 4], "float32")
        w = static.create_global_var([4, 2], 0.5, "float32", name="w",
                                     persistable=True)
        y1 = P.p.matmul(x, w)
        y2 = (x ** 2).sum()
        tg = static.data("tg", [3, 2], "float32")
        g_tg = static.gradients([y1], [x], target_gradients=[tg])
        g_multi = static.gradients([y1, y2], [x])
    exe = P.exe()
    P.startup(exe, startup)
    xv = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    tgv = np.random.RandomState(1).randn(3, 2).astype(np.float32)
    return exe.run(main, feed={"x": xv, "tg": tgv},
                   fetch_list=[g_tg[0], g_multi[0]])


@pytest.mark.parametrize("scenario", [_gradients, _gradients_multi],
                         ids=["single", "multiple_nonscalar"])
def test_gradients_api(scenario):
    j, t = run_both(scenario)
    assert_close(j, t)


def _amp_lenet(P):
    static = P.static
    main, startup = static.Program(), static.Program()
    rs = np.random.RandomState(0)
    with static.program_guard(main, startup):
        x = static.data("x", [32, 1, 12, 12], "float32")
        y = static.data("y", [32, 1], "int64")
        h = static.nn.conv2d(x, 6, 3, act="relu")
        net = static.nn.fc(h, 10)
        loss = P.p.nn.functional.cross_entropy(net, y)
        mp = static.amp.decorate(P.p.optimizer.Momentum(0.05),
                                 init_loss_scaling=1024.0)
        mp.minimize(loss)
    types = [od.op_type for od in main.ops]
    exe = P.exe()
    P.startup(exe, startup)
    losses = []
    for _ in range(15):
        xv = rs.randn(32, 1, 12, 12).astype(np.float32)
        yv = ((xv.mean(axis=(1, 2, 3)) > 0) * 3).astype(
            np.int64).reshape(-1, 1)
        out = exe.run(main, feed={"x": xv, "y": yv},
                      fetch_list=[loss, mp.get_loss_scaling()])
        losses.append(float(out[0]))
    return types, losses, float(out[1])


def test_static_amp_lenet_converges():
    """bf16 compute, f32 masters, dynamic loss scaling: the op list is
    the JAX package's, the port converges and keeps its scale, and its
    losses stay within bf16's reach of the JAX package's (the two
    round bf16 matmuls and convolutions differently: 5e-2 relative)."""
    j, t = run_both(_amp_lenet)
    assert j[0] == t[0]
    assert "conv2d" in t[0] and "backward" in t[0]
    assert np.isfinite(t[1]).all()
    assert np.mean(t[1][-5:]) < np.mean(t[1][:5])
    assert t[2] > 0 and t[2] == j[2]
    np.testing.assert_allclose(t[1][:3], j[1][:3], rtol=5e-2)


def _persistence(P, tmp, fmt):
    static = P.static

    def build():
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [8, 4], "float32")
            y = static.data("y", [8, 1], "float32")
            h = static.nn.fc(x, 8, activation="tanh")
            out = static.nn.fc(h, 1)
            loss = ((out - y) ** 2).mean()
            P.p.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, startup, loss

    io = __import__(f"{P.p.__name__}.static.io", fromlist=["io"])
    main, startup, loss = build()
    exe = P.exe()
    P.startup(exe, startup)
    rs = np.random.RandomState(0)
    xv = rs.randn(8, 4).astype(np.float32)
    yv = rs.randn(8, 1).astype(np.float32)
    for _ in range(3):
        exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])
    path = os.path.join(tmp, "port" if P.port else "jax", "model")
    io.save_program(main, path, format=fmt)
    expected = exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])[0]
    static.global_scope().drop_kids()
    P.p.utils.unique_name.switch()
    main2, _, loss2 = build()
    io.load_program(main2, path)
    resumed = exe.run(main2, feed={"x": xv, "y": yv},
                      fetch_list=[loss2])[0]
    np.testing.assert_allclose(resumed, expected, rtol=1e-6)
    main3, startup3 = static.Program(), static.Program()
    with static.program_guard(main3, startup3):
        static.nn.fc(static.data("x", [8, 4], "float32"), 2)
    with pytest.raises(ValueError):
        io.load_program(main3, path)
    with open(path + ".pdmodel", "rb") as f:
        return expected, resumed, f.read()


@pytest.mark.parametrize("fmt", ["json", "proto"])
def test_program_persistence_roundtrip(tmp_path, fmt):
    """save_program / load_program in both formats: a rebuilt program
    resumes bitwise, a different one is refused, and the saved
    structure is byte for byte the JAX package's."""
    j, t = run_both(_persistence, str(tmp_path), fmt)
    assert_close(j[:2], t[:2])
    assert j[2] == t[2]


# ----------------------------------------------------- the port's contract
def test_mode_switches_answer_truthfully():
    p = paddle_tpu_torch
    assert p.in_dygraph_mode() and p.in_dynamic_mode()
    p.disable_dygraph()
    try:
        assert not p.in_dygraph_mode() and tstatic.in_static_mode()
    finally:
        p.enable_dygraph()
    assert p.in_dygraph_mode()
    p.enable_static()
    try:
        assert not p.in_dynamic_mode()
    finally:
        p.disable_static()
    assert p.in_dynamic_mode()


def test_capture_refuses_what_it_cannot_record():
    """A torch call on a Variable with no Paddle op type, a read of a
    Variable's value and an in-place write raise; nothing is silently
    left out of the Program."""
    with static_mode(paddle_tpu_torch):
        x = tstatic.data("x", [4, 4], "float32")
        with pytest.raises(RuntimeError, match="no Paddle op type"):
            torch.linalg.svd(x)
        with pytest.raises(RuntimeError, match="no value"):
            x.numpy()
        with pytest.raises(RuntimeError, match="no value"):
            bool(x.sum() > 0)
        with pytest.raises(RuntimeError, match="in-place"):
            torch.Tensor.add_(x, 1.0)


def test_executor_without_a_place_needs_a_gpu():
    """Executor() runs on the card; with no GPU it raises rather than
    run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with static_mode(paddle_tpu_torch):
        x = tstatic.data("x", [2], "float32")
        y = x + 1.0
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstatic.Executor().run(feed={"x": np.zeros(2, np.float32)},
                                   fetch_list=[y])


def test_static_layers_hold_no_values():
    """A layer built in static mode registers Variables as its
    parameters and buffers (the module's naming sees them) and holds no
    values: they live in the Scope after the startup program runs."""
    with static_mode(paddle_tpu_torch) as (main, startup):
        bn = paddle_tpu_torch.nn.BatchNorm1D(3)
        names = dict(bn.named_parameters())
        assert set(names) == {"weight", "bias"}
        assert all(isinstance(v, tstatic.Variable) and v.is_meta
                   for v in names.values())
        assert isinstance(bn._mean, tstatic.Variable)
        assert bn._mean.persistable and not bn._mean.is_parameter
        assert [od.op_type for od in startup.ops] == [
            "fill_parameter", "fill_parameter", "fill_buffer", "fill_buffer"]


# ------------------------------------------- compat, debug ops, py_func
def _scope_and_vars(P, tmp):
    static = P.static
    x = static.data("x", [4, 3], "float32")
    lin = P.p.nn.Linear(3, 2)
    out = lin(x)
    prog = static.default_main_program()
    exe = P.exe()
    P.startup(exe)
    xs = np.random.RandomState(4).randn(4, 3).astype(np.float32)
    (want,) = exe.run(feed={"x": xs}, fetch_list=[out])
    d = os.path.join(tmp, "port" if P.port else "jax")
    static.save_vars(exe, os.path.join(d, "vars"), prog)
    static.save_vars(exe, os.path.join(d, "one"), prog, filename="all")
    blob = static.serialize_persistables([x], [out], exe, prog)
    state = static.load_program_state(os.path.join(d, "vars"))
    got = []
    for load in (lambda: static.load_vars(exe, os.path.join(d, "vars"),
                                          prog),
                 lambda: static.load_vars(exe, os.path.join(d, "one"),
                                          prog, filename="all"),
                 lambda: static.deserialize_persistables(prog, blob, exe),
                 lambda: static.set_program_state(prog, state)):
        static.global_scope().set(lin.weight.name, torch.zeros(3, 2)
                                  if P.port else paddle_tpu.to_tensor(
                                      np.zeros((3, 2), np.float32))._value)
        load()
        got.append(exe.run(feed={"x": xs}, fetch_list=[out])[0])
    other = static.Scope()
    with static.scope_guard(other):
        assert static.global_scope() is other
        exe.run(static.default_startup_program())
        assert other.find_var(lin.weight.name) is not None
    compiled = static.CompiledProgram(prog).with_data_parallel(
        loss_name=out.name)
    # the JAX Executor takes the program inside (it does not unwrap)
    got.append(exe.run(compiled if P.port else compiled.program,
                       feed={"x": xs}, fetch_list=[out])[0])
    pe = static.ParallelExecutor(use_cuda=False, main_program=prog)
    got.append(pe.run(fetch_list=[out], feed={"x": xs})[0])
    assert sorted(state) == sorted([lin.weight.name, lin.bias.name])
    return want, got


def test_compat_scope_and_persistables(tmp_path):
    """save_vars / load_vars (per file and one file),
    serialize_persistables, load_program_state / set_program_state,
    scope_guard, CompiledProgram and ParallelExecutor: each restores or
    runs the program to the same fetch, in both packages."""
    j, t = run_both(_scope_and_vars, str(tmp_path))
    for g in t[1]:
        np.testing.assert_allclose(g, t[0], rtol=0, atol=0)
    assert_close(j, t)


def test_print_and_py_func_in_a_program(capsys):
    """static.Print and static.py_func on Variables record ops that run
    with the program (the JAX package's run at build time on the
    Variable's metadata, so this case is the port's alone): the printed
    values and py_func's result at every run."""
    with static_mode(paddle_tpu_torch):
        x = tstatic.data("x", [3], "float32")
        y = tstatic.Print(x * 2.0, message="doubled")
        z = tstatic.py_func(lambda a: np.asarray(a) + 10.0, y,
                            out_template=np.zeros(3, np.float32))
        w = z.sum()
        exe = tstatic.Executor(paddle_tpu_torch.CPUPlace())
        for v in (1.0, 2.0):
            got = exe.run(feed={"x": np.full(3, v, np.float32)},
                          fetch_list=[y, w])
            np.testing.assert_allclose(got[0], np.full(3, 2 * v))
            assert float(got[1]) == 3 * (2 * v + 10)
    out = capsys.readouterr().out
    assert out.count("doubled") == 2 and "data=[4.0, 4.0, 4.0]" in out


def test_assert_op_raises_when_its_condition_fails():
    """static.Assert records an op that raises at run time when its
    condition is false; eagerly it raises at once."""
    with static_mode(paddle_tpu_torch):
        x = tstatic.data("x", [2], "float32")
        tstatic.Assert((x > 0.0).all(), [x], name="positive")
        y = x + 1.0
        exe = tstatic.Executor(paddle_tpu_torch.CPUPlace())
        exe.run(feed={"x": np.ones(2, np.float32)}, fetch_list=[y])
        with pytest.raises(AssertionError, match="positive"):
            exe.run(feed={"x": -np.ones(2, np.float32)}, fetch_list=[y])
    with pytest.raises(AssertionError):
        tstatic.Assert(torch.tensor(False))


def test_places_and_input_spec():
    j = paddle_tpu.jit.InputSpec([None, 8], "float32", "x")
    t = paddle_tpu_torch.static.InputSpec([None, 8], "float32", "x")
    assert (t.shape, t.name) == (j.shape, j.name) == ([None, 8], "x")
    assert t.dtype == torch.float32
    assert len(tstatic.cpu_places(3)) == 3
    assert len(tstatic.cuda_places()) == torch.cuda.device_count()
