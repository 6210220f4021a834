"""The port's StaticRNN / DynamicRNN / py_reader against the JAX
package's, on the CPU: the cases of tests/test_rnn_shims.py on both
packages from the same inputs (1e-5 relative), and their numpy oracles.
"""
import numpy as np
import pytest
import torch

from torch_static_twins import assert_close, run_both


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


T, B, D, H = 5, 3, 4, 6
_rs = np.random.RandomState(0)
XV = _rs.randn(T, B, D).astype(np.float32)
WV = _rs.randn(D, H).astype(np.float32) * 0.3
UV = _rs.randn(H, H).astype(np.float32) * 0.3


def _static_rnn(P):
    static = P.static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [T, B, D], "float32")
        h0 = static.data("h0", [B, H], "float32")
        W = static.data("W", [D, H], "float32")
        U = static.data("U", [H, H], "float32")
        rnn = static.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(init=h0)
            h = P.p.tanh(P.p.matmul(xt, W) + P.p.matmul(prev, U))
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()
    exe = P.exe()
    P.startup(exe, startup)
    return exe.run(main, feed={"x": XV, "h0": np.zeros((B, H), np.float32),
                               "W": WV, "U": UV}, fetch_list=[out])[0]


def test_static_rnn_matches_simple_rnn_math():
    j, t = run_both(_static_rnn)
    assert_close(j, t)
    h, expect = np.zeros((B, H), np.float32), []
    for s in range(T):
        h = np.tanh(XV[s] @ WV + h @ UV)
        expect.append(h)
    np.testing.assert_allclose(t, np.stack(expect), rtol=1e-5, atol=1e-6)


def _zero_init(P):
    static = P.static
    xv = np.random.RandomState(1).randn(4, 2, 3).astype(np.float32)
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [4, 2, 3], "float32")
        rnn = static.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            acc = rnn.memory(shape=[2, 3], value=0.0)
            s = acc + xt
            rnn.update_memory(acc, s)
            rnn.step_output(s)
        out = rnn()
    exe = P.exe()
    P.startup(exe, startup)
    got = exe.run(main, feed={"x": xv}, fetch_list=[out])[0]
    np.testing.assert_allclose(got, np.cumsum(xv, axis=0), rtol=1e-6)
    return got


def test_static_rnn_zero_init_memory():
    j, t = run_both(_zero_init)
    assert_close(j, t)


def _dynamic(P):
    static = P.static
    rs = np.random.RandomState(2)
    xv = rs.randn(3, 5, 2).astype(np.float32)
    lens = np.array([5, 3, 1], np.int64)
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [3, 5, 2], "float32")
        lv = static.data("lens", [3], "int64")
        drnn = static.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x, lengths=lv)
            acc = drnn.memory(shape=[3, 2], value=0.0)
            s = acc + xt
            drnn.update_memory(acc, s)
            drnn.output(s)
        out = drnn()
    exe = P.exe()
    P.startup(exe, startup)
    got = exe.run(main, feed={"x": xv, "lens": lens}, fetch_list=[out])[0]
    for b in range(3):
        np.testing.assert_allclose(got[b, :lens[b]],
                                   np.cumsum(xv[b, :lens[b]], axis=0),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[b, lens[b]:], 0.0)
    return got


def test_dynamic_rnn_respects_lengths():
    j, t = run_both(_dynamic)
    assert_close(j, t)


def _py_reader(P):
    static = P.static
    rs = np.random.RandomState(3)
    batches = [(rs.randn(4, 3).astype(np.float32),) for _ in range(5)]
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        reader = static.py_reader(capacity=4, shapes=[[4, 3]],
                                  dtypes=["float32"])
        x = static.read_file(reader)
        out = (x * 2.0).sum()
    reader.decorate_batch_generator(lambda: iter(batches))
    exe = P.exe()
    P.startup(exe, startup)
    epochs = []
    for _ in range(2):
        reader.start()
        got = []
        while True:
            try:
                got.append(float(exe.run(main, fetch_list=[out])[0]))
            except EOFError:
                break
        assert len(got) == 5
        np.testing.assert_allclose(
            got, [float(b[0].sum() * 2.0) for b in batches], rtol=1e-5)
        epochs.append(got)
        reader.reset()
    return epochs


def test_py_reader_feeds_executor_and_signals_eof():
    j, t = run_both(_py_reader)
    assert_close(j, t)
