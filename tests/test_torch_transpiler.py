"""The port's DistributeTranspiler against the JAX package's, on the
CPU: the cases of tests/test_transpiler.py on both packages (pserver
programs serving from host threads over each package's own parameter
server), the port's transpiled losses held to its local run (1e-5
relative, as chip_smoke phase 44 gates) and to the JAX package's.
"""
import socket
import threading

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


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _build(P, bs):
    static = P.static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [bs, 4], "float32")
        y = static.data("y", [bs, 1], "float32")
        pred = static.nn.fc(x, 1)
        loss = ((pred - y) ** 2).mean()
        P.p.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


W_TRUE = np.array([[1.], [2.], [-1.], [0.5]], np.float32)


def _transpiled(P):
    rs = np.random.RandomState(0)
    data = [(xv, xv @ W_TRUE) for xv in
            (rs.randn(16, 4).astype(np.float32) for _ in range(10))]
    static = P.static
    P.p.seed(11)
    main, startup, loss = _build(P, 16)
    exe = P.exe()
    P.startup(exe, startup)
    local = [float(exe.run(main, feed={"x": xv, "y": yv},
                           fetch_list=[loss])[0]) for xv, yv in data]
    static.global_scope().drop_kids()
    P.p.utils.unique_name.switch()
    P.p.seed(11)
    main2, startup2, loss2 = _build(P, 16)
    exe2 = P.exe()
    P.startup(exe2, startup2)
    eps = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    t = P.p.distributed.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main2, pservers=",".join(eps),
                trainers=1)
    servers = [t.get_pserver_program(ep) for ep in eps]
    for s in servers:
        s.serve(block=False)
    try:
        tp = t.get_trainer_program()
        dist = [float(exe2.run(tp, feed={"x": xv, "y": yv},
                               fetch_list=[loss2])[0]) for xv, yv in data]
    finally:
        for s in servers:
            s.stop()
    return local, dist, getattr(tp, "rpc_stats", None)


def test_transpiled_training_matches_local_sgd():
    j, t = run_both(_transpiled)
    np.testing.assert_allclose(t[1], t[0], rtol=1e-5)
    assert t[1][-1] < t[1][0] * 0.25
    assert_close(j[:2], t[:2], rtol=1e-5)
    # two tables (w, b): a pull and a push of each per step
    assert t[2]["pulls"] == t[2]["pushes"] == 2 * 10
    assert t[2]["bytes"] == 2 * 10 * (4 * 4 + 4)


def _two_trainers(P):
    rs = np.random.RandomState(7)
    steps = 10
    halves = [[rs.randn(16, 4).astype(np.float32) for _ in range(2)]
              for _ in range(steps)]
    static = P.static
    P.p.seed(11)
    main, startup, loss = _build(P, 32)
    exe = P.exe()
    P.startup(exe, startup)
    local = [float(exe.run(main, feed={
        "x": np.concatenate([h0, h1]),
        "y": np.concatenate([h0, h1]) @ W_TRUE}, fetch_list=[loss])[0])
        for h0, h1 in halves]
    eps = [f"127.0.0.1:{_free_port()}"]
    static.global_scope().drop_kids()
    rigs = []
    for tid in range(2):
        P.p.seed(11)
        with P.p.utils.unique_name.guard():
            m, su, ls = _build(P, 16)
        scope = static.Scope()
        e = P.exe()
        P.startup(e, su, scope=scope)
        t = P.p.distributed.DistributeTranspiler()
        t.transpile(trainer_id=tid, program=m, pservers=",".join(eps),
                    trainers=2, sync_mode=True)
        rigs.append((e, t.get_trainer_program(), ls, scope))
    with P.p.utils.unique_name.guard():
        main2, _, _ = _build(P, 16)
    t0 = P.p.distributed.DistributeTranspiler()
    t0.transpile(trainer_id=0, program=main2, pservers=",".join(eps),
                 trainers=2, sync_mode=True)
    server = t0.get_pserver_program(eps[0])
    server.serve(block=False)
    results, errors = {}, []

    def trainer(tid):
        try:
            e, tp, ls, scope = rigs[tid]
            results[tid] = [float(e.run(tp, feed={
                "x": halves[s][tid], "y": halves[s][tid] @ W_TRUE},
                fetch_list=[ls], scope=scope)[0]) for s in range(steps)]
        except Exception as exc:  # surface thread failures in the test
            errors.append(exc)

    try:
        ths = [threading.Thread(target=trainer, args=(tid,))
               for tid in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
    finally:
        server.stop()
    assert not errors, errors
    merged = [0.5 * (results[0][i] + results[1][i]) for i in range(steps)]
    return local, merged


def test_two_trainer_sync_matches_big_batch_sgd():
    """Two trainers in sync mode, each pushing grad / 2: the mean of
    their half-batch losses follows local SGD on the whole batch."""
    j, t = run_both(_two_trainers)
    np.testing.assert_allclose(t[1], t[0], rtol=1e-3)
    assert t[1][-1] < t[1][0] * 0.5
    assert_close(j, t, rtol=1e-4)


def _requires_backward(P):
    static = P.static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        static.nn.fc(static.data("x", [4, 2], "float32"), 1)
    with pytest.raises(ValueError):
        P.p.distributed.DistributeTranspiler().transpile(
            0, program=main, pservers="127.0.0.1:1")


def test_transpile_requires_backward():
    run_both(_requires_backward)
