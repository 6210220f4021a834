"""The parameter server, its device cache, the fleet's PS methods,
fleet.metrics and the data generators of the port, against the JAX
package.

test_ps.py's and test_device_cache.py's cases run on the port (the cache
with device="cpu"); a port client talks to a JAX server and a JAX
client to a port server (the wire format is the same length-prefixed
pickle); fleet.metrics runs on 4 gloo ranks (tests/test_torch_dist_worker
.py, suite "ps") against one process's metric over the union of the
ranks' data; the data generators write the JAX package's MultiSlot text
byte for byte.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.fleet.data_generator as jdg
from paddle_tpu.distributed.fleet import metrics as jmetrics
from paddle_tpu.distributed.ps import (ParameterServer as JParameterServer,
                                       PsClient as JPsClient)

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.distributed.fleet.data_generator as tdg
from paddle_tpu_torch.distributed.ps import (DeviceEmbeddingCache,
                                             ParameterServer, PsClient)
from paddle_tpu_torch.distributed.ps.client import GeoWorker

from test_torch_dist_worker import run_cluster


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def server():
    srv = ParameterServer(port=0)
    srv.add_dense_table(0, shape=(4, 3), optimizer="sgd", lr=0.5,
                        initializer=lambda: np.ones((4, 3), np.float32))
    srv.add_sparse_table(1, dim=3, optimizer="sgd", lr=1.0)
    srv.add_dense_table(2, shape=(2,), optimizer="sum",
                        initializer=lambda: np.zeros(2, np.float32))
    srv.start()
    yield srv
    srv.stop()


# ------------------------------------------------- test_ps.py's cases
def test_dense_pull_push(server):
    c = PsClient([server.endpoint])
    np.testing.assert_allclose(c.pull_dense(0), np.ones((4, 3)))
    c.push_dense(0, np.ones((4, 3)))
    np.testing.assert_allclose(c.pull_dense(0), np.full((4, 3), 0.5))
    c.close()


def test_sparse_lazy_rows_and_update(server):
    c = PsClient([server.endpoint])
    rows = c.pull_sparse(1, [5, 9])
    assert rows.shape == (2, 3)
    before = rows.copy()
    c.push_sparse(1, [5], np.ones((1, 3), np.float32))
    after = c.pull_sparse(1, [5, 9])
    np.testing.assert_allclose(after[0], before[0] - 1.0, rtol=1e-5)
    np.testing.assert_allclose(after[1], before[1])
    assert c.stats()[1]["rows"] == 2
    c.close()


def test_two_workers_shared_state(server):
    results = {}

    def worker(wid):
        c = PsClient([server.endpoint])
        c.push_dense(0, np.full((4, 3), 0.1, np.float32))
        c.barrier(2)
        results[wid] = c.pull_dense(0)
        c.close()

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    np.testing.assert_allclose(results[0], np.full((4, 3), 0.9), rtol=1e-5)
    np.testing.assert_allclose(results[0], results[1])


def test_geo_worker_local_then_sync(server):
    c1 = PsClient([server.endpoint])
    c2 = PsClient([server.endpoint])
    w1 = GeoWorker(c1, 2, k_steps=2)
    w2 = GeoWorker(c2, 2, k_steps=2)
    w1.local_update(np.array([1.0, 0.0], np.float32), lr=1.0)
    np.testing.assert_allclose(c2.pull_dense(2), [0, 0])
    w1.local_update(np.array([1.0, 0.0], np.float32), lr=1.0)
    np.testing.assert_allclose(c2.pull_dense(2), [-2, 0])
    w2.local_update(np.array([0.0, 1.0], np.float32), lr=1.0)
    w2.local_update(np.array([0.0, 1.0], np.float32), lr=1.0)
    np.testing.assert_allclose(c1.pull_dense(2), [-2, -2])
    c1.close()
    c2.close()


def test_fleet_ps_glue():
    fleet = tpaddle.distributed.fleet.fleet
    fleet.init_server(
        dense_tables={0: dict(shape=(3,), optimizer="sgd", lr=0.1)})
    ep = fleet.run_server()
    client = fleet.init_worker(endpoints=[ep])
    v = client.pull_dense(0)
    assert v.shape == (3,)
    client.push_dense(0, np.ones(3, np.float32))
    np.testing.assert_allclose(client.pull_dense(0), v - 0.1)
    fleet.stop_worker()
    with pytest.raises(RuntimeError, match="no pserver endpoints"):
        fleet.init_worker()


def test_ps_error_reporting(server):
    c = PsClient([server.endpoint])
    with pytest.raises(RuntimeError, match="rpc failed"):
        c.pull_dense(99)
    assert c.pull_dense(0).shape == (4, 3)
    c.close()


def test_ps_embedding_training_converges(server):
    """Pull sparse rows, take the port's gradients, push them back."""
    import paddle_tpu_torch.nn.functional as F
    c = PsClient([server.endpoint])
    ids = np.array([1, 2, 3, 4])
    labels = torch.tensor([0.0, 1.0, 0.0, 1.0])
    losses = []
    for _ in range(60):
        w = torch.tensor(c.pull_sparse(1, ids), requires_grad=True)
        loss = F.binary_cross_entropy_with_logits(w.sum(1), labels)
        loss.backward()
        c.push_sparse(1, ids, w.grad.numpy() * 0.5)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    c.close()


def test_barrier_timeout_is_error():
    srv = ParameterServer(port=0, barrier_timeout=1.0)
    srv.add_dense_table(0, shape=(2,))
    srv.start()
    try:
        c = PsClient([srv.endpoint])
        with pytest.raises(RuntimeError, match="barrier timeout"):
            c.barrier(2)
        c.barrier(1)
        c.close()
    finally:
        srv.stop()


def test_multi_server_save_fans_out():
    s1, s2 = ParameterServer(port=0), ParameterServer(port=0)
    for s in (s1, s2):
        s.add_dense_table(0, shape=(2,), lr=1.0)
        s.add_dense_table(1, shape=(2,), lr=1.0)
        s.start()
    try:
        c = PsClient([s1.endpoint, s2.endpoint])
        c.push_dense(0, np.ones(2, np.float32))
        c.push_dense(1, np.ones(2, np.float32))
        blob = c.save()
        np.testing.assert_allclose(blob[0], [-1, -1])
        np.testing.assert_allclose(blob[1], [-1, -1])
        st = c.stats()
        assert st[0]["push_count"] == 1 and st[1]["push_count"] == 1
        c.close()
    finally:
        s1.stop()
        s2.stop()


# ------------------------------------------------------- interop
@pytest.mark.parametrize("pair", ["port client, JAX server",
                                  "JAX client, port server"])
def test_wire_format_interoperates(pair):
    """The same frames both ways: dense and sparse pulls and pushes,
    stats and save between a port client and a JAX server and the other
    way round, with the results of a same-package pair."""
    port_client = pair.startswith("port")
    Srv = JParameterServer if port_client else ParameterServer
    Cli = PsClient if port_client else JPsClient
    srv = Srv(port=0)
    srv.add_dense_table(0, shape=(2, 3), optimizer="adagrad", lr=0.5,
                        initializer=lambda: np.ones((2, 3), np.float32))
    srv.add_sparse_table(1, dim=4, optimizer="sgd", lr=0.25,
                         initializer=lambda: np.full(4, 2.0, np.float32))
    srv.start()
    try:
        c = Cli([srv.endpoint])
        c.push_dense(0, np.full((2, 3), 0.5, np.float32))
        np.testing.assert_allclose(
            c.pull_dense(0), 1.0 - 0.5 * 0.5 / (np.sqrt(0.25) + 1e-6),
            rtol=1e-6)
        c.push_sparse(1, [3, -7], np.ones((2, 4), np.float32))
        np.testing.assert_array_equal(c.pull_sparse(1, [3, -7, 8]),
                                      [[1.75] * 4, [1.75] * 4, [2.0] * 4])
        np.testing.assert_array_equal(c.pull_sparse_state(1, [8]),
                                      np.zeros((1, 4), np.float32))
        assert c.stats()[1] == {"type": "SparseTable", "push_count": 1,
                                "rows": 3}
        assert sorted(c.save()[1]) == [-7, 3, 8]
        with pytest.raises(RuntimeError, match="rpc failed"):
            c.pull_dense(5)
        c.stop_server()
        c.close()
    finally:
        srv.stop()


# -------------------------------------------- the device cache's cases
def _mk_server(dim=8, optimizer="adagrad", lr=0.1, seed=7, vocab=64):
    rng = np.random.RandomState(seed)
    server = ParameterServer(port=0)
    server.add_sparse_table(
        0, dim=dim, optimizer=optimizer, lr=lr,
        initializer=lambda: rng.normal(0, 0.01, dim).astype(np.float32))
    server.start()
    client = PsClient([server.endpoint])
    client.pull_sparse(0, np.arange(vocab, dtype=np.int64))
    return server, client


def _run_steps(client, cache, steps, dim, vocab, seed=3):
    """test_device_cache.py's loop: pull rows, loss mean(rows**2), push
    the gradients of the unique ids."""
    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, 32)
        uniq, inv = np.unique(ids, return_inverse=True)
        rows = cache.pull(uniq).numpy() if cache is not None \
            else np.asarray(client.pull_sparse(0, uniq))
        vecs = rows[inv]
        losses.append(float((vecs ** 2).mean()))
        g = 2.0 * vecs / vecs.size
        grad_rows = np.zeros_like(rows)
        np.add.at(grad_rows, inv, g)
        if cache is not None:
            cache.push(uniq, grad_rows)
        else:
            client.push_sparse(0, uniq, grad_rows)
    return losses


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_device_cache_matches_host_ps(optimizer):
    """Every id hot: the losses equal the host PS run's step for step
    (bitwise: the cache's indexed updates are the host rule's
    operations), and no pull needs an RPC."""
    dim, vocab = 8, 64
    s1, c1 = _mk_server(dim, optimizer)
    s2, c2 = _mk_server(dim, optimizer)
    try:
        host = _run_steps(c1, None, 10, dim, vocab)
        cache = DeviceEmbeddingCache(c2, 0, cache_rows=vocab, dim=dim,
                                     optimizer=optimizer, lr=0.1,
                                     device="cpu")
        dev = _run_steps(c2, cache, 10, dim, vocab)
        assert dev == host
        assert cache.host_pulls == 0
        cache.flush()
        ids = np.arange(vocab, dtype=np.int64)
        np.testing.assert_array_equal(c2.pull_sparse(0, ids),
                                      c1.pull_sparse(0, ids))
    finally:
        s1.stop(), s2.stop()


def test_device_cache_mixed_hot_cold_parity():
    dim, vocab = 8, 64
    s1, c1 = _mk_server(dim)
    s2, c2 = _mk_server(dim)
    try:
        host = _run_steps(c1, None, 10, dim, vocab)
        cache = DeviceEmbeddingCache(c2, 0, cache_rows=vocab // 2, dim=dim,
                                     optimizer="adagrad", lr=0.1,
                                     device="cpu")
        dev = _run_steps(c2, cache, 10, dim, vocab)
        np.testing.assert_allclose(dev, host, rtol=1e-5)
        assert cache.host_pulls > 0
    finally:
        s1.stop(), s2.stop()


def test_device_cache_flush_round_trip():
    dim, vocab = 4, 16
    server, client = _mk_server(dim, "sgd")
    try:
        cache = DeviceEmbeddingCache(client, 0, cache_rows=vocab, dim=dim,
                                     optimizer="sgd", lr=0.1, device="cpu")
        _run_steps(client, cache, 5, dim, vocab)
        cache.flush()
        ps_rows = np.asarray(client.pull_sparse(
            0, np.arange(vocab, dtype=np.int64)))
        np.testing.assert_allclose(ps_rows, cache.table.numpy(), rtol=1e-6)
    finally:
        server.stop()


def test_device_cache_adagrad_state_continuity():
    dim, vocab = 8, 64
    s1, c1 = _mk_server(dim, "adagrad")
    s2, c2 = _mk_server(dim, "adagrad")
    try:
        h1 = _run_steps(c1, None, 5, dim, vocab, seed=3)
        h2 = _run_steps(c2, None, 5, dim, vocab, seed=3)
        np.testing.assert_allclose(h1, h2, rtol=1e-6)
        cache = DeviceEmbeddingCache(c2, 0, cache_rows=vocab, dim=dim,
                                     optimizer="adagrad", lr=0.1,
                                     device="cpu")
        d2 = _run_steps(c2, cache, 5, dim, vocab, seed=11)
        h1b = _run_steps(c1, None, 5, dim, vocab, seed=11)
        np.testing.assert_allclose(d2, h1b, rtol=1e-5)
        cache.flush()
        h1c = _run_steps(c1, None, 5, dim, vocab, seed=17)
        h2c = _run_steps(c2, None, 5, dim, vocab, seed=17)
        np.testing.assert_allclose(h2c, h1c, rtol=1e-5)
    finally:
        s1.stop(), s2.stop()


def test_device_cache_negative_ids_go_to_host():
    dim = 4
    server, client = _mk_server(dim, "sgd", vocab=8)
    try:
        cache = DeviceEmbeddingCache(client, 0, cache_rows=8, dim=dim,
                                     optimizer="sgd", lr=0.1, device="cpu")
        before = cache.table.numpy().copy()
        ids = np.array([-5, 2], np.int64)
        rows = cache.pull(ids).numpy()
        assert cache.host_pulls == 1
        cache.push(ids, np.ones((2, dim), np.float32))
        after = cache.table.numpy()
        changed = np.nonzero(np.abs(after - before).sum(1))[0]
        assert list(changed) == [2]
        ps_row = np.asarray(client.pull_sparse(0, np.array([-5])))
        np.testing.assert_allclose(ps_row[0], rows[0] - 0.1 * 1.0)
    finally:
        server.stop()


def test_device_cache_rpc_savings():
    dim, vocab = 8, 64
    server, client = _mk_server(dim)
    try:
        cache = DeviceEmbeddingCache(client, 0, cache_rows=vocab, dim=dim,
                                     optimizer="adagrad", lr=0.1,
                                     device="cpu")
        before = client.stats()[0]["push_count"]
        _run_steps(client, cache, 20, dim, vocab)
        assert client.stats()[0]["push_count"] == before
        assert cache.host_pulls == 0
        _run_steps(client, None, 20, dim, vocab)
        assert client.stats()[0]["push_count"] == before + 20
    finally:
        server.stop()


def test_device_cache_refuses_other_rules_and_a_mesh():
    server, client = _mk_server(4, "sgd", vocab=4)
    try:
        with pytest.raises(ValueError, match="sgd/adagrad"):
            DeviceEmbeddingCache(client, 0, 4, 4, optimizer="adam",
                                 device="cpu")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            DeviceEmbeddingCache(client, 0, 4, 4, mesh=object(), axis="dp",
                                 device="cpu")
    finally:
        server.stop()


# --------------------------------------------------- fleet.metrics
N_BUCKETS = 64


def _stats(rng):
    scores = rng.rand(100)
    labels = (rng.rand(100) < scores * 0.8).astype(np.int64)
    preds = (scores > 0.5).astype(np.int64)
    b = np.minimum((scores * N_BUCKETS).astype(int), N_BUCKETS - 1)
    return {"stat": rng.randn(3).astype(np.float64),
            "correct": np.array(float((preds == labels).sum())),
            "total": np.array(100.0),
            "abserr": np.array(np.abs(scores - labels).sum()),
            "sqrerr": np.array(((scores - labels) ** 2).sum()),
            "pos": np.bincount(b[labels == 1], minlength=N_BUCKETS)
            .astype(np.float64),
            "neg": np.bincount(b[labels == 0], minlength=N_BUCKETS)
            .astype(np.float64)}


def test_fleet_metrics_on_four_ranks_equal_the_union():
    """Each metric over 4 gloo ranks' statistics equals the JAX
    package's metric of one process over their union (its all-reduce is
    the identity there)."""
    rng = np.random.RandomState(7)
    per = [_stats(rng) for _ in range(4)]
    inputs = {f"metrics/{k}": np.stack([p[k] for p in per])
              for k in per[0]}
    ranks = run_cluster(inputs, 4, "ps")
    union = {k: inputs[f"metrics/{k}"].sum(0) for k in per[0]}
    want = {"sum": jmetrics.sum(union["stat"]),
            "max": jmetrics.max(inputs["metrics/stat"].max(0)),
            "min": jmetrics.min(inputs["metrics/stat"].min(0)),
            "acc": jmetrics.acc(union["correct"], union["total"]),
            "mae": jmetrics.mae(union["abserr"], union["total"]),
            "mse": jmetrics.mse(union["sqrerr"], union["total"]),
            "rmse": jmetrics.rmse(union["sqrerr"], union["total"]),
            "auc": jmetrics.auc(union["pos"], union["neg"])}
    for r in range(4):
        for k, w in want.items():
            np.testing.assert_allclose(ranks[r][f"metrics/{k}"], w,
                                       rtol=1e-12, err_msg=k)


def test_fleet_metrics_without_a_group_are_the_identity():
    from paddle_tpu_torch.distributed.fleet import metrics as tmetrics
    s = _stats(np.random.RandomState(1))
    assert tmetrics.acc(s["correct"], s["total"]) == \
        jmetrics.acc(s["correct"], s["total"])
    assert tmetrics.auc(s["pos"], s["neg"]) == jmetrics.auc(s["pos"],
                                                           s["neg"])
    np.testing.assert_array_equal(tmetrics.sum(s["stat"]), s["stat"])


# --------------------------------------------------- data generators
def _generator(mod, cls):
    class Gen(getattr(mod, cls)):
        def generate_sample(self, line):
            def it():
                rows = [line] if line is not None else \
                    ["1 2 3", "4 5", "6"]
                for r in rows:
                    vals = r.split()
                    yield [("words", vals), ("label", int(vals[0]) % 2),
                           ("dense", [float(v) / 3 for v in vals])]
            return it
    return Gen()


@pytest.mark.parametrize("cls", ["DataGenerator", "MultiSlotDataGenerator",
                                 "MultiSlotStringDataGenerator"])
def test_data_generator_writes_the_jax_text(cls, tmp_path):
    """run_from_memory's text and run_to_file's bytes equal the JAX
    package's, batched or not; the positional slot order and empty slots
    are refused as there."""
    for batch in (32, 2):
        gens = [_generator(m, cls) for m in (jdg, tdg)]
        for g in gens:
            g.set_batch(batch)
        assert gens[1].run_from_memory() == gens[0].run_from_memory()
        assert gens[1].slots() == gens[0].slots()
        lines = ["7 8 9 10", "11", "12 13"]
        paths = [gens[i].run_to_file(lines, str(tmp_path / f"{i}.txt"))
                 for i in range(2)]
        assert open(paths[1], "rb").read() == open(paths[0], "rb").read()
    g = tdg.MultiSlotDataGenerator()
    with pytest.raises(ValueError, match="no values"):
        g._gen_str([("a", [])])
    g._slot_order_check([("a", [1]), ("b", [2])])
    with pytest.raises(ValueError, match="slot order"):
        g._slot_order_check([("b", [2]), ("a", [1])])
