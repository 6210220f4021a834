"""paddle.io and paddle.metric of the port against the JAX package's, on
the CPU: the five cases of tests/test_device_loader.py on both
packages, every dataset type, sampler and DataLoader mode at one seeded
input, and every metric.

The samplers and random_split draw from numpy's global stream in both
packages, so each comparison seeds it alike before each package's run
and expects the same indices exactly; the metrics run the same host
arithmetic, so their values are held equal within 1e-6 (f32 inputs).
"""
import collections
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as _place

PKGS = {"port": tpaddle, "jax": jpaddle}


@pytest.fixture(autouse=True)
def _cpu_one_thread():
    prev, threads = _place._default, torch.get_num_threads()
    tpaddle.set_device("cpu")
    torch.set_num_threads(1)
    yield
    _place._default = prev
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def _both(body, seed=0):
    out = {}
    for name, P in PKGS.items():
        np.random.seed(seed)
        out[name] = body(P)
    return out["port"], out["jax"]


def _ds(P, n=20):
    class _DS(P.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return (np.full((3,), i, dtype=np.float32),
                    np.asarray(i, dtype=np.int64))
    return _DS()


def _loader_kw(P):
    # the port's DeviceLoader runs on the CPU here; the JAX one picks its
    # own default device (the CPU under the tests' platform)
    return {"device": "cpu"} if P is tpaddle else {}


# ------------------------------------------ tests/test_device_loader.py
def test_device_loader_preserves_order_and_values():
    def body(P):
        dl = P.io.DataLoader(_ds(P), batch_size=4, shuffle=False)
        seen = []
        for x, y in P.io.DeviceLoader(dl, size=2, **_loader_kw(P)):
            assert isinstance(x, P.Tensor) and isinstance(y, P.Tensor)
            assert x.shape == [4, 3]
            seen.extend(int(v) for v in _np(y))
        return seen

    got, want = _both(body)
    assert got == want == list(range(20))


def test_device_loader_nested_structures_and_len():
    def body(P):
        class _DictDS(P.io.Dataset):
            def __len__(self):
                return 6

            def __getitem__(self, i):
                return {"img": np.ones((2, 2), np.float32) * i,
                        "meta": [np.asarray(i), np.asarray(-i)]}

        dl = P.io.DataLoader(_DictDS(), batch_size=2, shuffle=False)
        dvl = P.io.DeviceLoader(dl, size=3, **_loader_kw(P))
        assert len(dvl) == len(dl) == 3
        batches = list(dvl)
        assert isinstance(batches[0], dict)
        assert isinstance(batches[0]["img"], P.Tensor)
        assert isinstance(batches[0]["meta"][0], P.Tensor)
        return [(_np(b["img"]), _np(b["meta"][0]), _np(b["meta"][1]))
                for b in batches]

    got, want = _both(body)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1][0][0], np.ones((2, 2)) * 2)


def test_device_loader_trains_a_model():
    """DeviceLoader feeding a TrainStep converges like the JAX package's
    (same weights, same batches): the loss curves agree within f32
    rounding over 60 SGD steps."""
    w_true = np.array([[1.0], [-2.0], [0.5]], np.float32)
    jpaddle.seed(0)
    jm = jpaddle.nn.Linear(3, 1)
    tm = tpaddle.nn.Linear(3, 1)
    tm.set_state_dict({k: np.array(v.numpy())
                       for k, v in jm.state_dict().items()})

    def body(P):
        model = jm if P is jpaddle else tm
        optim = P.optimizer.SGD(0.1, parameters=model.parameters())
        step = P.jit.TrainStep(
            model, lambda m, x, y: ((m(x) - y) ** 2).mean(), optim)

        class _Reg(P.io.Dataset):
            def __len__(self):
                return 64

            def __getitem__(self, i):
                rng = np.random.RandomState(i)
                x = rng.randn(3).astype(np.float32)
                return x, (x @ w_true).astype(np.float32)

        losses = []
        for _epoch in range(30):
            for x, y in P.io.DeviceLoader(P.io.DataLoader(
                    _Reg(), batch_size=32), **_loader_kw(P)):
                losses.append(float(step(x, y).numpy()))
        return losses

    got, want = _both(body)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert got[-1] < 0.01 * got[0] + 1e-6, got[-5:]


def test_device_loader_namedtuple_batches():
    Batch = collections.namedtuple("Batch", ["img", "label"])

    def body(P):
        def collate(samples):
            x, y = P.io.default_collate_fn(samples)
            return Batch(img=x, label=y)

        dl = P.io.DataLoader(_ds(P, 8), batch_size=2, collate_fn=collate)
        seen = []
        for b in P.io.DeviceLoader(dl, **_loader_kw(P)):
            assert isinstance(b, Batch)
            assert isinstance(b.img, P.Tensor)
            seen.extend(int(v) for v in _np(b.label))
        return seen

    got, want = _both(body)
    assert got == want == list(range(8))


@pytest.mark.parametrize("name", PKGS)
def test_device_loader_size_validation(name):
    with pytest.raises(ValueError):
        PKGS[name].io.DeviceLoader([], size=0)


# --------------------------------------------------- datasets, samplers
def test_dataset_types_and_random_split():
    def body(P):
        a = np.arange(12, dtype=np.float32).reshape(6, 2)
        b = np.arange(6)
        td = P.io.TensorDataset([a, b])
        comp = P.io.ComposeDataset([td, td])
        cat = P.io.ConcatDataset([td, P.io.Subset(td, [5, 0])])

        class It(P.io.IterableDataset):
            def __iter__(self):
                yield from range(3)

        chain = [v for v in P.io.ChainDataset([It(), It()])]
        parts = P.io.random_split(td, [4, 2])
        frac = P.io.random_split(td, [0.5, 0.5])
        return (len(td), [tuple(map(_np, td[i])) for i in range(6)],
                [tuple(map(_np, comp[i])) for i in range(2)],
                len(cat), [tuple(map(_np, cat[i])) for i in (-1, 6, 7)],
                chain, [p.indices for p in parts],
                [p.indices for p in frac])

    got, want = _both(body, seed=3)
    assert repr(got) == repr(want)


def test_samplers_draw_the_same_indices():
    def body(P):
        src = list(range(10))
        out = [list(P.io.SequenceSampler(src)),
               list(P.io.RandomSampler(src)),
               list(P.io.RandomSampler(src, replacement=True,
                                       num_samples=7)),
               list(P.io.SubsetRandomSampler([1, 3, 5, 7])),
               list(P.io.WeightedRandomSampler([0.1, 0.2, 0.7], 6)),
               list(P.io.BatchSampler(src, shuffle=True, batch_size=3)),
               len(P.io.BatchSampler(src, batch_size=3, drop_last=True))]
        dbs = [P.io.DistributedBatchSampler(src, 2, num_replicas=3,
                                            rank=r, shuffle=True)
               for r in range(3)]
        for s in dbs:
            s.set_epoch(4)
        out.append([list(s) for s in dbs] + [len(dbs[0])])
        return out

    got, want = _both(body, seed=11)
    assert got == want


@pytest.mark.parametrize("num_workers", [0, 3])
def test_dataloader_modes(num_workers):
    """Shuffled map-style batches (in sampler order, worker threads or
    not), worker ids, worker_init_fn once per worker, an
    IterableDataset with drop_last, and string fields left as lists."""
    def body(P):
        seen_ids, inits = set(), []
        lock = threading.Lock()

        class DS(P.io.Dataset):
            def __len__(self):
                return 23

            def __getitem__(self, i):
                info = P.io.get_worker_info()
                with lock:
                    seen_ids.add(None if info is None else info.id)
                return {"x": np.full((2,), i, np.float32), "name": f"s{i}",
                        "i": int(i)}

        def init(wid):
            with lock:
                inits.append(wid)

        dl = P.io.DataLoader(DS(), batch_size=4, shuffle=True,
                             num_workers=num_workers, worker_init_fn=init)
        batches = [(_np(b["x"]), b["name"], _np(b["i"])) for b in dl]

        class It(P.io.IterableDataset):
            def __iter__(self):
                for i in range(10):
                    yield np.asarray([i, -i], np.int64)

        it = [_np(b) for b in P.io.DataLoader(It(), batch_size=4,
                                               drop_last=True)]
        return batches, sorted(seen_ids, key=str), sorted(inits), it, \
            len(dl)

    got, want = _both(body, seed=2)
    for (gx, gn, gi), (wx, wn, wi) in zip(got[0], want[0]):
        np.testing.assert_array_equal(gx, wx)
        assert gn == wn
        np.testing.assert_array_equal(gi, wi)
    assert got[2] == want[2]
    assert [a.tolist() for a in got[3]] == [a.tolist() for a in want[3]]
    assert got[4] == want[4] == 6
    # which worker fetches which batch is up to the threads' timing
    if num_workers:
        assert set(got[1]) <= {0, 1, 2} and got[2] == [0, 1, 2]
    else:
        assert got[1] == [None] and got[2] == []


def test_default_collate_builds_cpu_tensors():
    batch = tpaddle.io.default_collate_fn(
        [(np.ones(2, np.float32), 1, tpaddle.to_tensor([1.0, 2.0]))] * 3)
    assert all(isinstance(t, tpaddle.Tensor) and t.device.type == "cpu"
               for t in batch)
    assert [list(t.shape) for t in batch] == [[3, 2], [3], [3, 2]]


def test_unported_native_datasets_raise():
    for cls in (tpaddle.io.InMemoryDataset, tpaddle.io.QueueDataset):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            cls()


# ------------------------------------------------------------- metrics
def test_metrics_match():
    rng = np.random.RandomState(7)
    pred = rng.rand(16, 6).astype(np.float32)
    label = rng.randint(0, 6, (16, 1)).astype(np.int64)
    onehot = np.eye(6, dtype=np.float32)[label[:, 0]]
    prob = rng.rand(16, 1).astype(np.float32)
    binary = rng.randint(0, 2, (16, 1)).astype(np.int64)

    def body(P):
        out = [_np(P.metric.accuracy(P.to_tensor(pred), P.to_tensor(label),
                                     k=2))]
        acc = P.metric.Accuracy(topk=(1, 3))
        for lab in (label, onehot):
            c = acc.compute(P.to_tensor(pred), P.to_tensor(lab))
            out.append(acc.update(_np(c)))
        out += [acc.accumulate(), acc.name(),
                P.metric.Accuracy().name()]
        for M in (P.metric.Precision, P.metric.Recall):
            m = M()
            m.update(prob, binary)
            m.update(1 - prob, binary)
            out += [m.accumulate(), m.name()]
        auc = P.metric.Auc(num_thresholds=255)
        auc.update(np.concatenate([1 - prob, prob], 1), binary)
        out += [auc.accumulate(), auc.name()]
        auc.reset()
        out.append(auc.accumulate())
        return out

    got, want = _both(body)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (str, list)) and not isinstance(
                w and w[0], (float, np.floating)):
            assert g == w
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), atol=1e-6)


# --------------------------------------------------------- core.monitor
def test_monitor_stats_match():
    from paddle_tpu.core import monitor as jmon
    from paddle_tpu_torch.core import monitor as tmon
    for mon in (tmon, jmon):
        mon.stat_reset()
        mon.stat_add("slice8a_a", 5)
        mon.stat_sub("slice8a_a", 2)
        mon.stat_add("slice8a_b")
    assert tmon.stat_get("slice8a_a") == jmon.stat_get("slice8a_a") == 3
    assert tmon.stat_names() == jmon.stat_names()
    assert tmon.print_stats() == jmon.print_stats()
    assert tmon.device_memory_stats("cpu") == {}
    tmon.stat_reset()
    jmon.stat_reset()
