"""hapi's Model on the port against the JAX package's, on the CPU: the
ten cases of tests/test_hapi.py and tests/test_book.py's
test_recognize_digits_hapi, each body run on both packages.

Both packages get the same weights (the JAX network's state dict copied
into the port's), the same data and the same numpy / Python global
seeds before each run (neither package's paddle.seed seeds them, and
the samplers shuffle from numpy's stream), so the losses, metrics,
predictions and saved files are compared, float32 within the
tolerance each case states; then the JAX test's own assertions are
held on the port.
"""
import json
import os
import random
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as _place

TOL = dict(rtol=1e-4, atol=1e-5)   # f32 training over a few dozen steps


@pytest.fixture(autouse=True)
def _cpu_one_thread():
    prev, threads = _place._default, torch.get_num_threads()
    tpaddle.set_device("cpu")
    torch.set_num_threads(1)
    yield
    _place._default = prev
    torch.set_num_threads(threads)


def _tiny_class_data(P, n=64, d=8, classes=4, seed=0):
    class TinyClassData(P.io.Dataset):
        def __init__(self):
            rng = np.random.RandomState(seed)
            self.x = rng.randn(n, d).astype(np.float32)
            w = rng.randn(d, classes).astype(np.float32)
            self.y = (self.x @ w).argmax(-1).astype(np.int64)[:, None]

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return self.x[i], self.y[i]
    return TinyClassData()


def _mlp(P, d=8, classes=4):
    return P.nn.Sequential(P.nn.Linear(d, 32), P.nn.ReLU(),
                           P.nn.Linear(32, classes))


def _same_weights(jnet, tnet):
    tnet.set_state_dict({k: np.array(v.numpy())
                         for k, v in jnet.state_dict().items()})
    return tnet


def _both(body, make_net=_mlp):
    """body(P, net) on the JAX package then the port, the port's net
    holding the JAX net's weights, numpy's and Python's global streams
    seeded alike before each; returns (port result, JAX result)."""
    jpaddle.seed(0)
    jnet = make_net(jpaddle)
    tnet = _same_weights(jnet, make_net(tpaddle))
    out = []
    for P, net in ((jpaddle, jnet), (tpaddle, tnet)):
        np.random.seed(5)
        random.seed(5)
        out.append(body(P, net))
    return out[1], out[0]


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), **(tol or TOL))


def test_fit_trains_and_reports_metrics(capsys):
    def body(P, net):
        model = P.Model(net)
        opt = P.optimizer.Adam(learning_rate=0.01,
                               parameters=model.parameters())
        model.prepare(opt, P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        data = _tiny_class_data(P)
        model.fit(data, epochs=4, batch_size=16, verbose=2, log_freq=2)
        res = model.evaluate(data, batch_size=16, verbose=0)
        return res, capsys.readouterr().out

    (got, out), (want, jout) = _both(body)
    assert got["acc"] == want["acc"]
    _close(got["loss"], want["loss"])
    assert got["acc"] > 0.8, got
    assert "Epoch 1/4" in out and "loss" in out
    # the same progress lines but the timings and the last digits
    strip = (lambda s: re.sub(r"\(\d+\.\ds\)|\d\.\d{4}", "#", s))
    assert strip(out) == strip(jout)


def test_predict_stacked():
    def body(P, net):
        class XOnly(P.io.Dataset):
            def __init__(self):
                self.x = np.random.RandomState(0).randn(20, 8).astype(
                    np.float32)

            def __len__(self):
                return 20

            def __getitem__(self, i):
                return (self.x[i],)

        model = P.Model(net)
        model.prepare(None, None, None)
        return model.predict(XOnly(), batch_size=8, stack_outputs=True,
                             verbose=0)

    got, want = _both(body)
    assert len(got) == 1 and got[0].shape == (20, 4)
    _close(got[0], want[0], atol=1e-6, rtol=0)


def test_train_batch_eval_batch():
    def body(P, net):
        model = P.Model(net)
        opt = P.optimizer.SGD(learning_rate=0.1,
                              parameters=model.parameters())
        model.prepare(opt, P.nn.CrossEntropyLoss())
        rng = np.random.RandomState(1)
        x = rng.randn(8, 8).astype(np.float32)
        y = rng.randint(0, 4, (8, 1)).astype(np.int64)
        losses = [model.train_batch([x], [y])[0] for _ in range(21)]
        return losses, model.eval_batch([x], [y])

    (got, gev), (want, wev) = _both(body)
    _close(got, want)
    _close(gev, wev)
    assert got[-1] < got[0] and np.isfinite(gev[0])


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_save_load_checkpoint(tmp_path, saver):
    """fit with save_dir writes 0.pdparams and final.pdparams; a fresh
    Model loads final. Files written by either package load into the
    port's model and the JAX one's, equal to the trained weights."""
    def body(P, net):
        model = P.Model(net)
        opt = P.optimizer.Adam(learning_rate=0.01,
                               parameters=model.parameters())
        model.prepare(opt, P.nn.CrossEntropyLoss())
        d = str(tmp_path / P.__name__)
        model.fit(_tiny_class_data(P, n=32), epochs=1, batch_size=16,
                  save_dir=d, verbose=0)
        assert os.path.exists(os.path.join(d, "final.pdparams"))
        assert os.path.exists(os.path.join(d, "0.pdparams"))
        return d, np.array(model.network[0].weight.numpy())

    (tdir, tw), (jdir, jw) = _both(body)
    _close(tw, jw)
    src, w = (tdir, tw) if saver == "port" else (jdir, jw)
    for P in (tpaddle, jpaddle):
        model2 = P.Model(_mlp(P))
        opt2 = P.optimizer.Adam(learning_rate=0.01,
                                parameters=model2.parameters())
        model2.prepare(opt2, P.nn.CrossEntropyLoss())
        model2.load(os.path.join(src, "final"))
        np.testing.assert_array_equal(
            np.array(model2.network[0].weight.numpy()), w)


def test_early_stopping_stops():
    def body(P, net):
        model = P.Model(net)
        opt = P.optimizer.SGD(learning_rate=0.0,
                              parameters=model.parameters())
        model.prepare(opt, P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        data = _tiny_class_data(P, n=32)
        es = P.callbacks.EarlyStopping(monitor="acc", patience=1,
                                       save_best_model=False, verbose=0)
        model.fit(data, eval_data=data, epochs=10, batch_size=16,
                  verbose=0, callbacks=[es])
        return model.stop_training, es.wait, es.best, es.stopped_epoch

    got, want = _both(body)
    assert got == want
    assert got[0] and got[1] >= 1


def test_lr_scheduler_callback_steps():
    def body(P, net):
        sched = P.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                         gamma=0.5)
        model = P.Model(net)
        opt = P.optimizer.SGD(learning_rate=sched,
                              parameters=model.parameters())
        model.prepare(opt, P.nn.CrossEntropyLoss())
        model.fit(_tiny_class_data(P, n=32), epochs=1, batch_size=16,
                  verbose=0)
        return opt.get_lr()

    got, want = _both(body)
    assert got == want and got < 0.1


def test_summary_counts_params(capsys):
    got = tpaddle.summary(_mlp(tpaddle), (1, 8))
    tout = capsys.readouterr().out
    want = jpaddle.summary(_mlp(jpaddle), (1, 8))
    jout = capsys.readouterr().out
    assert got == want
    assert got["total_params"] == 8 * 32 + 32 + 32 * 4 + 4
    assert tout == jout and "Total params" in tout


def test_flops_positive():
    got = tpaddle.flops(_mlp(tpaddle), [1, 8])
    assert got == jpaddle.flops(_mlp(jpaddle), [1, 8])
    assert got >= 2 * (8 * 32 + 32 * 4)


def _lenet(P):
    return P.vision.models.LeNet()


def test_model_with_lenet_mnist_style():
    def body(P, net):
        class FakeMNIST(P.io.Dataset):
            def __init__(self, n=32):
                rng = np.random.RandomState(0)
                self.x = rng.randn(n, 1, 28, 28).astype(np.float32)
                self.y = rng.randint(0, 10, (n, 1)).astype(np.int64)

            def __len__(self):
                return len(self.x)

            def __getitem__(self, i):
                return self.x[i], self.y[i]

        model = P.Model(net)
        opt = P.optimizer.Adam(learning_rate=0.001,
                               parameters=model.parameters())
        model.prepare(opt, P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        model.fit(FakeMNIST(), epochs=1, batch_size=16, verbose=0)
        return model.evaluate(FakeMNIST(), batch_size=16, verbose=0)

    got, want = _both(body, _lenet)
    assert "acc" in got and "loss" in got
    assert got["acc"] == want["acc"]
    _close(got["loss"], want["loss"])


def test_visualdl_callback_writes_scalars(tmp_path):
    def flat(P):
        return P.nn.Sequential(P.nn.Flatten(), P.nn.Linear(16, 4))

    def body(P, net):
        model = P.Model(net)
        model.prepare(P.optimizer.Adam(1e-3, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        rng = np.random.RandomState(2)
        X = P.to_tensor(rng.randn(32, 4, 4).astype("float32"))
        Y = P.to_tensor(rng.randint(0, 4, (32, 1)))
        loader = P.io.DataLoader(P.io.TensorDataset([X, Y]),
                                 batch_size=16)
        d = tmp_path / P.__name__
        cb = P.callbacks.VisualDL(log_dir=str(d))
        model.fit(loader, epochs=2, verbose=0, callbacks=[cb])
        return [json.loads(line) for line in open(d / "train.jsonl")]

    got, want = _both(body, flat)
    assert [(r["tag"], r["step"]) for r in got] == \
        [(r["tag"], r["step"]) for r in want]
    _close([r["value"] for r in got], [r["value"] for r in want])
    assert len(got) >= 2
    assert all("tag" in r and "value" in r for r in got)
    assert any(r["tag"].startswith("train/") for r in got)


def _digits(P):
    return P.nn.Sequential(
        P.nn.Flatten(), P.nn.Linear(784, 64), P.nn.ReLU(),
        P.nn.Linear(64, 4))


def test_recognize_digits_hapi():
    """tests/test_book.py::test_recognize_digits_hapi on both packages:
    8 epochs of shuffled batches through Model.fit."""
    rs = np.random.RandomState(0)
    X = rs.randn(128, 1, 28, 28).astype("float32")
    q = np.stack([X[:, 0, :14, :14].mean((1, 2)),
                  X[:, 0, :14, 14:].mean((1, 2)),
                  X[:, 0, 14:, :14].mean((1, 2)),
                  X[:, 0, 14:, 14:].mean((1, 2))], 1)
    Y = q.argmax(1).astype("int64")[:, None]

    def body(P, net):
        ds = P.io.TensorDataset([P.to_tensor(X), P.to_tensor(Y)])
        loader = P.io.DataLoader(ds, batch_size=32, shuffle=True)
        model = P.Model(net)
        model.prepare(P.optimizer.Adam(5e-3, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        model.fit(loader, epochs=8, verbose=0)
        return model.evaluate(loader, verbose=0)

    got, want = _both(body, _digits)
    assert got["acc"] == want["acc"]
    _close(got["loss"], want["loss"], rtol=1e-3, atol=1e-4)
    assert got["acc"] > 0.8, got

