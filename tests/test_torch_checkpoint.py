"""AutoCheckpointManager and the anomaly guard of the port against the
JAX package's, on the CPU: the ten cases of tests/test_checkpoint.py run
on both packages, snapshots written by one package restored by the
other, the async save's copy of the state, and the guard through
hapi's `prepare(anomaly=)` and through the process-wide guard on the
eager `optimizer.step`.

Both packages train Linear(4, 2) with Adam and a StepDecay schedule
(tests/test_checkpoint.py's model) from the same starting weights; the
parameters are named explicitly (ParamAttr "w", "b") where the JAX test
opens a fresh unique_name scope, so that a rebuilt model, in either
package, finds its optimizer state under the same keys. Losses are
compared in float32 within 1e-5 relative, as the JAX test compares its
own runs.
"""
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.incubate import checkpoint as jckpt
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.incubate import checkpoint as tckpt
from test_torch_hapi import _both as _hapi_both, _close as _hapi_close

PKGS = {"port": (tpaddle, tckpt), "jax": (jpaddle, jckpt)}
X = np.random.RandomState(0).randn(8, 4).astype("float32")
Y = np.random.RandomState(1).randn(8, 2).astype("float32")


@pytest.fixture(autouse=True)
def _cpu_one_thread():
    prev, threads = _place._default, torch.get_num_threads()
    tpaddle.set_device("cpu")
    torch.set_num_threads(1)
    yield
    _place._default = prev
    torch.set_num_threads(threads)


def _jax_weights(seed):
    jpaddle.seed(seed)
    lin = jpaddle.nn.Linear(4, 2)
    return {k: np.array(v.numpy()) for k, v in lin.state_dict().items()}


def _build(P, seed=7):
    """tests/test_checkpoint.py's _build: the weights are the JAX
    package's draw from `seed` in both packages."""
    model = P.nn.Linear(4, 2, weight_attr=P.ParamAttr(name="w"),
                        bias_attr=P.ParamAttr(name="b"))
    model.set_state_dict(_jax_weights(seed))
    optim = P.optimizer.Adam(1e-2, parameters=model.parameters())
    sched = P.optimizer.lr.StepDecay(learning_rate=0.01, step_size=2)
    return model, optim, sched


def _epoch(P, model, optim):
    loss = ((model(P.to_tensor(X)) - P.to_tensor(Y)) ** 2).mean()
    loss.backward()
    optim.step()
    optim.clear_grad()
    return float(loss.numpy())


def _weight(model):
    return np.array(model.weight.numpy())


def _kill_and_resume(P, ck, d, epochs, async_save):
    """Run `epochs` uninterrupted; then a run killed after epoch 2's
    work (its snapshot lost) and a resume into a model from seed 999.
    Returns (reference losses, interrupted + resumed losses, first
    resumed epoch)."""
    model, optim, _ = _build(P)
    ref = [_epoch(P, model, optim) for _ in range(epochs)]
    m1, o1, s1 = _build(P)
    acp1 = ck.AutoCheckpointManager(d, models=[m1], optimizers=[o1],
                                    lr_schedulers=[s1],
                                    async_save=async_save)
    run1 = []
    for epoch in acp1.train_epoch_range(epochs):
        run1.append(_epoch(P, m1, o1))
        if epoch == 2:
            break
    m2, o2, s2 = _build(P, seed=999)
    acp2 = ck.AutoCheckpointManager(d, models=[m2], optimizers=[o2],
                                    lr_schedulers=[s2],
                                    async_save=async_save)
    run2, first = [], None
    for epoch in acp2.train_epoch_range(epochs):
        first = epoch if first is None else first
        run2.append(_epoch(P, m2, o2))
    return ref, run1[:2] + run2, first


@pytest.mark.parametrize("async_save", [False, True],
                         ids=["kill_and_resume_reproduces_losses",
                              "async_save_resumes_identically"])
def test_kill_and_resume(tmp_path, async_save):
    epochs = 5 if async_save else 6
    res = {name: _kill_and_resume(P, ck, str(tmp_path / name), epochs,
                                  async_save)
           for name, (P, ck) in PKGS.items()}
    for name, (ref, resumed, first) in res.items():
        assert first == 2, name
        np.testing.assert_allclose(resumed, ref, rtol=1e-5)
    np.testing.assert_allclose(res["port"][0], res["jax"][0], rtol=1e-5)


@pytest.mark.parametrize("name", PKGS)
def test_async_save_error_surfaces(tmp_path, name):
    P, ck = PKGS[name]
    m, o, s = _build(P)
    acp = ck.AutoCheckpointManager(str(tmp_path / "x"), models=[m],
                                   optimizers=[o], lr_schedulers=[s])
    acp.save_async(0)
    acp.wait()

    def boom(state, epoch):
        raise IOError("disk full")
    acp._write = boom
    acp.save_async(1)
    with pytest.raises(IOError, match="disk full"):
        acp.wait()
    acp.wait()


def test_async_save_holds_the_state_of_the_call(tmp_path):
    """save_async snapshots the state when it is called: the epoch's
    training that follows, before the writer runs, must not reach the
    file. (`.numpy()` of a CPU tensor is a view of its storage; a
    snapshot of views would hold the later values.)"""
    P = tpaddle
    m, o, s = _build(P)
    _epoch(P, m, o)
    w_at_call = _weight(m)
    acp = tckpt.AutoCheckpointManager(str(tmp_path), models=[m],
                                      optimizers=[o], lr_schedulers=[s])
    write = acp._write

    def late_write(state, epoch):
        for _ in range(3):                 # training moves on meanwhile
            _epoch(P, m, o)
        write(state, epoch)
    acp._write = late_write
    acp.save_async(0)
    acp.wait()
    assert not np.array_equal(_weight(m), w_at_call)
    m2, o2, s2 = _build(P, seed=999)
    back = tckpt.AutoCheckpointManager(str(tmp_path), models=[m2],
                                       optimizers=[o2], lr_schedulers=[s2])
    assert back.restore_latest() == 0
    np.testing.assert_array_equal(_weight(m2), w_at_call)


@pytest.mark.parametrize("name", PKGS)
def test_checkpoint_prune_keeps_max(tmp_path, name):
    P, ck = PKGS[name]
    d = str(tmp_path / "acp")
    model, optim, _ = _build(P)
    acp = ck.AutoCheckpointManager(d, models=[model], optimizers=[optim],
                                   max_keep=2)
    for e in range(5):
        acp.save(e)
    kept = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                  if n.startswith("epoch_"))
    assert kept == [3, 4]


@pytest.mark.parametrize("name", PKGS)
def test_module_level_register_api(tmp_path, name):
    P, ck = PKGS[name]
    model, optim, _ = _build(P)
    ck.register(str(tmp_path / "acp2"), models=[model], optimizers=[optim])
    assert list(ck.train_epoch_range(2)) == [0, 1]
    assert sorted(os.listdir(tmp_path / "acp2")) == ["epoch_0", "epoch_1"]


@pytest.mark.parametrize("writer", PKGS)
def test_sharded_save_roundtrip(tmp_path, writer):
    """save_sharded_state / load_sharded_state round trip: the port
    writes torch tensors as whole shards; files of either package load
    in both, bitwise."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    y = np.random.randn(3, 5).astype("float32")
    d = str(tmp_path / "sharded")
    if writer == "port":
        tckpt.save_sharded_state({"x": torch.from_numpy(x),
                                  "y": tpaddle.to_tensor(y)}, d)
    else:
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as Ps
        mesh = Mesh(np.asarray(jax.devices()), ("dp",))
        jckpt.save_sharded_state(
            {"x": jax.device_put(x, NamedSharding(mesh, Ps("dp", None))),
             "y": jax.device_put(y, NamedSharding(mesh, Ps()))}, d)
    for ck in (tckpt, jckpt):
        back = ck.load_sharded_state(d)
        np.testing.assert_array_equal(back["x"], x)
        np.testing.assert_array_equal(back["y"], y)


def _three_saves(P, ck, d, n=3, **kw):
    model, optim, sched = _build(P)
    mgr = ck.AutoCheckpointManager(d, [model], [optim], [sched],
                                   save_interval_epochs=1, max_keep=3, **kw)
    for e in range(n):
        _epoch(P, model, optim)
        mgr.save(e)
    return model


def _restore(P, ck, d, seed=7, **kw):
    model, optim, sched = _build(P, seed=seed)
    mgr = ck.AutoCheckpointManager(d, [model], [optim], [sched], **kw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = mgr.restore_latest()
    return got, [str(w.message) for w in rec], model, optim, mgr


@pytest.mark.parametrize("name", PKGS)
def test_corrupt_snapshot_falls_back_to_previous(tmp_path, name):
    P, ck = PKGS[name]
    _three_saves(P, ck, str(tmp_path))
    stale = tmp_path / ".tmp_crashed"
    stale.mkdir()
    (stale / "state.pdparams").write_bytes(b"partial")
    newest = tmp_path / "epoch_2" / "state.pdparams"
    newest.write_bytes(newest.read_bytes()[:10])
    got, msgs, model2, optim2, mgr2 = _restore(P, ck, str(tmp_path))
    assert got == 1
    assert any("corrupt" in m for m in msgs)
    assert (tmp_path / "epoch_2.corrupt").exists()
    _epoch(P, model2, optim2)
    mgr2.save(5)
    assert not stale.exists()
    assert (tmp_path / "epoch_5" / "meta.json").exists()


@pytest.mark.parametrize("name", PKGS)
def test_bit_flip_detected_by_checksum_manifest(tmp_path, name):
    P, ck = PKGS[name]
    model = _three_saves(P, ck, str(tmp_path), n=2)
    assert (tmp_path / "epoch_1" / "checksums.json").exists()
    target = tmp_path / "epoch_1" / "state.pdparams"
    blob = bytearray(target.read_bytes())
    at = bytes(blob).find(_weight(model).tobytes())
    assert at >= 0, "weight bytes not found in serialized snapshot"
    blob[at + 3] ^= 0x01
    target.write_bytes(bytes(blob))
    got, msgs, model2, optim2, _ = _restore(P, ck, str(tmp_path))
    assert got == 0
    assert any("checksum mismatch" in m for m in msgs)
    assert (tmp_path / "epoch_1.corrupt").exists()
    _epoch(P, model2, optim2)


@pytest.mark.parametrize("name", PKGS)
def test_require_manifest_refuses_manifestless_snapshot(tmp_path, name):
    P, ck = PKGS[name]
    _three_saves(P, ck, str(tmp_path), n=2)
    os.remove(tmp_path / "epoch_1" / "checksums.json")
    got, msgs, model2, optim2, _ = _restore(P, ck, str(tmp_path), seed=999,
                                            require_manifest=True)
    assert got == 0
    assert any("no checksums.json" in m for m in msgs)
    assert (tmp_path / "epoch_1.corrupt").exists()
    _epoch(P, model2, optim2)


@pytest.mark.parametrize("name", PKGS)
def test_missing_manifest_stays_restorable(tmp_path, name):
    P, ck = PKGS[name]
    model = _three_saves(P, ck, str(tmp_path), n=1)
    os.remove(tmp_path / "epoch_0" / "checksums.json")
    got, _, model2, _, _ = _restore(P, ck, str(tmp_path))
    assert got == 0
    np.testing.assert_array_equal(_weight(model2), _weight(model))


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_snapshot_restores_in_the_other_package(tmp_path, writer, reader):
    """Three epochs in one package, saved each epoch; the other package
    restores the newest snapshot (verifying its manifest) into a model
    from seed 999 and trains on: its next three losses equal the
    writer's own next three (f32, 1e-5 relative), so weights, Adam's
    moments, the step count and the LR schedule all came across."""
    (WP, wck), (RP, rck) = PKGS[writer], PKGS[reader]
    d = str(tmp_path)
    model, optim, sched = _build(WP)
    mgr = wck.AutoCheckpointManager(d, [model], [optim], [sched],
                                    require_manifest=True)
    for e in range(3):
        _epoch(WP, model, optim)
        sched.step()
        mgr.save(e)
    want = []
    for _ in range(3):
        want.append(_epoch(WP, model, optim))
        sched.step()
    got_idx, msgs, model2, optim2, mgr2 = _restore(RP, rck, d, seed=999,
                                                   require_manifest=True)
    assert got_idx == 2 and not msgs
    sched2 = mgr2.lr_schedulers[0]
    assert sched2.last_epoch == sched.last_epoch - 3
    got = []
    for _ in range(3):
        got.append(_epoch(RP, model2, optim2))
        sched2.step()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_prepare_anomaly_skips_the_poisoned_batch():
    """prepare(anomaly="skip_step"): the batch whose features hold a NaN
    is skipped, the fit logs count it, and the weights after the fit
    equal the JAX package's."""
    x = np.random.RandomState(3).randn(48, 8).astype(np.float32)
    x[20, 3] = np.nan                     # batch 1 of 3
    y = np.random.RandomState(4).randint(0, 4, (48, 1)).astype(np.int64)

    def body(P, net):
        model = P.Model(net)
        model.prepare(P.optimizer.Adam(0.01, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss(), anomaly="skip_step")
        logs = []

        class Log(P.callbacks.Callback):
            def on_train_batch_end(self, step, logs_=None):
                logs.append(logs_["anomaly_skipped"])

        model.fit(P.io.TensorDataset([x, y]), batch_size=16, epochs=1,
                  shuffle=False, verbose=0, callbacks=[Log()])
        return logs, [np.array(p.numpy()) for p in net.parameters()]

    (glogs, gw), (wlogs, ww) = _hapi_both(body)
    assert glogs == wlogs == [0, 1, 1]
    for a, b in zip(gw, ww):
        _hapi_close(a, b)


@pytest.mark.parametrize("policy", ["skip_step", "zero_grads", "raise"])
def test_process_guard_on_the_eager_step(policy):
    """set_anomaly_guard(policy) reaches optimizer.step in both packages:
    a gradient with a NaN entry is dropped (skip_step), zeroed where not
    finite (zero_grads) or raises FloatingPointError (raise); the weights
    after the step and the guard's counters agree."""
    def body(P, net):
        from importlib import import_module
        anomaly = import_module(f"{P.__name__}.core.anomaly")
        opt = P.optimizer.SGD(0.5, parameters=net.parameters())
        x = P.to_tensor(np.ones((2, 8), np.float32))
        loss = net(x).sum()
        loss.backward()
        w = net[0].weight
        g = w.grad.numpy().copy()
        g[0, 0] = np.nan
        w.grad = P.to_tensor(g)
        with anomaly.anomaly_guard(policy) as guard:
            try:
                opt.step()
                raised = False
            except FloatingPointError:
                raised = True
        return raised, guard.state_dict(), [np.array(p.numpy())
                                            for p in net.parameters()]

    (graised, gstate, gw), (wraised, wstate, ww) = _hapi_both(body)
    assert graised == wraised == (policy == "raise")
    assert gstate == wstate
    for a, b in zip(gw, ww):
        np.testing.assert_allclose(a, b, atol=1e-6, equal_nan=True)
