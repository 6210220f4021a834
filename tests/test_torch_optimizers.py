"""The port's new optimizers, initializers, clipping, nn.utils and
save/load against the JAX package's, on the CPU.

- Optimizers (SGD, Adamax, Adadelta, Adagrad, RMSProp plain and
  centered with momentum, Lamb, Lars, LarsMomentum): 5 steps from the
  same parameters and gradients through the functional bridge
  (init_opt_state / apply_updates, jit.TrainStep's) and through the
  eager step() on a Linear, within 1e-6 of the JAX package (the same
  float32 formulas; the two libraries fuse a multiply-add or not), and
  state dicts that round-trip: a new optimizer given the state dict
  continues exactly as the first.
- Initializers: the deterministic ones exactly equal to the JAX
  package's; the random ones by their bounds and moments (the random
  streams differ).
- Clipping, weight_norm / spectral_norm and parameters_to_vector
  against the JAX package on the same gradients and weights.
- paddle.save / paddle.load in both directions between the packages.
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.core import place as _place

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    tp.set_device("cpu")
    yield
    _place._default = prev


OPTIMIZERS = {
    "SGD": ("SGD", (0.1,), {}),
    "SGD/weight_decay": ("SGD", (0.1,), {"weight_decay": 0.01}),
    "Adamax": ("Adamax", (0.02,), {}),
    "Adadelta": ("Adadelta", (1.0,), {"rho": 0.9}),
    "Adagrad": ("Adagrad", (0.05,), {"initial_accumulator_value": 0.1}),
    "RMSProp": ("RMSProp", (0.01,), {"momentum": 0.9}),
    "RMSProp/centered": ("RMSProp", (0.01,), {"momentum": 0.5,
                                               "centered": True}),
    "Lamb": ("Lamb", (0.01,), {"lamb_weight_decay": 0.05}),
    "Lars": ("Lars", (0.1,), {"lars_weight_decay": 0.001}),
    "LarsMomentum": ("LarsMomentum", (0.1, 0.5), {}),
}


def _params_grads(steps=5):
    rng = np.random.RandomState(8)
    p = {"w": rng.randn(4, 3).astype(np.float32),
         "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
             for _ in range(steps)]
    return p, grads


def _functional(opt_name, args, kw, p, grads, port):
    o = getattr(topt if port else jopt, opt_name)(*args, **kw)
    conv = (lambda v: torch.from_numpy(v.copy())) if port else jnp.asarray
    params = {k: conv(v) for k, v in p.items()}
    state = o.init_opt_state(params)
    for g in grads:
        params, state = o.apply_updates(params, {k: conv(v) for k, v in
                                                 g.items()}, state)
    return {k: np.asarray(v) for k, v in params.items()}, state


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(case):
    name, args, kw = OPTIMIZERS[case]
    p, grads = _params_grads()
    got, tstate = _functional(name, args, kw, p, grads, True)
    want, jstate = _functional(name, args, kw, p, grads, False)
    for k in p:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)
        assert sorted(tstate[k]) == sorted(jstate[k])
        for acc in jstate[k]:
            np.testing.assert_allclose(tstate[k][acc].numpy(),
                                       np.asarray(jstate[k][acc]), rtol=0,
                                       atol=TOL, err_msg=f"{k} {acc}")


def _eager(pkg, opt_name, args, kw, steps=5, clip=None):
    rng = np.random.RandomState(9)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 3).astype(np.float32)
    layer = pkg.nn.Linear(4, 3)
    if clip is not None:
        kw = dict(kw, grad_clip=clip)
    o = getattr(pkg.optimizer, opt_name)(*args, parameters=layer.parameters(),
                                         **kw)
    return layer, o, x, y


def _train(pkg, layer, o, x, y, steps):
    for _ in range(steps):
        loss = ((layer(pkg.to_tensor(x)) - pkg.to_tensor(y)) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_eager_steps_and_state_dict_match_jax(case):
    """The eager loop on a Linear with the JAX layer's weights: the same
    parameters after 5 steps; then the state dict (keys and values the
    JAX package's) loaded into a new optimizer continues exactly as the
    original for 3 more steps."""
    name, args, kw = OPTIMIZERS[case]
    jl, jo, x, y = _eager(jp, name, args, kw)
    tl, to, _, _ = _eager(tp, name, args, kw)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    names = {k: p.name for k, p in tl.named_parameters()}
    for k, p in jl.named_parameters():
        p.name = names[k]
    _train(jp, jl, jo, x, y, 5)
    _train(tp, tl, to, x, y, 5)
    for (k, a), (_, b) in zip(tl.named_parameters(), jl.named_parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL,
                                   err_msg=k)
    tsd, jsd = to.state_dict(), jo.state_dict()
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        if k != "global_step":
            np.testing.assert_allclose(np.asarray(tsd[k]),
                                       np.asarray(jsd[k].numpy()), rtol=0,
                                       atol=TOL, err_msg=k)
    # the port's state dict holds the live accumulators (updated in
    # place, as the reference's are): keep a copy
    tsd = {k: v.clone() if torch.is_tensor(v) else v for k, v in tsd.items()}
    ref = {k: v.detach().clone() for k, v in tl.state_dict().items()}
    _train(tp, tl, to, x, y, 3)
    after = {k: v.numpy().copy() for k, v in tl.state_dict().items()}
    tl.set_state_dict(ref)
    fresh = getattr(topt, name)(*args, parameters=tl.parameters(), **kw)
    fresh.set_state_dict(tsd)
    _train(tp, tl, fresh, x, y, 3)
    for k, v in tl.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), after[k], err_msg=k)


def test_lamb_exclude_fn_and_lars_exclude_list_drop_the_decay():
    """Lamb's exclude_from_weight_decay_fn and Lars's
    exclude_from_weight_decay take a parameter's decay to 0, as the
    reference does: the same steps as with the decay 0."""
    for name, kw_ex, kw_zero in (
            ("Lamb", {"exclude_from_weight_decay_fn": lambda p: True},
             {"lamb_weight_decay": 0.0}),
            ("Lars", {"exclude_from_weight_decay": ["generated"]},
             {"lars_weight_decay": 0.0})):
        runs = []
        for kw in (kw_ex, kw_zero):
            tp.seed(1)
            tl, to, x, y = _eager(tp, name, (0.1,), kw)
            _train(tp, tl, to, x, y, 3)
            runs.append([p.numpy() for p in tl.parameters()])
        for a, b in zip(*runs):
            np.testing.assert_array_equal(a, b)
        tp.seed(1)
        tl, to, x, y = _eager(tp, name, (0.1,), {})
        _train(tp, tl, to, x, y, 3)
        assert not np.array_equal(tl.parameters()[0].numpy(), runs[0][0])


# ------------------------------------------------------------ initializers
def test_deterministic_initializers_equal_jax():
    import paddle_tpu.nn.initializer as JI
    import paddle_tpu_torch.nn.initializer as TI
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    cases = [("Constant", (0.7,), [3, 4]), ("Assign", (v,), [3, 4]),
             ("Assign", (v.reshape(-1).tolist(),), [3, 4]),
             ("NumpyArrayInitializer", (v,), [4, 3]),
             ("Bilinear", (), [2, 3, 4, 4]), ("Bilinear", (), [1, 1, 3, 5]),
             ("Dirac", (), [4, 3, 3, 3]), ("Dirac", (2,), [4, 2, 3])]
    for name, args, shape in cases:
        got = getattr(TI, name)(*args)(shape, "float32")
        want = getattr(JI, name)(*args)(shape, "float32")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    assert TI.ConstantInitializer is TI.Constant
    assert TI.UniformInitializer is TI.Uniform
    assert TI.NormalInitializer is TI.Normal
    assert TI.TruncatedNormalInitializer is TI.TruncatedNormal
    assert TI.XavierInitializer is TI.XavierNormal
    assert TI.MSRAInitializer is TI.KaimingNormal
    assert TI.NumpyArrayInitializer is TI.Assign


def test_random_initializers_bounds_and_moments():
    """Each random initializer's draw over 40000 entries of [200, 200]:
    its bounds and its mean and standard deviation within 3 % of the
    JAX package's formula (the JAX draw's own moments beside it)."""
    import paddle_tpu.nn.initializer as JI
    import paddle_tpu_torch.nn.initializer as TI
    shape = [200, 200]
    tp.seed(0)
    cases = {
        "Uniform": ((-0.3, 0.5), 0.1, 0.8 / 12 ** 0.5, (-0.3, 0.5)),
        "Normal": ((0.2, 1.5), 0.2, 1.5, None),
        "TruncatedNormal": ((0.0, 2.0), 0.0, 2.0 * 0.8796, (-4.0, 4.0)),
        "XavierUniform": ((), 0.0, (6 / 400) ** 0.5 / 3 ** 0.5,
                          (-(6 / 400) ** 0.5, (6 / 400) ** 0.5)),
        "XavierNormal": ((), 0.0, (2 / 400) ** 0.5, None),
        "KaimingUniform": ((), 0.0, (6 / 200) ** 0.5 / 3 ** 0.5,
                           (-(6 / 200) ** 0.5, (6 / 200) ** 0.5)),
        "KaimingNormal": ((), 0.0, (2 / 200) ** 0.5, None),
    }
    for name, (args, mean, std, lims) in cases.items():
        got = getattr(TI, name)(*args)(shape, "float32").numpy()
        want = np.asarray(getattr(JI, name)(*args)(shape, "float32"))
        for a in (got, want):
            assert abs(a.mean() - mean) < 0.03 * max(std, 1e-3) * 3, name
            assert abs(a.std() - std) < 0.03 * std, (name, a.std(), std)
            if lims:
                assert a.min() >= lims[0] - 1e-6 and a.max() <= lims[1] + 1e-6
    for gain, shape in ((1.0, [6, 10]), (2.0, [10, 6]), (0.5, [4, 2, 3])):
        q = TI.Orthogonal(gain)(shape, "float32").numpy().reshape(
            shape[0], -1)
        rows = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(rows, gain ** 2 * np.eye(len(rows)),
                                   atol=1e-5)


# --------------------------------------------------------------- clipping
def _grads():
    rng = np.random.RandomState(3)
    return [rng.randn(4, 3).astype(np.float32) * 3, None,
            rng.randn(5).astype(np.float32)]


@pytest.mark.parametrize("name,args", [("ClipGradByValue", (0.5,)),
                                       ("ClipGradByValue", (0.5, -0.2)),
                                       ("ClipGradByNorm", (1.0,)),
                                       ("ClipGradByGlobalNorm", (2.0,)),
                                       ("GradientClipByNorm", (0.1,))])
def test_clips_match_jax(name, args):
    gs = _grads()
    got = getattr(tnn, name)(*args).clip_arrays(
        [None if g is None else torch.from_numpy(g) for g in gs])
    want = getattr(jnn, name)(*args).clip_arrays(
        [None if g is None else jnp.asarray(g) for g in gs])
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    # the eager form on (param, grad) pairs
    pairs = [(tp.to_tensor(np.zeros_like(g)), tp.to_tensor(g))
             for g in gs if g is not None]
    jpairs = [(jp.to_tensor(np.zeros_like(g)), jp.to_tensor(g))
              for g in gs if g is not None]
    for (_, a), (_, b) in zip(getattr(tnn, name)(*args)(pairs),
                              getattr(jnn, name)(*args)(jpairs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    outs = []
    for pkg in (jp, tp):
        layer = pkg.nn.Linear(3, 4)
        pkg.seed(0)
        x = pkg.to_tensor(np.random.RandomState(2).randn(5, 3).astype(
            np.float32))
        if pkg is tp:
            layer.set_state_dict({k: v.numpy() for k, v in
                                  jlayer.state_dict().items()})
        else:
            jlayer = layer
        (layer(x) * 10).sum().backward()
        total = pkg.nn.clip_grad_norm_(layer.parameters(), 0.5, norm_type)
        outs.append((float(total.numpy()),
                     [p.grad.numpy() for p in layer.parameters()]))
    assert outs[1][0] == pytest.approx(outs[0][0], rel=1e-6)
    for a, b in zip(outs[1][1], outs[0][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ utils
def test_weight_norm_matches_jax():
    jl, tl = jnn.Linear(4, 5), tnn.Linear(4, 5)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    jp.nn.utils.weight_norm(jl, "weight", dim=1)
    tp.nn.utils.weight_norm(tl, "weight", dim=1)
    assert [k for k, _ in tl.named_parameters()] == \
        [k for k, _ in jl.named_parameters()] == ["bias", "weight_g",
                                                 "weight_v"]
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    outs = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        y = layer(pkg.to_tensor(x))
        (y * y).sum().backward()
        outs.append([y.numpy()] + [p.grad.numpy()
                                   for p in layer.parameters()])
    # the output and the bias's and g's gradients equal the JAX
    # package's; v's gradient also runs through ||v|| (the JAX package
    # holds the norm constant there), so it is held to plain autograd
    for a, b in zip(outs[1][:3], outs[0][:3]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    g = torch.from_numpy(tl.weight_g.numpy()).requires_grad_(False)
    v = torch.from_numpy(tl.weight_v.numpy()).requires_grad_(True)
    w = g * v / v.square().sum(dim=0, keepdim=True).sqrt()
    y = torch.from_numpy(x) @ w + torch.from_numpy(tl.bias.numpy())
    (y * y).sum().backward()
    np.testing.assert_allclose(outs[1][3], v.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    y1 = tl(tp.to_tensor(x)).numpy()
    tp.nn.utils.remove_weight_norm(tl)
    assert sorted(k for k, _ in tl.named_parameters()) == ["bias", "weight"]
    np.testing.assert_allclose(tl(tp.to_tensor(x)).numpy(), y1, rtol=1e-5,
                               atol=1e-6)


def test_spectral_norm_matches_jax():
    jl, tl = jnn.Linear(6, 4), tnn.Linear(6, 4)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    jp.nn.utils.spectral_norm(jl, n_power_iterations=2, dim=1)
    tp.nn.utils.spectral_norm(tl, n_power_iterations=2, dim=1)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    assert sorted(tl.state_dict()) == sorted(jl.state_dict())
    x = np.random.RandomState(4).randn(3, 6).astype(np.float32)
    for _ in range(3):
        a = tl(tp.to_tensor(x)).numpy()
        b = jl(jp.to_tensor(x)).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    w = tl.weight.detach().numpy()
    assert abs(np.linalg.svd(w, compute_uv=False)[0] - 1.0) < 0.05


def test_parameters_to_vector_round_trip_matches_jax():
    jl, tl = jnn.Linear(3, 2), tnn.Linear(3, 2)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    tv = tp.nn.utils.parameters_to_vector(tl.parameters())
    jv = jp.nn.utils.parameters_to_vector(jl.parameters())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())
    new = np.arange(8, dtype=np.float32)
    tp.nn.utils.vector_to_parameters(tp.to_tensor(new), tl.parameters())
    jp.nn.utils.vector_to_parameters(jp.to_tensor(new), jl.parameters())
    for a, b in zip(tl.parameters(), jl.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -------------------------------------------------------------- save/load
def _state(pkg):
    layer = pkg.nn.Linear(3, 2)
    o = pkg.optimizer.Adam(0.1, parameters=layer.parameters())
    (layer(pkg.to_tensor(np.ones((2, 3), np.float32))) ** 2).sum() \
        .backward()
    o.step()
    return layer, o


def test_save_in_the_port_load_in_jax(tmp_path):
    """A nested object (model state, optimizer state, an int64 tensor, a
    list and a tuple, plain values) saved by the port loads in the JAX
    package with the same values and dtypes, and the JAX model takes the
    state."""
    tl, to = _state(tp)
    obj = {"model": tl.state_dict(), "opt": to.state_dict(),
           "ids": tp.to_tensor(np.arange(5, dtype=np.int64)),
           "nested": [tp.to_tensor([1.5, 2.5]), (3, "x")], "epoch": 7}
    tp.save(obj, str(tmp_path / "a" / "ckpt.pdparams"))
    got = jp.load(str(tmp_path / "a" / "ckpt.pdparams"))
    assert got["epoch"] == 7 and got["nested"][1] == (3, "x")
    assert got["ids"].numpy().dtype == np.int64
    np.testing.assert_array_equal(got["ids"].numpy(), np.arange(5))
    for k, v in obj["model"].items():
        np.testing.assert_array_equal(got["model"][k].numpy(), v.numpy())
    for k, v in obj["opt"].items():
        if k == "global_step":
            assert got["opt"][k] == v
        elif k != "LR_Scheduler":
            np.testing.assert_array_equal(got["opt"][k].numpy(),
                                          np.asarray(v))
    jl = jnn.Linear(3, 2)
    jl.set_state_dict(got["model"])
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(jl(jp.to_tensor(x)).numpy(),
                               tl(tp.to_tensor(x)).numpy(), rtol=1e-6)
    raw = jp.load(str(tmp_path / "a" / "ckpt.pdparams"), return_numpy=True)
    assert isinstance(raw["ids"], np.ndarray)


def test_save_in_jax_load_in_the_port(tmp_path):
    jl, jo = _state(jp)
    path = str(tmp_path / "j.pdparams")
    jp.save({"model": jl.state_dict(), "opt": jo.state_dict(),
             "ids": jp.to_tensor(np.arange(3, dtype=np.int64))}, path)
    got = tp.load(path)
    assert isinstance(got["ids"], tp.Tensor)
    assert got["ids"].dtype == torch.int64
    tl = tnn.Linear(3, 2)
    missing, unexpected = tl.set_state_dict(got["model"])
    assert not missing and not unexpected
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(tl(tp.to_tensor(x)).numpy(),
                               jl(jp.to_tensor(x)).numpy(), rtol=1e-6)
    to = topt.Adam(0.1, parameters=tl.parameters())
    names = dict(zip([p.name for p in jl.parameters()],
                     [p.name for p in tl.parameters()]))
    to.set_state_dict({(names[k.rsplit("_", 1)[0]] + "_" + k.rsplit("_", 1)[1]
                        if k.rsplit("_", 1)[0] in names else k): v
                       for k, v in got["opt"].items()})
    sd = to.state_dict()
    assert sd["global_step"] == 1
    assert len([k for k in sd if k.endswith("moment1")]) == 2
    assert tp.load(path, return_numpy=True)["ids"].dtype == np.int64


def test_legacy_tensor_dict_loads(tmp_path):
    path = tmp_path / "legacy.pdparams"
    with open(path, "wb") as f:
        pickle.dump({"w": {"__tensor__": True, "value": np.ones(3,
                                                                np.float32),
                           "stop_gradient": False, "name": "w0"}}, f)
    got = tp.load(str(path))
    assert got["w"].name == "w0" and not got["w"].stop_gradient
    np.testing.assert_array_equal(got["w"].numpy(), 1.0)
    assert tp.load(str(path), return_numpy=True)["w"].dtype == np.float32


def test_bfloat16_moves_between_the_packages(tmp_path):
    """bf16 tensors are written as ml_dtypes.bfloat16 arrays (the JAX
    package's form), bit for bit, both ways; without ml_dtypes save()
    refuses them."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    x = torch.randn(4, 5).to(torch.bfloat16)
    tp.save({"x": tp.to_tensor(x)}, str(tmp_path / "t.pd"))
    raw = jp.load(str(tmp_path / "t.pd"), return_numpy=True)["x"]
    assert raw.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(raw.view(np.int16),
                                  x.view(torch.int16).numpy())
    jx = jp.to_tensor(np.asarray(x.float().numpy())).astype("bfloat16")
    jp.save({"x": jx}, str(tmp_path / "j.pd"))
    back = tp.load(str(tmp_path / "j.pd"))["x"]
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.view(torch.int16).numpy(),
                                  x.view(torch.int16).numpy())


def test_bfloat16_save_without_ml_dtypes_raises(monkeypatch, tmp_path):
    from paddle_tpu_torch import framework_io
    monkeypatch.setattr(framework_io, "_bfloat16_type", lambda: None)
    with pytest.raises(TypeError, match="ml_dtypes"):
        tp.save({"x": tp.to_tensor(torch.ones(2, dtype=torch.bfloat16))},
                str(tmp_path / "x.pd"))
