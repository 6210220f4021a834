"""Activation recompute in the port (distributed/fleet/utils.py
`recompute`, GPTConfig.use_recompute) against the JAX package, on the
CPU.

The tiny GPT (GPTConfig.tiny(): vocab 256, hidden 64, 2 layers, 4 heads,
batch 2 x 16) runs through both packages with the same weights
(GPT.load_jax_params) under every use_recompute value the JAX GPT takes.
Limits (float32 on both sides, reductions summed in other orders): the
loss within 1e-5 relative, each gradient within 1e-5 of its tensor's
largest entry, as tests/test_torch_train_step.py holds the step. Within
the port a recomputed forward runs the same operations on the same
values, so its losses and gradients are held bitwise to no recompute,
with dropout 0.1 (the port's generators replayed) and under AMP O1 (the
casts replayed) too. Replays tests/test_jaxplan.py's training parity
(:194-216) and tests/test_distributed.py::test_recompute_matches (:97)
on the port.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.models.generation as jgen
from paddle_tpu.analysis import jaxplan as jjaxplan
from paddle_tpu.distributed.fleet import utils as jutils
from paddle_tpu.jit import _FunctionalizedLayer
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as j_loss_fn

import paddle_tpu_torch as paddle
from paddle_tpu_torch import jit
from paddle_tpu_torch.analysis import jaxplan
from paddle_tpu_torch.core import place
from paddle_tpu_torch.distributed.fleet import utils
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.nn import functional as F

POLICIES = [True, "none", "full", "group:2", "auto"]
B, T = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    prev_threads, prev_dev = torch.get_num_threads(), place._default
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    torch.set_num_threads(prev_threads)
    place._default = prev_dev


def _cfg(cls, policy, **kw):
    c = cls.tiny()
    c.use_recompute = policy
    for k, v in kw.items():
        setattr(c, k, v)
    return c


@pytest.fixture(scope="module")
def weights():
    jpaddle.seed(0)
    jm = JGPT(_cfg(JGPTConfig, False))
    return {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (B, T)).astype(np.int64),
            rng.randint(0, 256, (B, T)).astype(np.int64))


def _port_grads(weights, policy, x, y, **kw):
    tm = GPT.load_jax_params(_cfg(GPTConfig, policy, **kw), weights,
                             device="cpu")
    loss = gpt_loss_fn(tm, torch.from_numpy(x), torch.from_numpy(y))
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return loss, dict(zip(names, grads))


def _jax_grads(weights, policy, x, y):
    jpaddle.seed(0)
    jm = JGPT(_cfg(JGPTConfig, policy))
    jm.set_state_dict(weights)
    inner = _FunctionalizedLayer(lambda a, b: j_loss_fn(jm, a, b), jm)
    params, _ = inner.collect_state()
    jl, jg = jax.jit(jax.value_and_grad(lambda p: inner.pure_call(
        p, {}, jax.random.PRNGKey(0), (jnp.asarray(x), jnp.asarray(y)),
        {})[0]))(params)
    return float(jl), {k: np.asarray(g) for k, g in jg.items()}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_policy_matches_jax(weights, policy):
    """Each use_recompute value: loss and every gradient against the JAX
    GPT under the same value (jax.checkpoint in its traced step)."""
    x, y = _batch()
    loss, grads = _port_grads(weights, policy, x, y)
    jl, jg = _jax_grads(weights, policy, x, y)
    assert abs(loss.item() - jl) <= 1e-5 * abs(jl)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        assert _rel(g.numpy(), jg[k]) <= 1e-5, (policy, k)


def test_policies_are_bitwise_equal_to_no_recompute(weights):
    """The first loss and every gradient, bitwise, across the policies
    (the JAX package holds the first loss bitwise and later steps to
    1e-5: XLA may reassociate a rematted backward; the port's rerun
    runs the same kernels on the same values)."""
    x, y = _batch(2)
    base_loss, base = _port_grads(weights, False, x, y)
    for policy in POLICIES:
        loss, grads = _port_grads(weights, policy, x, y)
        assert loss.item() == base_loss.item(), policy
        for k, g in grads.items():
            assert torch.equal(g, base[k]), (policy, k)


def test_group_sizes_resolve_as_the_jax_package():
    cfg = GPTConfig(vocab_size=61, hidden_size=32, num_layers=4,
                    num_heads=4, max_seq_len=16)
    for policy, want in ((False, 0), (True, 0), ("none", 0), ("full", 1),
                         ("group:2", 2), ("group:9", 4), ("auto", 0)):
        cfg.use_recompute = policy
        m = GPT(cfg, device="cpu")
        jcfg = JGPTConfig(vocab_size=61, hidden_size=32, num_layers=4,
                          num_heads=4, max_seq_len=16,
                          use_recompute=policy)
        assert m._remat_group == JGPT(jcfg)._remat_group == want, policy
    for bad in ("sometimes", 3):
        cfg.use_recompute = bad
        with pytest.raises(ValueError):
            GPT(cfg, device="cpu")


def test_plan_readers_match_the_jax_package():
    assert jaxplan.committed_remat_policy() == \
        jjaxplan.committed_remat_policy() == "none"
    for policy, layers in (("none", 4), ("", 4), ("full", 4),
                           ("group:2", 4), ("group:7", 3)):
        assert jaxplan.remat_group_size(policy, layers) == \
            jjaxplan.remat_group_size(policy, layers)
    for bad in ("group:0", "half"):
        with pytest.raises(ValueError):
            jaxplan.remat_group_size(bad, 4)
        with pytest.raises(ValueError):
            jjaxplan.remat_group_size(bad, 4)


def _train(policy, steps=3):
    """tests/test_jaxplan.py's _train_losses on the port."""
    from paddle_tpu_torch.optimizer import SGD
    cfg = GPTConfig(vocab_size=61, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=16, use_recompute=policy)
    m = GPT(cfg, device="cpu", seed=0)
    opt = SGD(learning_rate=0.1, parameters=m.parameters())

    def loss_fn(mm, x, y):
        return F.cross_entropy(mm(x).reshape(-1, cfg.vocab_size),
                               y.reshape(-1))

    step = jit.TrainStep(m, loss_fn, opt)
    x = torch.from_numpy(np.arange(8, dtype=np.int64)[None, :] % 61)
    y = torch.from_numpy((np.arange(8, dtype=np.int64)[None, :] + 1) % 61)
    losses = [step(x, y).item() for _ in range(steps)]
    return losses, {k: p.detach().clone() for k, p in m.named_parameters()}


def test_auto_and_rematted_policies_train_bitwise_equal_to_baseline():
    """test_jaxplan.py's test_auto_trains_bitwise_equal_to_unremat_
    baseline and test_rematted_policies_share_the_forward on the port:
    three SGD steps, losses and every parameter bitwise."""
    base_losses, base = _train(False)
    assert base_losses[-1] < base_losses[0]
    for policy in ("auto", "full", "group:2", True):
        losses, params = _train(policy)
        assert losses == base_losses, policy
        for k in base:
            assert torch.equal(params[k], base[k]), (policy, k)


@pytest.mark.parametrize("policy", [True, "full", "group:2"], ids=str)
def test_dropout_gradients_equal_without_recompute(weights, policy):
    """Dropout 0.1: the rerun draws the first run's masks from the
    port's generators, so gradients are bitwise those without
    recompute (drawing anew would change every one)."""
    x, y = _batch(3)
    paddle.seed(11)
    base_loss, base = _port_grads(weights, False, x, y, dropout=0.1)
    paddle.seed(11)
    loss, grads = _port_grads(weights, policy, x, y, dropout=0.1)
    paddle.seed(12)
    other_loss, _ = _port_grads(weights, False, x, y, dropout=0.1)
    assert other_loss.item() != base_loss.item()  # the masks matter
    assert loss.item() == base_loss.item()
    for k, g in grads.items():
        assert torch.equal(g, base[k]), k


@pytest.mark.parametrize("policy", [True, "full"], ids=str)
def test_o1_gradients_equal_without_recompute(weights, policy):
    """Under auto_cast O1 (bf16 linears, f32 layer norm and loss) the
    rerun runs under the first run's casts: gradients bitwise equal to
    no recompute (and the loss differs from float32's)."""
    import importlib
    ac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
    x, y = _batch(4)
    f32_loss, _ = _port_grads(weights, False, x, y)

    def run(pol):
        tm = GPT.load_jax_params(_cfg(GPTConfig, pol), weights,
                                 device="cpu")
        with ac.auto_cast(level="O1", dtype="bfloat16"):
            loss = gpt_loss_fn(tm, torch.from_numpy(x), torch.from_numpy(y))
        return loss, torch.autograd.grad(loss, list(tm.parameters()))

    base_loss, base = run(False)
    loss, grads = run(policy)
    assert base_loss.item() != f32_loss.item()
    assert loss.item() == base_loss.item()
    for g, b in zip(grads, base):
        assert torch.equal(g, b)


def test_recompute_function_matches_jax_eager():
    """fleet.utils.recompute at user level on Tensors (the JAX package's
    eager tape node): the output and the input's gradient against the
    JAX package; the result is a Tensor."""
    rng = np.random.RandomState(5)
    xv = rng.randn(3, 8).astype(np.float32)
    jpaddle.seed(1)
    jl = jpaddle.nn.Linear(8, 8)
    tl = paddle.nn.Linear(8, 8)
    tl.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jl.state_dict().items()})

    def body(P, layer):
        return lambda t: P.tanh(layer(t)) * 2.0

    jx = jpaddle.to_tensor(xv, stop_gradient=False)
    jy = jutils.recompute(body(jpaddle, jl), jx)
    jy.sum().backward()
    tx = paddle.to_tensor(xv, stop_gradient=False)
    ty = utils.recompute(body(paddle, tl), tx, preserve_rng_state=True)
    assert isinstance(ty, paddle.Tensor)
    ty.sum().backward()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy.numpy()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-5, atol=1e-6)
    # the JAX package's eager node differentiates its Tensor arguments
    # only, so a layer the function closes over gets no gradient there
    # (jl.weight.grad stays None); the port's gradient equals the one
    # without recompute
    assert jl.weight.grad is None
    w_grad = tl.weight.grad.numpy().copy()
    tl.clear_gradients()
    body(paddle, tl)(paddle.to_tensor(xv)).sum().backward()
    np.testing.assert_array_equal(w_grad, tl.weight.grad.numpy())


def test_local_fs_matches_the_jax_package(tmp_path):
    for pkg, root in ((utils, tmp_path / "port"), (jutils, tmp_path / "jax")):
        fs = pkg.HDFSClient("hadoop", {})
        d = str(root / "a" / "b")
        fs.mkdirs(d)
        fs.touch(d + "/f")
        fs.upload(d + "/f", d + "/g")
        fs.mv(d + "/g", d + "/h")
        fs.download(d + "/h", d + "/i")
        assert fs.is_exist(d + "/i")
        listing = fs.ls_dir(str(root / "a")), fs.ls_dir(d)
        fs.delete(d + "/f")
        fs.delete(str(root / "a"))
        assert not fs.is_exist(d) and fs.ls_dir(d) == ([], [])
        if pkg is utils:
            port_listing = listing
    assert port_listing == listing == ((["b"], []), ([], ["f", "h", "i"]))
