"""The port's GPT train step (paddle_tpu_torch: nn, optimizer, amp, jit,
models.gpt training side) against the JAX package, on the CPU.

Both packages get the same weights (GPT.load_jax_params) and the same
numpy batches. The geometry is a 2-layer GPT (vocab 256, hidden 128,
T 128) with flash_attention_min_seq set to 128 in both packages, once
with 1 head of 128 (the port routes attention to K1) and once with
2 heads of 64 (the port routes to K2, packed pairs). On the CPU the
port's kernel wrappers run their plain versions, and the JAX package
takes composed attention (its kernels need a TPU), so these tests hold
the port's routing, layouts and training math against the reference;
tests/test_torch_flash_attention.py holds K1 and K2 against the Pallas
kernels.

Tolerances (float32 on both sides; the two frameworks sum their
reductions in different orders):
- loss within 1e-5 relative; gradients within 1e-5 relative to each
  tensor's largest entry;
- the O2 master weights within 2 f32 ulps of a float64 recomputation;
- parameters after one step within 2e-6 absolute. One Adam step moves
  a parameter by about lr * g / (|g| + 3.2e-7), so a gradient that is
  zero in exact arithmetic (the key bias: softmax ignores a per-row
  constant) moves by a rounding-noise fraction of lr in either
  package; those entries are held to 0.5 * lr, the rest to 2e-6;
- the 20-step loss curve within 1e-4 relative.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import _FunctionalizedLayer
from paddle_tpu.core import flags as jflags
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as j_loss_fn
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import attention as A
from paddle_tpu_torch.nn.functional import cross_entropy, \
    softmax_with_cross_entropy
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.ops.kernels import packed_flash

LR = 1e-4
B, T = 2, 128


def _geom(heads):
    return dict(vocab_size=256, hidden_size=128, num_layers=2,
                num_heads=heads, max_seq_len=T)


@pytest.fixture(autouse=True)
def min_seq_128():
    jprev = jflags.flag("flash_attention_min_seq")
    prev = flags.flag("flash_attention_min_seq")
    paddle.set_flags({"FLAGS_flash_attention_min_seq": 128})
    flags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    paddle.set_flags({"FLAGS_flash_attention_min_seq": jprev})
    flags.set_flags({"FLAGS_flash_attention_min_seq": prev})


def _pair(heads, seed=0):
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**_geom(heads)))
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    tm = GPT.load_jax_params(GPTConfig(**_geom(heads)), params,
                             device="cpu")
    return jm, tm


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (B, T)).astype(np.int32),
            rng.randint(0, 256, (B, T)).astype(np.int32))


def _steps(heads):
    jm, tm = _pair(heads)
    jo = jopt.AdamW(LR, parameters=jm.parameters(),
                    grad_clip=JClip(1.0))
    to = AdamW(LR, parameters=tm.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0))
    return (jm, paddle.jit.TrainStep(jm, j_loss_fn, jo),
            tm, jit.TrainStep(tm, gpt_loss_fn, to))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("heads", [1, 2])
def test_one_step_matches_jax(heads):
    x, y = _batch()
    jm, jstep, tm, tstep = _steps(heads)
    # gradients: jax.value_and_grad over the JAX model's parameters (the
    # functional form its TrainStep differentiates) vs torch autograd
    inner = _FunctionalizedLayer(lambda a, b: j_loss_fn(jm, a, b), jm)
    params, _ = inner.collect_state()
    jl, jgrads = jax.jit(jax.value_and_grad(lambda p: inner.pure_call(
        p, {}, jax.random.PRNGKey(0), (jnp.asarray(x), jnp.asarray(y)),
        {})[0]))(params)
    jgrads = {k: np.asarray(g) for k, g in jgrads.items()}
    tl = gpt_loss_fn(tm, torch.from_numpy(x), torch.from_numpy(y))
    # the port's route is the kernel (plain twin on the CPU)
    assert A.LAST_PATH == "flash"
    assert tm.blocks[0].attn._pack_gate(T) == (heads == 2)
    names = [k for k, _ in tm.named_parameters()]
    tgrads = torch.autograd.grad(tl, [p for _, p in tm.named_parameters()])
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(tl.item())
    assert set(names) == set(jgrads)
    for k, g in zip(names, tgrads):
        assert _rel(g.numpy(), jgrads[k]) <= 1e-5, k

    p0 = {k: p.detach().clone().numpy() for k, p in tm.named_parameters()}
    jloss = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
    tloss = tstep(x, y).item()
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert A.LAST_PATH == "flash"
    assert tstep.optimizer._global_step == 1
    jp = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    for k, p in tm.named_parameters():
        got = p.detach().numpy()
        # every parameter moved by about lr (Adam's first step)
        assert np.abs(got - p0[k]).max() > 0.5 * LR, k
        err = np.abs(got - jp[k])
        noise = np.abs(jgrads[k]) < 1e-6 * np.abs(jgrads[k]).max() + 1e-12
        assert err[~noise].max(initial=0) <= 2e-6, k
        assert err[noise].max(initial=0) <= 0.5 * LR, k


@pytest.mark.parametrize("heads", [1, 2])
def test_loss_curve_matches_jax(heads):
    x, y = _batch(2)
    _, jstep, _, tstep = _steps(heads)
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
          for _ in range(20)]
    tl = [tstep(x, y).item() for _ in range(20)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[-1] < tl[0]        # same batch every step: the loss falls


def test_o2_bf16_params_f32_masters():
    _, tm = _pair(2)
    opt = AdamW(LR, parameters=tm.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    tm, opt = amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert opt._multi_precision
    step = jit.TrainStep(tm, gpt_loss_fn, opt)
    x, y = _batch(3)
    names = [k for k, _ in tm.named_parameters()]
    masters0 = {k: p.detach().float().clone()
                for k, p in tm.named_parameters()}
    # this step's gradients, recomputed on an identical bf16 model
    twin = GPT(tm.cfg, device="cpu").to(torch.bfloat16)
    twin.load_state_dict(tm.state_dict())
    loss = gpt_loss_fn(twin, torch.from_numpy(x), torch.from_numpy(y))
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(twin.parameters()))))
    step(x, y)
    state = step._opt_state
    # the clip in f32 (squares summed in f32, scale applied in bf16), then
    # AdamW over the f32 masters recomputed in float64
    norm = torch.sqrt(sum(grads[k].float().square().sum()
                          for k in sorted(names)))
    scale = (1.0 / torch.clamp(norm, min=1.0)).to(torch.bfloat16)
    for k, p in tm.named_parameters():
        st = state[k]
        assert st["master"].dtype == torch.float32
        assert st["moment1"].dtype == torch.float32
        assert p.dtype == torch.bfloat16
        g = (grads[k] * scale).double()
        m = 0.1 * g
        v = 0.001 * g * g
        lr_t = LR * np.sqrt(1 - 0.999) / (1 - 0.9)
        want = masters0[k].double() * (1 - LR * 0.01) \
            - lr_t * m / (v.sqrt() + 1e-8)
        # f32 masters: within 2 ulps of the float64 recomputation
        torch.testing.assert_close(st["master"].double(), want,
                                   rtol=2.4e-7, atol=1e-9)
        assert torch.equal(p, st["master"].to(torch.bfloat16))


# ------------------------------------------------------- parts of the step
def test_cross_entropy_matches_jax():
    from paddle_tpu.nn import functional as JF
    rng = np.random.RandomState(4)
    logits = rng.randn(37, 50).astype(np.float32) * 3
    label = rng.randint(0, 50, (37,)).astype(np.int64)
    label[[3, 9, 20]] = -100
    for reduction in ("mean", "sum", "none"):
        z = paddle.to_tensor(logits, stop_gradient=False)
        jl = JF.cross_entropy(z, paddle.to_tensor(label),
                              reduction=reduction)
        jval = jl.numpy()
        paddle.sum(jl).backward()
        jgrad = z.grad.numpy()
        x = torch.from_numpy(logits).requires_grad_(True)
        got = cross_entropy(x, torch.from_numpy(label), reduction=reduction)
        got.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), jval, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0,
                                   atol=1e-6)
    per = softmax_with_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(label)[:, None])
    jper = JF.softmax_with_cross_entropy(paddle.to_tensor(logits),
                                         paddle.to_tensor(label[:, None]))
    np.testing.assert_allclose(per.numpy(), np.asarray(jper._value),
                               rtol=1e-6, atol=1e-6)


def test_cross_entropy_chunks_rows(monkeypatch):
    """Rows split across several chunks give the one-chunk result."""
    from paddle_tpu_torch.nn.functional import loss as L
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(23, 16).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, 16, (23,)))
    x1 = logits.clone().requires_grad_(True)
    whole = cross_entropy(x1, label)
    whole.backward()
    monkeypatch.setattr(L, "_CHUNK_ELEMS", 16 * 5)   # 5 rows per chunk
    x2 = logits.clone().requires_grad_(True)
    chunked = cross_entropy(x2, label)
    chunked.backward()
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)
    torch.testing.assert_close(x2.grad, x1.grad, rtol=0, atol=1e-7)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.RandomState(6)
    grads = [rng.randn(*s).astype(np.float32) * 3
             for s in ((4, 5), (7,), (3, 3))]
    need = [True, False, True]
    want = JClip(1.0).clip_arrays([jnp.asarray(g) for g in grads], need)
    got = ClipGradByGlobalNorm(1.0).clip_arrays(
        [torch.from_numpy(g) for g in grads], need)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert got[1] is not None and np.array_equal(got[1].numpy(), grads[1])
    small = [torch.full((3,), 0.1)]      # norm under the clip: unchanged
    torch.testing.assert_close(ClipGradByGlobalNorm(1.0).clip_arrays(
        small)[0], small[0])


@pytest.mark.parametrize("master", [False, True])
def test_adamw_apply_updates_matches_jax(master):
    rng = np.random.RandomState(7)
    params = {"a": rng.randn(6, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jo = jopt.AdamW(1e-2)
    to = AdamW(1e-2)
    jo._multi_precision = to._multi_precision = master
    dt_j = jnp.bfloat16 if master else jnp.float32
    dt_t = torch.bfloat16 if master else torch.float32
    jp = {k: jnp.asarray(v, dt_j) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(dt_t) for k, v in params.items()}
    js, ts = jo.init_opt_state(jp), to.init_opt_state(tp)
    for g in grads:
        jp, js = jo.apply_updates(
            jp, {k: jnp.asarray(v, dt_j) for k, v in g.items()}, js)
        tp, ts = to.apply_updates(
            tp, {k: torch.from_numpy(v).to(dt_t) for k, v in g.items()}, ts)
    for k in params:
        key = "master" if master else None
        got = ts[k][key] if key else tp[k]
        want = js[k][key] if key else jp[k]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=0, atol=1e-6)
        for acc in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_allclose(ts[k][acc].float().numpy(),
                                       np.asarray(js[k][acc], np.float32),
                                       rtol=1e-6, atol=1e-7)


def test_pack_gate_scope():
    """Port twin of tests/test_packed_flash.py:157-168 (without the TPU
    backend test, which the port's gate does not have)."""
    assert packed_flash.supported(64, 12, 1024, 1024)
    assert packed_flash.supported(64, 12, 2048, 2048)
    assert packed_flash.supported(64, 12, 8192, 8192)
    assert not packed_flash.supported(128, 6, 1024, 1024)
    assert not packed_flash.supported(64, 11, 1024, 1024)
    assert not packed_flash.supported(64, 12, 16384, 16384)
    assert not packed_flash.supported(64, 12, 1024, 512)
    assert not packed_flash.supported(64, 12, 1000, 1000)
    assert packed_flash.route_gate(64, 12, 1024, 1024)
    assert not packed_flash.route_gate(64, 12, 1024, 1024,
                                       dropout_active=True)
    assert not packed_flash.route_gate(64, 12, 1024, 1024, masked=True)
    assert not packed_flash.route_gate(64, 12, 64, 64)   # under min_seq


def test_sdpa_routing_is_deliberate():
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 128, 64).astype(np.float32))
               for _ in range(3))
    A.scaled_dot_product_attention(q, k, v, is_causal=True,
                                   _heads_major=True)
    assert A.LAST_PATH == "flash"
    mask = torch.ones(128, 128, dtype=torch.bool)
    A.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                   _heads_major=True)
    assert A.LAST_PATH == "composed"
    A.scaled_dot_product_attention(q[:, :, :96], k[:, :, :96],
                                   v[:, :, :96], _heads_major=True)
    assert A.LAST_PATH == "composed"     # outside K1's scope
    flags.set_flags({"FLAGS_use_flash_attention": False})
    try:
        A.scaled_dot_product_attention(q, k, v, _heads_major=True)
        assert A.LAST_PATH == "composed"
    finally:
        flags.set_flags({"FLAGS_use_flash_attention": True})
    with pytest.raises(ValueError):
        flags.set_flags({"FLAGS_no_such_flag": 1})
