"""The port's MultiHeadAttention, Transformer layers and stacks against
the JAX package's, on the CPU; the attention route they take; the
limits chip_smoke.py holds K1 to at head dim 64; and the Transformer-base
driver (tools/seq2seq_bench.py) and chip_smoke phases 16-18 at a tiny
size.

The port takes the JAX layers' weights by structured name, both get the
same seeded numpy inputs, and outputs, input gradients and every
parameter's gradient agree in float32 within RTOL / ATOL (the same
formulas; the libraries' matmul and softmax round in other orders).
Dropout is 0 (or the layers are in eval mode) wherever values are
compared.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu.ops.pallas.flash_attention import _fa_core, _fa_fwd

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.tools.measure import agreement

RTOL, ATOL = 1e-4, 2e-5


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    tp.set_device("cpu")
    yield
    _place._default = prev


def _copy(jl, tl):
    tl.set_state_dict({k: np.array(v.numpy())
                       for k, v in jl.state_dict().items()})


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair_run(jl, tl, arrays, call=None, grad_params=True):
    """Run both layers on the same inputs; compare outputs, input
    gradients and (grad_params) every parameter's gradient."""
    call = call or (lambda layer, *ts: layer(*ts))
    res = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        ts = [pkg.to_tensor(a, stop_gradient=a.dtype != np.float32)
              if isinstance(a, np.ndarray) else a for a in arrays]
        out = call(layer, *ts)
        outs = out if isinstance(out, (list, tuple)) else [out]
        outs = [o for o in outs if o is not None and hasattr(o, "numpy")]
        w = np.random.RandomState(7)
        total = sum((o * pkg.to_tensor(w.rand(*o.shape).astype(
            np.float32))).sum() for o in outs)
        total.backward()
        grads = [t.grad.numpy() for t in ts
                 if hasattr(t, "grad") and t.grad is not None]
        pgrads = {k: p.grad.numpy() for k, p in layer.named_parameters()
                  if p.grad is not None}
        res.append(([o.numpy() for o in outs], grads, pgrads))
    (jo, jg, jpg), (to, tg, tpg) = res
    for a, b in zip(to + tg, jo + jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if grad_params:
        assert set(tpg) == set(jpg), sorted(set(tpg) ^ set(jpg))
        for k in jpg:
            np.testing.assert_allclose(tpg[k], jpg[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    return to


# ----------------------------------------------------- MultiHeadAttention
def _masks(B, H, Tq, Tk):
    rng = np.random.RandomState(3)
    keep = rng.rand(B, 1, Tq, Tk) > 0.3
    keep[..., 0] = True
    return {"bool": keep,
            "float": np.where(keep, 0.0, -1e9).astype(np.float32),
            "none": None}


@pytest.mark.parametrize("mask", ["none", "bool", "float"])
@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention_matches_jax(mask, cross):
    jl = jnn.MultiHeadAttention(16, 4, kdim=12 if cross else None,
                                vdim=10 if cross else None)
    tl = tnn.MultiHeadAttention(16, 4, kdim=12 if cross else None,
                                vdim=10 if cross else None)
    _copy(jl, tl)
    q = _x(2, 5, 16)
    k = _x(2, 7, 12, seed=1) if cross else q
    v = _x(2, 7, 10, seed=2) if cross else q
    m = _masks(2, 4, 5, 7 if cross else 5)[mask]
    arrays = [q, k, v] if m is None else [q, k, v, m]
    _pair_run(jl, tl, arrays)


def test_need_weights_returns_none_in_the_weights_place():
    tl = tnn.MultiHeadAttention(16, 4, need_weights=True)
    q = tp.to_tensor(_x(2, 5, 16))
    out, weights = tl(q)
    assert weights is None and tuple(out.shape) == (2, 5, 16)
    cache = tl.gen_cache(q)
    out, weights, cache = tl(q, cache=cache)
    assert weights is None and tuple(cache.k.shape) == (2, 5, 4, 4)


def test_cache_decoding_equals_the_full_pass():
    """Self-attention one query at a time through a Cache equals the full
    pass under the causal mask; cross-attention through a StaticCache
    equals the full cross-attention; in both packages, equal to each
    other."""
    T = 6
    mask = np.where(np.tril(np.ones((T, T))) > 0, 0.0, -1e30).astype(
        np.float32)
    q, mem = _x(2, T, 16), _x(2, 4, 16, seed=5)
    jl, tl = jnn.MultiHeadAttention(16, 4), tnn.MultiHeadAttention(16, 4)
    _copy(jl, tl)
    outs = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        full = layer(pkg.to_tensor(q), attn_mask=pkg.to_tensor(mask))
        cache = layer.gen_cache(pkg.to_tensor(q))
        steps = []
        for t in range(T):
            o, cache = layer(pkg.to_tensor(q[:, t:t + 1]), cache=cache)
            steps.append(o.numpy())
        np.testing.assert_allclose(np.concatenate(steps, 1), full.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert tuple(cache.k.shape) == (2, T, 4, 4)
        static = layer.gen_cache(pkg.to_tensor(mem), pkg.to_tensor(mem),
                                 type(layer).StaticCache)
        cross_full = layer(pkg.to_tensor(q), pkg.to_tensor(mem),
                           pkg.to_tensor(mem))
        cross, static2 = layer(pkg.to_tensor(q), cache=static)
        np.testing.assert_allclose(cross.numpy(), cross_full.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert static2 is static
        outs.append((full.numpy(), cross.numpy()))
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------- layers and stacks
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_jax(normalize_before):
    jl = jnn.TransformerEncoderLayer(16, 4, 32, 0.0, "gelu",
                                     normalize_before=normalize_before)
    tl = tnn.TransformerEncoderLayer(16, 4, 32, 0.0, "gelu",
                                     normalize_before=normalize_before)
    _copy(jl, tl)
    _pair_run(jl, tl, [_x(2, 5, 16), _masks(2, 4, 5, 5)["float"]])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_matches_jax(normalize_before):
    jl = jnn.TransformerDecoderLayer(16, 4, 32, 0.0,
                                     normalize_before=normalize_before)
    tl = tnn.TransformerDecoderLayer(16, 4, 32, 0.0,
                                     normalize_before=normalize_before)
    _copy(jl, tl)
    masks = _masks(2, 4, 5, 6)
    _pair_run(jl, tl, [_x(2, 5, 16), _x(2, 6, 16, seed=1),
                       _masks(2, 4, 5, 5)["bool"], masks["float"]])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_jax(normalize_before):
    """Transformer at d 32, 4 heads, 2 + 2 layers: the output and every
    parameter's gradient (the JAX model's weights loaded by name), with
    the decoder's causal mask from generate_square_subsequent_mask."""
    kw = dict(d_model=32, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=64, dropout=0.0,
              normalize_before=normalize_before)
    jm, tm = jnn.Transformer(**kw), tnn.Transformer(**kw)
    assert list(tm.state_dict()) == list(jm.state_dict())
    _copy(jm, tm)
    np.testing.assert_array_equal(
        tm.generate_square_subsequent_mask(5).numpy(),
        jm.generate_square_subsequent_mask(5).numpy())
    mask = jm.generate_square_subsequent_mask(5).numpy()
    _pair_run(jm, tm, [_x(2, 6, 32), _x(2, 5, 32, seed=1), None, mask],
              call=lambda m, s, t, sm, tmk: m(s, t, sm, tmk))


def test_stack_copies_are_independent_and_named_apart():
    """The stack's copies of the layer start with other weight matrices
    and take new parameter names (distinct optimizer state keys)."""
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(16, 4, 32), 3)
    w = [layer.linear1.weight.detach().numpy() for layer in enc.layers]
    assert not np.allclose(w[0], w[1]) and not np.allclose(w[1], w[2])
    names = [p.name for p in enc.parameters()]
    assert len(set(names)) == len(names)
    np.testing.assert_array_equal(enc.layers[1].norm1.weight.numpy(), 1.0)


def test_decoder_gen_cache_decoding_matches_jax():
    """TransformerDecoder.gen_cache (a Cache and a StaticCache a layer)
    decoding one token a step equals the full masked pass, in both
    packages, and the two packages agree."""
    T = 5
    kw = dict(d_model=16, nhead=4, dim_feedforward=32, dropout=0.0)
    jd = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(**kw), 2)
    td = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(**kw), 2)
    _copy(jd, td)
    tgt, mem = _x(2, T, 16), _x(2, 4, 16, seed=1)
    mask = np.where(np.tril(np.ones((T, T))) > 0, 0.0, -1e30).astype(
        np.float32)
    got = []
    for pkg, dec in ((jp, jd), (tp, td)):
        m = pkg.to_tensor(mem)
        full = dec(pkg.to_tensor(tgt), m, pkg.to_tensor(mask)).numpy()
        cache = dec.gen_cache(m)
        steps = []
        for t in range(T):
            o, cache = dec(pkg.to_tensor(tgt[:, t:t + 1]), m, None, None,
                           cache)
            steps.append(o.numpy())
        np.testing.assert_allclose(np.concatenate(steps, 1), full,
                                   rtol=1e-5, atol=1e-6)
        zipped = dec.gen_cache(m, do_zip=True)
        assert len(zipped) == 2 and len(zipped[0]) == 2
        got.append(full)
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ the route
@pytest.fixture
def min_seq_128():
    prev = tflags.flag("flash_attention_min_seq")
    jprev = jp.get_flags(["FLAGS_flash_attention_min_seq"])[
        "FLAGS_flash_attention_min_seq"]
    tflags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    jp.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    tflags.set_flags({"FLAGS_flash_attention_min_seq": prev})
    jp.set_flags({"FLAGS_flash_attention_min_seq": jprev})


@pytest.mark.parametrize("case,path", [
    ("plain", "flash"), ("mask", "composed"), ("dropout", "composed"),
    ("short", "composed"), ("head_dim_32", "composed")])
def test_attention_route(case, path, min_seq_128):
    """MultiHeadAttention's attention takes K1 (its plain version on the
    CPU) with no mask, no active dropout, T >= flash_attention_min_seq
    and head dim 64; a mask, attention dropout in training, a short T or
    another head dim take composed attention. The output equals the JAX
    layer's where dropout is off. The JAX package decides alike but
    takes composed attention for K1's cases on a CPU (its kernels need a
    TPU), so its route is compared where both are composed."""
    from paddle_tpu.nn.functional import attention as jattn
    T = 64 if case == "short" else 128
    E, H = (64, 2) if case == "head_dim_32" else (128, 2)
    drop = 0.5 if case == "dropout" else 0.0
    jl = jnn.MultiHeadAttention(E, H, drop)
    tl = tnn.MultiHeadAttention(E, H, drop)
    _copy(jl, tl)
    q = _x(2, T, E) * 0.3
    mask = _masks(2, H, T, T)["bool"] if case == "mask" else None
    args = [q] if mask is None else [q, q, q, mask]
    out = tl(*[tp.to_tensor(a) for a in args])
    assert tattn.LAST_PATH == path
    if case != "dropout":
        want = jl(*[jp.to_tensor(a) for a in args])
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
        if path == "composed":
            assert jattn.LAST_PATH == path


# ----------------------------------------- K1 at head dim 64: the limits
@functools.lru_cache(maxsize=None)
def _pallas_k1_d64(dtype):
    """The Pallas K1 (`_fa_core`) against the port's f32 plain version on
    16-bit inputs at [1, 2, 256, 64], not causal."""
    rng = np.random.RandomState(0)
    arrs = [rng.randn(1, 2, 256, 64).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    scale = 1.0 / 8.0
    with pltpu.force_tpu_interpret_mode():
        _, res = _fa_fwd(jq, jk, jv, False, scale)
        lse = res[7] + jnp.log(res[6])
        out, vjp = jax.vjp(lambda a, b, c: _fa_core(a, b, c, False, scale),
                           jq, jk, jv)
        grads = vjp(jdo)
    got = [torch.from_numpy(np.array(g.astype(jnp.float32)))
           for g in (out, lse, *grads)]
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    qr, kr, vr = (t.requires_grad_(True) for t in ts[:3])
    ro, rlse = k1.flash_attention_reference(qr, kr, vr, False, scale,
                                            return_lse=True)
    want = (ro, rlse, *torch.autograd.grad(ro, (qr, kr, vr), ts[3]))
    return {n: agreement(g, w.detach()) for n, g, w in zip(
        ("out", "lse", "dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("entry", ["k1_d64", "k1_d64_x"])
def test_k1_d64_limits_derive_from_reference_kernel(entry):
    """chip_smoke's bf16 limits for K1 at head dim 64 non-causal hold the
    Pallas K1's own reading at that head dim (pinned in
    FLASH_PALLAS_READINGS["k1_d64"]); each is at least its chip reading
    (FLASH_REF_READINGS) and at most FLASH_REF_MARGIN times it, or its
    floor; the f16 limits hold the Pallas K1's float16 reading."""
    import chip_smoke
    c = chip_smoke.FLASH[entry]
    assert not c["causal"] and c["head_dim"] == 64
    assert c["layout"] == "bthd"
    pallas = _pallas_k1_d64("bfloat16")
    pinned = chip_smoke.FLASH_PALLAS_READINGS["k1_d64"]
    for name, limits in chip_smoke.FLASH_TOL["bfloat16"][entry].items():
        for metric, limit in limits.items():
            got = pallas[name][metric]
            assert got <= limit, (entry, name, metric, got, limit)
            assert got == pytest.approx(pinned[name][metric], rel=0.05,
                                        abs=1e-9), (name, metric, got)
            floor = chip_smoke._BF16_FLOOR[name][metric]
            chip = chip_smoke.FLASH_REF_READINGS[entry][name][metric]
            assert limit >= floor and chip <= limit
            assert (limit <= chip_smoke.FLASH_REF_MARGIN * chip
                    or limit == floor), (entry, name, metric, chip, limit)
    f16 = _pallas_k1_d64("float16")
    for name, limits in chip_smoke.FLASH_TOL["float16"][entry].items():
        for metric, limit in limits.items():
            assert f16[name][metric] <= limit, (name, metric)


def test_k1_d64_bound_is_the_issue_arithmetic():
    """Phase 8's bound at k1_d64: forward by bytes (q, k, v, o bf16 of
    8388608 elements each and the f32 lse over 3.35 TB/s), backward by
    operations (10 B H T^2 D over 989 TFLOP/s)."""
    from paddle_tpu_torch.tools.measure import bound
    B, H, T, D = 32, 8, 512, 64
    fwd = bound((2 * B * H * T * D + 2 * B * H * T * D) * 2 + B * H * T * 4,
                4 * B * H * D * T * T)
    bwd = bound((4 + 4) * B * H * T * D * 2 + B * H * T * 4,
                10 * B * H * D * T * T)
    assert fwd[1] == "bytes" and abs(fwd[0] - 0.0202) < 5e-5
    assert bwd[1] == "operations" and abs(bwd[0] - 0.0434) < 5e-5


# ------------------------------------------- the driver and phases 16-18
@pytest.fixture
def tiny_seq2seq(monkeypatch, min_seq_128):
    """seq2seq_bench and chip_smoke phases 16-18 at a tiny size: d_model
    128 in 2 heads of 64 (K1's head dim), 2 + 2 layers, vocabulary 97, 2
    rows of 128 tokens; the LSTM 16 wide over 7 steps. On the CPU the
    kernels' plain versions count no launch, so _require prints."""
    import chip_smoke
    from paddle_tpu_torch.tools import seq2seq_bench as sb
    monkeypatch.setattr(sb, "TRANSFORMER", dict(
        sb.TRANSFORMER, vocab=97, d_model=128, nhead=2, layers=2, d_ff=64))
    monkeypatch.setattr(sb, "TRANSFORMER_BATCH", (2, 128))
    monkeypatch.setattr(sb, "LSTM_LM", dict(sb.LSTM_LM, vocab=50, hidden=16,
                                            num_steps=7, batch=8))
    monkeypatch.setattr(chip_smoke, "DECODE", dict(rows=2, steps=4))
    failed = []
    monkeypatch.setattr(chip_smoke, "_require",
                        lambda ok, what: ok or failed.append(what))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return chip_smoke, sb, failed


def test_phases_16_to_18_at_a_tiny_size(tiny_seq2seq):
    """Every check of phases 16-18 holds on the CPU but the launch
    counts (plain versions launch nothing): the route check, falling
    losses, LAST_PATH flash with bf16 q, the cached greedy decode, the
    save/load round trip bitwise, the beam on a second copy of the
    weights, and each optimizer on the same device twice."""
    chip_smoke, sb, failed = tiny_seq2seq
    cpu = torch.device("cpu")
    res = chip_smoke.drive_transformer(cpu, 0)
    assert all("launches" in f for f in failed), failed
    assert res["last_path"] == "flash" and res["last_dtype"] == "bfloat16"
    failed.clear()
    chip_smoke.check_save_load(res.pop("built"), cpu, 0)
    chip_smoke.drive_lstm(cpu, 0)
    chip_smoke.check_optimizers(cpu, 0)
    assert not failed, failed


def test_transformer_flops_formula():
    """transformer_flops at Transformer-base, 32 x 512 + 512: the
    per-token terms written in its docstring."""
    from paddle_tpu_torch.tools import seq2seq_bench as sb
    d, f, V, L, S, T, B = 512, 2048, 37000, 6, 512, 512, 32
    enc = S * (2 * (4 * d * d + 2 * d * f) + 4 * S * d)
    dec = T * (2 * (6 * d * d + 2 * d * f) + 8 * S * d) + S * 4 * d * d
    want = 3 * B * (L * (enc + dec) + 2 * T * d * V)
    assert sb.transformer_flops(sb.TRANSFORMER, B, S, T) == want
    assert math.isclose(want, 7.1193e12, rel_tol=1e-4)
