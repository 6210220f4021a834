"""Kernels K1 and K2 of the port (ops/kernels/flash_attention.py and
packed_flash.py) against the JAX package's Pallas kernels, on the CPU.

The Pallas TPU kernels run here in interpret mode
(`jax.experimental.pallas.tpu.force_tpu_interpret_mode()`), with no edit
to the JAX package: K1's `_fa_core` (its `_supported` is False off a
TPU, so the core is called directly) at [1, 2, 256, 128], and K2's
`packed_flash_attention` at T 256 (its single-program backward) and
T 1152 (its FA2 backward). The port's route on CPU tensors is each
kernel's plain version; the CUDA kernels themselves are held against
those plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerance: float32, 2e-5 relative to each tensor's largest entry (the
kernels sum blocks of the softmax and of the products in another order
than the plain version; measured differences are a few 1e-7).

In bf16 the same Pallas kernels anchor the CUDA kernels' bf16 limits
(chip_smoke.FLASH_TOL): their agreement with the port's f32 plain
versions on bf16 inputs at [1, 2, 256, 128], by tools/measure.agreement.
The chip check runs at B 32, where the per-element maximum grows, so its
limits come from chip_smoke.reference_rounding (the reference's rounding
points in plain PyTorch) read at that shape; here the test recomputes the
Pallas readings, holds reference_rounding to them, and checks that each
limit lies between its chip reading and FLASH_REF_MARGIN times it (or at
the limit it had before, which no limit goes below).
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import packed_flash as jpf
from paddle_tpu.ops.pallas.flash_attention import _fa_core, _fa_fwd

from paddle_tpu_torch.core import flags
from paddle_tpu_torch.nn.functional import attention as A
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.ops.kernels import packed_flash as k2
from paddle_tpu_torch.tools.measure import agreement

TOL = 2e-5


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _jax_value_and_grads(fn, q, k, v, w):
    """fn's output and d(sum(out * w))/d(q, k, v)."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    wj = jnp.asarray(w)
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * wj), argnums=(0, 1, 2))(
        *args)
    return out, grads


def _port_value_and_grads(fn, q, k, v, w):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    return out, grads


@pytest.mark.parametrize("causal", [True, False])
def test_k1_matches_pallas_interpret(causal):
    q, k, v, w = _inputs((1, 2, 256, 128), seed=int(causal))
    scale = 1.0 / math.sqrt(128)
    with pltpu.force_tpu_interpret_mode():
        jout, jgrads = _jax_value_and_grads(
            lambda a, b, c: _fa_core(a, b, c, causal, scale), q, k, v, w)

    def port(a, b, c):
        out = A.scaled_dot_product_attention(a, b, c, is_causal=causal,
                                             _heads_major=True)
        assert A.LAST_PATH == "flash"
        return out

    prev = flags.flag("flash_attention_min_seq")
    flags.set_flags({"FLAGS_flash_attention_min_seq": 256})
    try:
        pout, pgrads = _port_value_and_grads(port, q, k, v, w)
    finally:
        flags.set_flags({"FLAGS_flash_attention_min_seq": prev})
    _close(pout, jout)
    for g, jg in zip(pgrads, jgrads):
        _close(g, jg)
    # and against the JAX package's composed attention (`_sdpa`, taken
    # when the query is under flash_attention_min_seq)
    jprev = jflags.flag("flash_attention_min_seq")
    paddle.set_flags({"FLAGS_flash_attention_min_seq": 1 << 20})
    try:
        ts = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        cout = JF.scaled_dot_product_attention(
            *ts, is_causal=causal, _heads_major=True)
        paddle.sum(cout * paddle.to_tensor(w)).backward()
    finally:
        paddle.set_flags({"FLAGS_flash_attention_min_seq": jprev})
    _close(pout, cout.numpy())
    for g, t in zip(pgrads, ts):
        _close(g, t.grad.numpy())


@pytest.mark.parametrize("T,causal", [(256, True), (256, False),
                                      (1152, True)])
def test_k2_matches_pallas_interpret(T, causal):
    q, k, v, w = _inputs((1, 1, T, 128), seed=T + int(causal))
    scale = 1.0 / math.sqrt(64)
    with pltpu.force_tpu_interpret_mode():
        jout, jgrads = _jax_value_and_grads(
            lambda a, b, c: jpf.packed_flash_attention(a, b, c, causal,
                                                       scale), q, k, v, w)

    def port(a, b, c):
        out = A.scaled_dot_product_attention(
            a, b, c, is_causal=causal, _heads_major=True,
            _packed_pairs=True)
        assert A.LAST_PATH == "flash"
        return out

    pout, pgrads = _port_value_and_grads(port, q, k, v, w)
    _close(pout, jout)
    for g, jg in zip(pgrads, jgrads):
        _close(g, jg)


def test_k1_paddle_layout_and_lse():
    """heads_major=False reads [B, T, H, D] through a strided view; the
    forward's lse is each row's logsumexp; the backward computes FA2's
    products from the out and lse it is given."""
    q, k, v, w = _inputs((2, 128, 2, 64), seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = k1.flash_attention(tq, tk, tv, causal=True)
    want = k1.flash_attention(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                              causal=True, heads_major=True)
    torch.testing.assert_close(got, want.transpose(1, 2))
    qh, kh, vh = (t.transpose(1, 2) for t in (tq, tk, tv))
    out, lse = k1.flash_attention_fwd(qh, kh, vh, causal=True)
    s = np.einsum("bhtd,bhsd->bhts", q.transpose(0, 2, 1, 3).astype(
        np.float64), k.transpose(0, 2, 1, 3).astype(np.float64)) / 8.0
    s = np.where(np.tril(np.ones((128, 128), bool)), s, -np.inf)
    mx = s.max(-1)
    want_lse = mx + np.log(np.exp(s - mx[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=1e-5)
    do = torch.from_numpy(w).transpose(1, 2)
    dq, dk, dv = k1.flash_attention_bwd(qh, kh, vh, out, lse, do,
                                        causal=True)
    # the backward reads the given out and lse, as the kernel does: FA2's
    # products from them, evaluated here in float64 with numpy (the
    # agreement with autograd's gradient is held in
    # test_torch_ring_attention.py, beside a block given a longer row's
    # lse)
    qd, kd, vd, od, dod = (t.contiguous().numpy().astype(np.float64)
                           for t in (qh, kh, vh, out, do))
    p = np.where(np.tril(np.ones((128, 128), bool)),
                 np.exp(np.einsum("bhtd,bhsd->bhts", qd, kd) / 8.0
                        - lse.numpy().astype(np.float64)[..., None]), 0.0)
    ds = p * (np.einsum("bhtd,bhsd->bhts", dod, vd)
              - (dod * od).sum(-1, keepdims=True)) / 8.0
    grads = (np.einsum("bhts,bhsd->bhtd", ds, kd),
             np.einsum("bhts,bhtd->bhsd", ds, qd),
             np.einsum("bhts,bhtd->bhsd", p, dod))
    for g, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(g, torch.from_numpy(want).float(),
                                   rtol=0, atol=1e-6)
    assert k1.flash_attention_fwd.launches == 0      # plain version only


def test_k2_is_k1_on_unpacked_heads():
    """The packed plain version equals K1's on the unpacked heads: head
    2i in lanes 0:64, head 2i+1 in lanes 64:128; lse is [B, H/2, 2, T]."""
    q, k, v, _ = _inputs((2, 3, 128, 128), seed=6)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = k2.packed_flash_fwd(tq, tk, tv, causal=True)
    for pair in range(3):
        for half in range(2):
            sl = slice(64 * half, 64 * half + 64)
            o1, l1 = k1.flash_attention_fwd(
                tq[:, pair:pair + 1, :, sl], tk[:, pair:pair + 1, :, sl],
                tv[:, pair:pair + 1, :, sl], causal=True, scale=0.125)
            torch.testing.assert_close(out[:, pair:pair + 1, :, sl], o1)
            torch.testing.assert_close(lse[:, pair, half], l1[:, 0])
    assert k2.packed_flash_fwd.launches == 0


def _bf16_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 2, 256, 128).astype(np.float32) for _ in range(4)]


def _against_plain(kernel, causal, scale, got, arrs, dtype="bfloat16"):
    """{tensor: agreement} of (out, lse, dq, dk, dv) with the port's f32
    plain version on the same 16-bit inputs."""
    ref = (k1.flash_attention_reference if kernel == "k1"
           else k2.packed_flash_reference)
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    qr, kr, vr = (t.requires_grad_(True) for t in ts[:3])
    ro, rlse = ref(qr, kr, vr, causal, scale, return_lse=True)
    want = (ro, rlse, *torch.autograd.grad(ro, (qr, kr, vr), ts[3]))
    return {n: agreement(g, w.detach()) for n, g, w in zip(
        ("out", "lse", "dq", "dk", "dv"), got, want)}


def _bf16_readings(kernel, causal, dtype="bfloat16"):
    """The Pallas reference kernel against the port's f32 plain version
    on bf16 (or `dtype`) inputs at [1, 2, 256, 128] (K2: each row one
    packed pair of heads of 64)."""
    arrs = _bf16_inputs()
    jq, jk, jv, jdo = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    scale = 1.0 / math.sqrt(128 if kernel == "k1" else 64)
    with pltpu.force_tpu_interpret_mode():
        if kernel == "k1":
            def fn(a, b, c):
                return _fa_core(a, b, c, causal, scale)
            _, res = _fa_fwd(jq, jk, jv, causal, scale)
            lse = res[7] + jnp.log(res[6])             # m + log(l)
        else:
            def fn(a, b, c):
                return jpf.packed_flash_attention(a, b, c, causal, scale)
            _, lse = jpf._fwd_call(jq, jk, jv, causal, scale, with_lse=True)
        out, vjp = jax.vjp(fn, jq, jk, jv)
        grads = vjp(jdo)
    got = [torch.from_numpy(np.array(g.astype(jnp.float32)))
           for g in (out, lse, *grads)]
    return _against_plain(kernel, causal, scale, got, arrs, dtype)


def _emulated_readings(kernel, causal, dtype="bfloat16"):
    """chip_smoke.reference_rounding (the reference's rounding points in
    plain PyTorch) on the same inputs, against the same plain version."""
    import chip_smoke
    arrs = _bf16_inputs()
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    scale = 1.0 / math.sqrt(128 if kernel == "k1" else 64)
    if kernel == "k1":
        got = chip_smoke.reference_rounding(*ts, causal, scale)
    else:
        out, lse, dq, dk, dv = chip_smoke.reference_rounding(
            *(k2._unpack(t) for t in ts), causal, scale)
        got = (k2._repack(out), lse.reshape(1, 2, 2, 256), k2._repack(dq),
               k2._repack(dk), k2._repack(dv))
    return _against_plain(kernel, causal, scale, got, arrs, dtype)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_limits_derive_from_reference_kernels(kernel, causal):
    """Each bf16 limit of chip_smoke.FLASH_TOL holds the Pallas reference
    kernel's own reading; reference_rounding, which gives the readings at
    the chip check's shape, reproduces the Pallas readings here (relative
    L2 within 25 %, the excess, a maximum and noisier, within 2x; lse
    aside: reference_rounding keeps the plain f32 lse). Where a chip
    check runs this kernel under this mask (k1 and k2 causal at the GPT
    step's shape; K2 non-causal at ERNIE-large's, the k2_nc entry), that
    entry's limits hold the Pallas reading too, and each is at least its
    chip reading and at most FLASH_REF_MARGIN <= 2 times it, or the limit
    it had before (k2_nc: the floor of the others), and the pinned Pallas
    reading is this one."""
    import chip_smoke
    assert chip_smoke.FLASH_REF_MARGIN <= 2
    pallas = _bf16_readings(kernel, causal)
    emulated = _emulated_readings(kernel, causal)
    for name, limits in chip_smoke.FLASH_TOL["bfloat16"][kernel].items():
        for metric, limit in limits.items():
            got = pallas[name][metric]
            assert got <= limit, (name, metric, got, limit)
            if name != "lse":
                ratio = emulated[name][metric] / got
                lo, hi = (0.8, 1.25) if metric == "l2" else (0.5, 2.0)
                assert lo <= ratio <= hi, (name, metric, ratio)
    entry = kernel if causal else {"k2": "k2_nc"}.get(kernel)
    if entry is None:
        return
    assert chip_smoke.FLASH[entry]["causal"] == causal
    for name, limits in chip_smoke.FLASH_TOL["bfloat16"][entry].items():
        for metric, limit in limits.items():
            got = pallas[name][metric]
            assert got <= limit, (entry, name, metric, got, limit)
            floor = chip_smoke._BF16_FLOOR[name][metric]
            chip = chip_smoke.FLASH_REF_READINGS[entry][name][metric]
            assert limit >= floor, (entry, name, metric)
            assert chip <= limit, (entry, name, metric, chip, limit)
            assert (limit <= chip_smoke.FLASH_REF_MARGIN * chip
                    or limit == floor), (entry, name, metric, chip, limit)
            pinned = chip_smoke.FLASH_PALLAS_READINGS[entry][name][metric]
            assert got == pytest.approx(pinned, rel=0.05, abs=1e-9), \
                (entry, name, metric, got, pinned)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("causal", [True, False])
def test_f16_limits_hold_reference_kernels(kernel, causal):
    """The float16 limits of chip_smoke.FLASH_TOL (the bf16 limits over
    F16_ROUNDOFF_RATIO, the ratio of bf16's and f16's unit roundoffs;
    lse's kept) hold the Pallas reference kernel's own float16 reading,
    and reference_rounding in float16, which phase 7 holds to them at
    the chip check's shape, reproduces it (relative L2 within 25 %; the
    excess, a maximum, only under the limit)."""
    import chip_smoke
    assert chip_smoke.F16_ROUNDOFF_RATIO == 2 ** (10 - 7)   # mantissa bits
    pallas = _bf16_readings(kernel, causal, "float16")
    emulated = _emulated_readings(kernel, causal, "float16")
    entries = [kernel] if causal else {"k2": ["k2_nc"]}.get(kernel, [])
    for entry in entries or [kernel]:
        bf16 = chip_smoke.FLASH_TOL["bfloat16"][entry]
        for name, limits in chip_smoke.FLASH_TOL["float16"][entry].items():
            for metric, limit in limits.items():
                ratio = 1 if name == "lse" else chip_smoke.F16_ROUNDOFF_RATIO
                assert limit == bf16[name][metric] / ratio
                assert pallas[name][metric] <= limit, \
                    (entry, name, metric, pallas[name][metric], limit)
                assert emulated[name][metric] <= limit, \
                    (entry, name, metric, emulated[name][metric], limit)
            if name != "lse":
                r = emulated[name]["l2"] / pallas[name]["l2"]
                assert 0.8 <= r <= 1.25, (name, r)
