"""K4, the fused BN-apply + ReLU (+ residual) -> 1x1-conv matmul
(paddle_tpu_torch/ops/kernels/fused_conv.py), against the Pallas kernel
of tools/fused_conv_proto.py run in interpret mode on the CPU
(`jax.experimental.pallas.tpu.force_tpu_interpret_mode()`), with no edit
to the JAX side. The tool is loaded by path (tools/ is not a package).

Tolerance: the port's plain version and the Pallas kernel compute the
same f32 transform, round it once to bf16, and sum the products in f32
in different orders before rounding the result to bf16; so each output
element may differ by one bf16 ulp of the Pallas value, and no more.
The shapes are ResNet-50-like block boundaries cut in M: [512, 256] ->
128 with a residual, [256, 64] -> 256 without, and [98, 512] -> 128 with
a residual (M not a multiple of the TPU tile, so the tool halves its
row block).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.ops.kernels.fused_conv import (
    fused_scale_relu_matmul, fused_scale_relu_matmul_reference)

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "fused_conv_proto.py"


@pytest.fixture(scope="module")
def proto():
    spec = importlib.util.spec_from_file_location("fused_conv_proto", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(m, k, n, res, seed=0):
    """The tool's recipe: x, z ~ N(0, 1), w ~ N(0, 1/K), scale in
    [0.5, 1.5), shift ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    z = rng.randn(m, k).astype(np.float32) if res else None
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    scale = (rng.rand(k) + 0.5).astype(np.float32)
    shift = (rng.randn(k) * 0.1).astype(np.float32)
    return x, z, w, scale, shift


def _torch(x, z, w, scale, shift):
    bf = [None if a is None else torch.from_numpy(a).to(torch.bfloat16)
          for a in (x, z, w)]
    return (*bf, torch.from_numpy(scale), torch.from_numpy(shift))


def _bf16_ulp(v):
    """One bf16 ulp of each element of v (8 significant bits)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("m,k,n,res", [(512, 256, 128, True),
                                       (256, 64, 256, False),
                                       (98, 512, 128, True)])
def test_plain_matches_pallas_interpret(proto, m, k, n, res):
    x, z, w, scale, shift = _inputs(m, k, n, res)
    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa
    with pltpu.force_tpu_interpret_mode():
        want = proto.fused_scale_relu_matmul(bf(x), bf(z), bf(w),
                                             jnp.asarray(scale),
                                             jnp.asarray(shift))
    want = np.asarray(want.astype(jnp.float32))
    before = fused_scale_relu_matmul.launches
    got = fused_scale_relu_matmul(*_torch(x, z, w, scale, shift))
    assert fused_scale_relu_matmul.launches == before   # CPU: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= _bf16_ulp(want)), err.max()
    # the composed path of the tool (xla_ref) is the same function
    ref = np.asarray(proto.xla_ref(bf(x), bf(z), bf(w), jnp.asarray(scale),
                                   jnp.asarray(shift)).astype(jnp.float32))
    assert np.all(np.abs(got.float().numpy() - ref) <= _bf16_ulp(ref))


def test_cpu_wrapper_is_the_plain_version():
    args = _torch(*_inputs(64, 32, 48, True, seed=1))
    torch.testing.assert_close(fused_scale_relu_matmul(*args),
                               fused_scale_relu_matmul_reference(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["k", "n", "z", "dtype", "scale"])
def test_shapes_k4_cannot_take_raise(case):
    x, z, w, scale, shift = _torch(*_inputs(32, 64, 64, True, seed=2))
    if case == "k":            # K not a multiple of 16
        x, z, w = x[:, :40].contiguous(), z[:, :40].contiguous(), w[:40]
        scale, shift = scale[:40], shift[:40]
    elif case == "n":          # N not a multiple of 16
        w = w[:, :24].contiguous()
    elif case == "z":
        z = z[:16]
    elif case == "dtype":
        x = x.float()
    else:
        scale = scale.bfloat16()
    with pytest.raises((ValueError, TypeError)):
        fused_scale_relu_matmul(x, z, w, scale, shift)
