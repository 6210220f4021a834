"""K4's tile rule and ring size (ops/kernels/fused_conv `k4_tile`,
`k4_ring`) as plain functions of the shapes, on the CPU.

The kernel (csrc/fused_conv.cu) takes its output tile width and grid
from the wrapper and sizes its ring of shared-memory stages itself; the
wrapper's `k4_ring` mirrors that arithmetic, and the first test holds
the mirrored constants to the source. At ResNet-50's five block
boundaries and at the shapes of the CUDA tests the rule must pick a
width of 64, 128 or 256, a grid of at most one CTA per SM, and a ring of
at least 2 stages whose bytes, with the staging buffers, scale and
shift, fit in a block's 232,448 bytes of shared memory.
"""
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_conv as k4
from paddle_tpu_torch.ops.kernels.fused_conv import (
    K4_BLOCK_NS, fused_scale_relu_matmul, fused_scale_relu_matmul_reference,
    k4_ring, k4_tile)
from paddle_tpu_torch.tools.fused_conv_proto import BATCH, GEOMETRIES

_CU = (Path(k4.__file__).resolve().parent / "csrc" / "fused_conv.cu")

# (m, k, n, residual) at ResNet-50's block boundaries, batch 128
BOUNDARIES = [(BATCH * hw, cin, cout, res)
              for _, hw, cin, cout, res in GEOMETRIES]
# the shapes tests/test_torch_cuda.py gives the kernel
CUDA_TEST_SHAPES = [
    (1, 16, 16, True), (97, 64, 256, False), (300, 48, 80, True),
    (512, 256, 128, True), (6272, 2048, 512, True), (1000, 64, 256, False),
    (300, 16, 16, True), (300, 48, 80, False), (1000, 80, 320, True),
    (257, 128, 320, False), (20000, 192, 256, True), (40000, 512, 128, True),
    (97, 48, 16, True), (640, 1024, 512, True), (300, 80, 80, True)]
# SM counts: the H100 SXM and PCIe parts, and a small card
SMS = (132, 114, 16)


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", _CU.read_text())
    assert m, name
    return int(m.group(1))


def test_mirrored_constants_match_the_source():
    assert _constant("kBM") == k4.K4_BM
    assert _constant("kBK") == k4.K4_BK
    assert _constant("kMaxStages") == k4.K4_MAX_STAGES
    assert _constant("kSmemLimit") == k4.K4_SMEM_LIMIT
    assert _constant("kSlack") == k4.K4_SLACK


def _holds(m, k, n, res, sms):
    block_n, grid = k4_tile(m, k, n, sms, res)
    stages, nbytes = k4_ring(k, block_n, res)
    tiles = -(-m // 128) * -(-n // block_n)
    assert block_n in K4_BLOCK_NS
    assert 1 <= grid <= sms and grid == min(tiles, sms)
    assert 2 <= stages <= k4.K4_MAX_STAGES
    assert nbytes <= k4.K4_SMEM_LIMIT
    return block_n, grid, stages


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,k,n,res", BOUNDARIES)
def test_rule_at_the_block_boundaries(m, k, n, res, sms):
    _holds(m, k, n, res, sms)


@pytest.mark.parametrize("m,k,n,res", CUDA_TEST_SHAPES)
def test_rule_at_the_cuda_test_shapes(m, k, n, res):
    _holds(m, k, n, res, 132)


def test_rule_on_the_h100_at_the_block_boundaries():
    got = [_holds(m, k, n, res, 132) for m, k, n, res in BOUNDARIES]
    # layer1..layer4 then bn2: (block_n, grid, stages)
    assert got == [(64, 132, 5), (128, 132, 3), (128, 132, 3),
                   (128, 132, 3), (256, 132, 3)]


def test_rule_narrows_for_fewer_tiles_than_sms():
    # 98 tiles at 256 columns for 132 SMs: 196 at 128
    assert k4_tile(6272, 2048, 512, 132) == (128, 132)
    # with few SMs the widest tile stays (no residual: 3 stages fit)
    assert k4_tile(6272, 2048, 512, 64, False) == (256, 64)
    assert k4_tile(300, 64, 256, 132) == (64, 12)


def test_rule_narrows_for_a_shallow_ring():
    # 256 columns hold 2 stages at K 1024 with a residual, 3 without
    assert k4_ring(1024, 256, True)[0] == 2
    assert k4_tile(25088, 1024, 256, 132, True)[0] == 128
    assert k4_ring(1024, 256, False)[0] == 3
    assert k4_tile(25088, 1024, 256, 132, False)[0] == 256


@pytest.mark.parametrize("block_n", K4_BLOCK_NS)
@pytest.mark.parametrize("res", [True, False])
@pytest.mark.parametrize("k", [16, 48, 64, 80, 1024, 2048, 4096])
def test_ring_is_as_deep_as_fits(block_n, res, k):
    stages, nbytes = k4_ring(k, block_n, res)
    stage = 128 * 64 * 2 * (2 if res else 1) + 64 * block_n * 2
    if stages >= 2:
        assert nbytes <= k4.K4_SMEM_LIMIT
    assert stages == k4.K4_MAX_STAGES or nbytes + stage > k4.K4_SMEM_LIMIT


def test_rule_refuses_a_k_whose_ring_cannot_fit():
    assert k4_ring(32768, 64, True)[0] < 2
    with pytest.raises(ValueError):
        k4_tile(16, 32768, 64, 132)


def test_override_is_checked_and_the_cpu_runs_the_plain_version():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 48, generator=g).to(torch.bfloat16)
    w = (torch.randn(48, 80, generator=g) / 7).to(torch.bfloat16)
    scale = torch.rand(48, generator=g) + 0.5
    shift = torch.randn(48, generator=g) * 0.1
    want = fused_scale_relu_matmul_reference(x, None, w, scale, shift)
    for block_n in K4_BLOCK_NS:
        got = fused_scale_relu_matmul(x, None, w, scale, shift,
                                      block_n=block_n)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        fused_scale_relu_matmul(x, None, w, scale, shift, block_n=96)
