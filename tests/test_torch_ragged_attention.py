"""Kernel K3 of the port: ragged paged attention
(paddle_tpu_torch/ops/kernels/ragged_paged_attention.py).

On the CPU the plain PyTorch versions are held against the JAX
package's `ragged_attention_reference` (its Pallas kernel cannot trace
on this jax, so the reference is the JAX side) and against a dense numpy
oracle: `ragged_attention_reference` (one streaming pass over the block
axis) and `ragged_attention_split_reference` (the kernel's order: the
block axis cut into splits, each streamed from a fresh state, the
partials merged in split order) at split sizes 1, 2, 3 and past the
table. Tolerance 1e-5 absolute in float32: the versions run the same
softmax, but their dot products and the split merge sum in different
orders, which moves outputs of magnitude ~1 by a few ulps. Dead rows and
rows with no live block are exact zeros in every version.

The CUDA kernel itself is held against the plain version on the card
by tests/test_torch_cuda.py.
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.ops.pallas.ragged_paged_attention import (
    ragged_attention_reference as jax_reference)
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    default_blocks_per_split, ragged_attention_reference,
    ragged_attention_split_reference, ragged_decode_attention)

TOL = 1e-5


def _case(name, seed=0):
    """(q, k_pool, v_pool, tables, lengths) as numpy, N rows over a pool
    of NB blocks of bs positions, H heads of D dims."""
    rng = np.random.RandomState(seed)
    N, H, D, NB, bs, MB = 5, 3, 16, 24, 4, 4
    q = rng.randn(N, H, D).astype(np.float32)
    kp = rng.randn(NB, bs, H, D).astype(np.float32)
    vp = rng.randn(NB, bs, H, D).astype(np.float32)
    tables = rng.permutation(NB)[:N * MB].reshape(N, MB).astype(np.int32)
    if name == "mixed":
        # dead row, one-token row, mid row, near-capacity row, full row
        lengths = np.array([0, 1, 6, MB * bs - 1, MB * bs], np.int32)
    elif name == "padding":
        # -1 padding past each row's live blocks (never read)
        lengths = np.array([3, 5, 9, 1, 13], np.int32)
        for i, n in enumerate(lengths):
            tables[i, -(-n // bs):] = -1
    elif name == "out_of_range":
        # entries outside [0, NB) INSIDE the length skip their block
        lengths = np.array([8, 16, 7, 12, 4], np.int32)
        tables[0, 1] = NB
        tables[1, 0] = -3
        tables[1, 2] = NB + 5
        tables[4, 0] = -1                  # the only live block: zeros
    elif name == "skipped_split":
        # blocks 0-1 of rows 0 and 1 skipped: with 2 blocks a split, the
        # first split of each is all skipped; row 1's only live split is
        # that one (length 8), row 2 is dead
        lengths = np.array([16, 8, 0, 9, 15], np.int32)
        tables[0, :2] = [NB, -2]
        tables[1, :2] = [-1, NB + 1]
    elif name == "edges":
        # lengths on block edges (4, 8, 12) and one past or short of them
        lengths = np.array([4, 8, 12, 5, 7], np.int32)
    else:
        raise ValueError(name)
    return q, kp, vp, tables, lengths


def _dense_oracle(q, kp, vp, tables, lengths, scale=None):
    """Plain softmax over each row's live positions in float64."""
    N, H, D = q.shape
    NB, bs = kp.shape[:2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = np.zeros((N, H, D))
    for i in range(N):
        ks, vs = [], []
        for s in range(int(lengths[i])):
            b = int(tables[i, s // bs])
            if 0 <= b < NB:
                ks.append(kp[b, s % bs])
                vs.append(vp[b, s % bs])
        if not ks:
            continue
        k = np.stack(ks).astype(np.float64)            # [S, H, D]
        v = np.stack(vs).astype(np.float64)
        sc = np.einsum("hd,shd->hs", q[i].astype(np.float64), k) * scale
        p = np.exp(sc - sc.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        out[i] = np.einsum("hs,shd->hd", p, v)
    return out


@pytest.mark.parametrize("name", ["mixed", "padding", "out_of_range"])
def test_plain_matches_jax_reference_and_dense_oracle(name):
    args = _case(name)
    got = ragged_attention_reference(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jax_reference(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _dense_oracle(*args), rtol=0, atol=TOL)


def test_dead_and_fully_skipped_rows_are_exact_zeros():
    args = _case("out_of_range")
    got = ragged_attention_reference(*map(torch.from_numpy, args)).numpy()
    assert np.all(got[4] == 0.0)
    args = _case("mixed")
    got = ragged_attention_reference(*map(torch.from_numpy, args)).numpy()
    assert np.all(got[0] == 0.0)


def test_explicit_scale_matches_jax():
    args = _case("mixed", seed=3)
    got = ragged_attention_reference(*map(torch.from_numpy, args),
                                     scale=0.3).numpy()
    want = np.asarray(jax_reference(*map(jnp.asarray, args), scale=0.3))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _dense_oracle(*args, scale=0.3),
                               rtol=0, atol=TOL)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    args = tuple(map(torch.from_numpy, _case("padding")))
    before = ragged_decode_attention.launches
    got = ragged_decode_attention(*args)
    assert ragged_decode_attention.launches == before
    torch.testing.assert_close(got, ragged_attention_reference(*args),
                               rtol=0, atol=0)


def test_wrapper_raises_off_cpu_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises —
    the meta device stands in for a non-CPU device here."""
    q, kp, vp, tables, lengths = map(torch.from_numpy, _case("mixed"))
    with pytest.raises(ValueError, match="CUDA"):
        ragged_decode_attention(q.to("meta"), kp, vp, tables, lengths)


def test_build_library_is_keyed_by_sources():
    path = _build.library_path("ragged_paged_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libragged_paged_attention-")
    assert path == _build.library_path("ragged_paged_attention")
    assert "ragged_paged_attention" in _build.KERNELS
    assert (_build.CSRC / "ragged_paged_attention.cu").is_file()


SPLIT_CASES = ["mixed", "padding", "out_of_range", "skipped_split", "edges"]


@pytest.mark.parametrize("bps", [1, 2, 3, 5])
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_plain_matches_jax_reference(name, bps):
    """The split-and-merge version at split sizes 1, 2, 3 and one larger
    than the 4-column table (a single split)."""
    args = _case(name)
    got = ragged_attention_split_reference(*map(torch.from_numpy, args),
                                           bps).numpy()
    want = np.asarray(jax_reference(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _dense_oracle(*args), rtol=0, atol=TOL)
    for row in np.nonzero(_dense_oracle(*args).reshape(5, -1).any(1) == 0)[0]:
        assert np.all(got[row] == 0.0), row


@pytest.mark.parametrize("bps", [1, 2, 3])
def test_split_plain_zero_rows_exact(bps):
    """Dead rows, and rows whose every live split is all skipped blocks,
    are exact zeros."""
    got = ragged_attention_split_reference(
        *map(torch.from_numpy, _case("skipped_split")), bps).numpy()
    assert np.all(got[2] == 0.0)                       # dead row
    if bps <= 2:                                       # split 0 only
        assert np.all(got[1] == 0.0)
    got = ragged_attention_split_reference(
        *map(torch.from_numpy, _case("out_of_range")), bps).numpy()
    assert np.all(got[4] == 0.0)


@pytest.mark.parametrize("length", [31, 32, 33, 63, 64, 65, 95, 96, 97])
def test_split_plain_on_split_edges(length):
    """One row at lengths around the 2-block (64-position) split edges
    of 32-position blocks, against the JAX reference."""
    rng = np.random.RandomState(length)
    H, D, NB, bs, MB = 2, 8, 16, 32, 4
    q = rng.randn(1, H, D).astype(np.float32)
    kp = rng.randn(NB, bs, H, D).astype(np.float32)
    vp = rng.randn(NB, bs, H, D).astype(np.float32)
    tables = rng.permutation(NB)[:MB].reshape(1, MB).astype(np.int32)
    lengths = np.array([length], np.int32)
    args = (q, kp, vp, tables, lengths)
    got = ragged_attention_split_reference(*map(torch.from_numpy, args),
                                           2).numpy()
    want = np.asarray(jax_reference(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_split_plain_explicit_scale_and_bf16():
    args = _case("mixed", seed=5)
    t = list(map(torch.from_numpy, args))
    got = ragged_attention_split_reference(*t, 1, scale=0.3).numpy()
    want = np.asarray(jax_reference(*map(jnp.asarray, args), scale=0.3))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    low = [x.bfloat16() for x in t[:3]] + t[3:]
    got = ragged_attention_split_reference(*low, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               ragged_attention_reference(*low).float(),
                               rtol=0, atol=1e-2)


@pytest.mark.parametrize("sms", [132, 78, 16])
def test_default_split_size_fills_the_card_from_shapes_alone(sms):
    """Rows at full length give at most 4 CTAs per SM, with as many as
    fit; on the H100's 132 SMs the serving shape (8 rows, 6 heads, 32
    columns) takes 3 blocks a split, 11 splits."""
    if sms == 132:
        assert default_blocks_per_split(8, 6, 32, sms) == 3
        assert default_blocks_per_split(1, 1, 32, sms) == 1
        assert default_blocks_per_split(64, 32, 8, sms) == 8
    target = 4 * sms
    for n, h, mb in [(8, 6, 32), (3, 2, 40), (1, 1, 1), (16, 12, 64)]:
        bps = default_blocks_per_split(n, h, mb, sms)
        splits = -(-mb // bps)
        assert 1 <= bps <= mb and splits <= 128
        assert n * h * splits <= max(target, n * h)
        assert bps == 1 or n * h * -(-mb // (bps - 1)) > target \
            or -(-mb // (bps - 1)) > 128


def test_wrapper_on_cpu_ignores_split_size():
    args = tuple(map(torch.from_numpy, _case("mixed")))
    got = ragged_decode_attention(*args, blocks_per_split=1)
    torch.testing.assert_close(got, ragged_attention_reference(*args),
                               rtol=0, atol=0)
