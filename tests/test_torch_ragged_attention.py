"""Kernel K3 of the port: ragged paged attention
(paddle_tpu_torch/ops/kernels/ragged_paged_attention.py).

On the CPU the plain PyTorch version is held against the JAX package's
`ragged_attention_reference` (its Pallas kernel cannot trace on this
jax, so the reference is the JAX side) and against a dense numpy oracle.
Tolerance 1e-5 absolute in float32: both sides run the same streaming-
softmax update, but their dot products sum in different orders, which
moves outputs of magnitude ~1 by a few ulps.

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
    ragged_attention_reference, ragged_decode_attention)

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
