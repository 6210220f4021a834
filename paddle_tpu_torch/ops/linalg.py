"""Linear algebra (port of paddle_tpu/ops/linalg.py), every public name in
the reference's order and under the JAX package's op types ("matmul_v2",
"bmm", "mv", "einsum" and "addmm" are on the AMP white list).

`mm`, `dot`, `mv`, `addmm`, `einsum` and `tensordot` are torch's GEMM
calls (the JAX package also computes them outside any Pallas kernel);
the decompositions and solves are torch.linalg's (LAPACK on the CPU,
cuSOLVER on CUDA). The JAX package's conventions hold:
- `norm` with an axis pair: p=2 (and None, "fro") is the Frobenius
  norm, not the spectral one, and p=1 the vector-style sum over both
  axes; the p-norms follow the JAX package's formula, gradient included;
- `slogdet` returns one stacked [2, ...] tensor (sign, log|det|);
- `svd` returns V, not V^H; `lstsq` solves through the SVD, as jnp does,
  on both devices (torch's CUDA driver has no rank or singular values),
  and returns (solution, ||y - x @ solution||^2 per column, rank,
  singular values);
- `histogram` with min == max == 0 takes the data's range and counts in
  int64; `bincount`'s length is max(x) + 1, which torch learns from the
  device (the JAX package reads it on the host).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import eager, op
from ..core.tensor import wrap


def _pair(x, y):
    """x and y as tensors of their promoted dtype (jnp promotes mixed
    operands; torch.linalg refuses them)."""
    x = wrap(x, y)
    y = wrap(y, x)
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


@op("matmul_v2")
def _matmul(x, y, transpose_x, transpose_y):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = _pair(x, y)
    return _matmul(x, y, transpose_x, transpose_y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


@op("bmm")
def _bmm(x, y):
    return torch.bmm(x, y)


def bmm(x, y, name=None):
    x, y = _pair(x, y)
    return _bmm(x, y)


@op("dot")
def _dot(x, y):
    return torch.sum(x * y, -1)


def dot(x, y, name=None):
    x, y = _pair(x, y)
    return _dot(x, y)


@op("mv")
def _mv(x, vec):
    return torch.matmul(x, vec)


def mv(x, vec, name=None):
    x, vec = _pair(x, vec)
    return _mv(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    x = wrap(x, y)
    return _addmm(wrap(input, x), x, wrap(y, x), beta, alpha)


@op("addmm")
def _addmm(inp, x, y, beta, alpha):
    return beta * inp + alpha * torch.matmul(x, y)


def einsum(equation, *operands):
    like = next((o for o in operands if torch.is_tensor(o)), None)
    return _einsum(equation, [wrap(o, like) for o in operands])


@op("einsum")
def _einsum(equation, operands):
    return torch.einsum(equation, *operands)


@op("tensordot")
def _tensordot(x, y, axes):
    return torch.tensordot(x, y, dims=axes)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    x = wrap(x, y)
    return _tensordot(x, wrap(y, x), axes)


@op("p_norm")
def _p_norm(x, p, axis, keepdim):
    dims = tuple(range(x.ndim)) if axis is None else axis
    if p == np.inf:
        return torch.amax(torch.abs(x), dims, keepdim)
    if p == -np.inf:
        return torch.amin(torch.abs(x), dims, keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dims, keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dims, keepdim),
                     1.0 / p)


@op("frobenius_norm")
def _fro_norm(x, axis, keepdim):
    dims = tuple(range(x.ndim)) if axis is None else axis
    return torch.sqrt(torch.sum(torch.square(x), dims, keepdim))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The JAX package's norm: over an axis pair, p in (None, "fro", 2)
    is the Frobenius norm and p=1 sums |x| over both axes; otherwise
    the vector p-norm over axis (every axis when None)."""
    x = wrap(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
        if p in (None, "fro", 2):
            return _fro_norm(x, axis, keepdim)
        return _p_norm(x, p, axis, keepdim)
    axis = None if axis is None else int(axis)
    if p is None or p == "fro":
        return _fro_norm(x, axis, keepdim)
    return _p_norm(x, float(p), axis, keepdim)


def dist(x, y, p=2, name=None):
    x = wrap(x, y)
    return norm(x - wrap(y, x), p=p)


@op("cross")
def _cross(x, y, axis):
    return torch.linalg.cross(x, y, dim=axis)


def cross(x, y, axis=None, name=None):
    x = wrap(x, y)
    y = wrap(y, x)
    if axis is None:  # paddle default: first axis of size 3
        axis = next((i for i, s in enumerate(x.shape) if s == 3), None)
        if axis is None:
            raise ValueError(
                "paddle.cross: no dimension of size 3 found and no axis "
                f"given (input shape {list(x.shape)})")
    return _cross(x, y, axis)


@op("cholesky")
def _cholesky(x, upper):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky(x, upper=False, name=None):
    return _cholesky(wrap(x), upper)


@op("cholesky_solve")
def _cholesky_solve(x, y, upper):
    return torch.cholesky_solve(x, y, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """The solution z of A z = x, where y is A's Cholesky factor (upper
    or lower)."""
    x, y = _pair(x, y)
    return _cholesky_solve(x, y, upper)


@op("inverse")
def _inverse(x):
    return torch.linalg.inv(x)


def inverse(x, name=None):
    return _inverse(wrap(x))


@op("pinv")
def _pinv(x, rcond):
    return torch.linalg.pinv(x, rtol=rcond)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """Pseudo-inverse; singular values below rcond times the largest are
    dropped. hermitian is accepted and ignored, as in the JAX package."""
    return _pinv(wrap(x), rcond)


@op("det")
def _det(x):
    return torch.linalg.det(x)


def det(x, name=None):
    return _det(wrap(x))


@op("slogdet")
def _slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


def slogdet(x, name=None):
    return _slogdet(wrap(x))


@op("matrix_rank", differentiable=False)
def _matrix_rank(x, tol, hermitian):
    if tol is None:
        return torch.linalg.matrix_rank(x)
    return torch.linalg.matrix_rank(x, rtol=tol)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The number of singular values above tol (relative to the largest,
    as jnp reads it) or above the default max(m, n) * eps."""
    if torch.is_tensor(tol):
        tol = float(tol.item())
    return _matrix_rank(wrap(x), tol, hermitian)


@op("matrix_power")
def _matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


def matrix_power(x, n, name=None):
    return _matrix_power(wrap(x), n)


@op("svd")
def _svd(x, full_matrices):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


def svd(x, full_matrices=False, name=None):
    """(U, S, V) with x = U diag(S) V^T (Paddle returns V, not V^T)."""
    return _svd(wrap(x), full_matrices)


@op("qr")
def _qr(x, mode):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def qr(x, mode="reduced", name=None):
    return _qr(wrap(x), mode)


@op("eig", differentiable=False)
def _eig(x):
    return torch.linalg.eig(x)


def eig(x, name=None):
    return tuple(_eig(wrap(x)))


@op("eigh")
def _eigh(x, UPLO):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def eigh(x, UPLO="L", name=None):
    return _eigh(wrap(x), UPLO)


def eigvals(x, name=None):
    return _eig(wrap(x))[0]


def eigvalsh(x, UPLO="L", name=None):
    return _eigh(wrap(x), UPLO)[0]


@op("solve")
def _solve(x, y):
    return torch.linalg.solve(x, y)


def solve(x, y, name=None):
    x, y = _pair(x, y)
    return _solve(x, y)


@op("triangular_solve")
def _triangular_solve(x, y, upper, transpose, unitriangular):
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """The solution z of op(x) z = y, op transposing x when asked, x
    upper or lower triangular (with a unit diagonal when unitriangular)."""
    x, y = _pair(x, y)
    return _triangular_solve(x, y, upper, transpose, unitriangular)


@eager
def _lstsq(x, y, rcond):
    m, n = x.shape[-2], x.shape[-1]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * max(m, n)
    keep = s > rcond * s.amax(-1, keepdim=True)
    inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    vec = y.ndim == x.ndim - 1
    b = y.unsqueeze(-1) if vec else y
    sol = vh.transpose(-1, -2) @ (inv.unsqueeze(-1) * (
        u.transpose(-1, -2) @ b))
    resid = torch.sum(torch.square(b - x @ sol), -2)
    if vec:
        sol, resid = sol.squeeze(-1), resid.squeeze(-1)
    return sol, resid, keep.sum(-1), s


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, squared residual per column, rank, singular values) of
    min ||x z - y|| through x's SVD. driver is accepted and ignored, as
    in the JAX package."""
    x, y = _pair(x, y)
    return _lstsq(x, y, rcond)


@op("multi_dot")
def _multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


def multi_dot(x, name=None):
    xs = list(x)
    like = next((v for v in xs if torch.is_tensor(v)), None)
    return _multi_dot([wrap(v, like) for v in xs])


@op("histogram", differentiable=False)
def _histogram(x, bins, min, max):  # noqa: A002
    x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    return torch.histc(x, bins, min, max).to(torch.int64)


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """int64 counts of `bins` equal bins over [min, max] (the data's
    range when both are 0); the last bin is closed."""
    return _histogram(wrap(input), int(bins), float(min), float(max))


@op("bincount", differentiable=False)
def _bincount(x, weights, minlength):
    out = torch.bincount(x, weights, minlength)
    return out if weights is None else out.to(weights.dtype)


def bincount(x, weights=None, minlength=0, name=None):
    x = wrap(x)
    w = None if weights is None else wrap(weights, x)
    return _bincount(x, w, minlength)


@op("corrcoef")
def _corrcoef(x, rowvar):
    return torch.corrcoef(x if rowvar or x.ndim < 2 else x.T)


def corrcoef(x, rowvar=True, name=None):
    return _corrcoef(wrap(x), rowvar)


@op("cov")
def _cov(x, rowvar, ddof, fweights, aweights):
    return torch.cov(x if rowvar or x.ndim < 2 else x.T, correction=ddof,
                     fweights=fweights, aweights=aweights)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = wrap(x)
    fw = None if fweights is None else wrap(fweights, x)
    aw = None if aweights is None else wrap(aweights, x)
    return _cov(x, rowvar, 1 if ddof else 0, fw, aw)


__all__ = ["matmul", "mm", "bmm", "dot", "mv", "addmm", "einsum",
           "tensordot", "norm", "dist", "cross", "cholesky",
           "cholesky_solve", "inverse", "pinv", "det", "slogdet",
           "matrix_rank", "matrix_power", "svd", "qr", "eig", "eigh",
           "eigvals", "eigvalsh", "solve", "triangular_solve", "lstsq",
           "multi_dot", "histogram", "bincount", "corrcoef", "cov"]
