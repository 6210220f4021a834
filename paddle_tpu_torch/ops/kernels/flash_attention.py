"""Flash attention, forward and backward (kernel K1 of the port).

Exact softmax(scale * q k^T, optional top-left causal mask) v over
heads-major q/k/v [B, H, T, D], never materialising the [T, S] scores on
the card. The forward also writes each row's logsumexp (f32 [B, H, Tq]);
the backward takes it, with the forward's output, and gives dq, dk and
dv in the inputs' dtype.

Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
`_fa_core:176` / `_fa_fwd:186` / `_fa_bwd:203` (jax's upstream Pallas
TPU flash kernel, public entry `flash_attention:243`) with the
hand-written CUDA kernels of csrc/flash_attention.cu: in bf16,
warp-specialised Hopper kernels (TMA rings in shared memory feeding
wgmma, P and dS rounded to bf16 where the TPU kernels round them); in
f32, SIMT kernels. Its header says what bounds them and what the design
still leaves. The same source, at head dim 64 on the packed-pair
layout, is kernel K2 (packed_flash.py).

`flash_attention_reference` is the plain PyTorch version: composed f32
softmax attention with masked scores at -1e30 (the JAX package's `_sdpa`
convention), differentiable by autograd. The wrappers run it for tensors
on the CPU; for CUDA tensors they launch the kernels or raise, never
falling back. `flash_attention_fwd.launches` and
`flash_attention_bwd.launches` count the calls that launched the
forward and the backward kernels.

Scope (`supported`): Tq and Tk multiples of 128, head dim 64 or 128 (the
kernel's instances; the TPU kernel also took other multiples of 8 >= 32,
which the port routes to composed attention), f32 or bf16.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_reference", "supported"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128         # the bf16 kernels' q/kv tile rows (f32's divide it)


def supported(q_seq: int, kv_seq: int, head_dim: int) -> bool:
    """K1's scope, the route gate of nn.functional.attention."""
    return q_seq % 128 == 0 and kv_seq % 128 == 0 and head_dim in HEAD_DIMS


# ------------------------------------------------------------- plain twin
def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """Plain version over heads-major [B, H, T, D]: f32 scores and
    softmax, output in q's dtype; with return_lse also the f32 row
    logsumexp [B, H, Tq]. Differentiable."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if causal:
        t, n = s.shape[-2], s.shape[-1]
        keep = torch.ones(t, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    out = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, dim=-1),
                       v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _reference_bwd(q, k, v, do, causal, scale,
                   reference=flash_attention_reference):
    """(dq, dk, dv) through the autograd of a plain version."""
    with torch.enable_grad():
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = reference(qr, kr, vr, causal, scale)
        return torch.autograd.grad(out, (qr, kr, vr), do)


# ----------------------------------------------------------- the kernels
def _layout(t: torch.Tensor, hsplit: int) -> Tuple[int, ...]:
    """(sb, sh, shalf, st, hsplit) of a [B, X, T, W] tensor; hsplit 2
    addresses head h of the packed layout at (pair h // 2, lanes
    (h % 2) * W/2 ...)."""
    half = t.shape[-1] // 2 if hsplit == 2 else 0
    return (t.stride(0), t.stride(1), half, t.stride(2), hsplit)


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """The kernels move 16 bytes at a time (the f32 ones per thread, the
    bf16 ones through TMA tensor maps): d contiguous, every other stride a
    multiple of 8 elements, base 16-byte aligned. A tensor that is not so
    (a gradient arriving with odd strides) is copied into a contiguous
    one; the kernel runs either way."""
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _check(tensors: Sequence[torch.Tensor], head_dim: int) -> None:
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}; the kernel takes CUDA "
                         f"tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    for t in tensors[1:]:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"dtypes {t.dtype} and {q.dtype} differ")
    if q.ndim != 4 or any(t.ndim != 4 for t in tensors):
        raise ValueError("expected 4-D [B, H, T, D] tensors")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim}: the kernel is built for "
                         f"{HEAD_DIMS}")


def _dims(q, k, hsplit):
    B, X, Tq, W = q.shape
    Tk = k.shape[2]
    if Tq % _TILE or Tk % _TILE:
        raise ValueError(f"sequence lengths {Tq}, {Tk}: the kernel takes "
                         f"multiples of {_TILE}")
    if k.shape[0] != B or k.shape[1] != X or k.shape[3] != W:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ")
    return B, X * hsplit, Tq, Tk, W // hsplit


def launch_fwd(q, k, v, causal: bool, scale: float, hsplit: int = 1):
    """Run the forward kernel: (o with q's strides, lse f32 [B, H, Tq]),
    H counting packed heads separately when hsplit is 2."""
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    B, H, Tq, Tk, D = _dims(q, k, hsplit)
    _check((q, k, v), D)
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    o = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                            device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lay = (ctypes.c_longlong * 20)(*_layout(q, hsplit), *_layout(k, hsplit),
                                   *_layout(v, hsplit), *_layout(o, hsplit))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            _DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), lay, B, H, Tq, Tk, float(scale),
            int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention forward launch failed: "
                           f"{_error(err)}")
    return o, lse


def launch_bwd(q, k, v, o, lse, do, causal: bool, scale: float,
               hsplit: int = 1):
    """Run the backward kernels (delta, dq, dk/dv): (dq, dk, dv) with
    q's, k's and v's strides and dtype."""
    q, k, v, o, do = (_kernel_ready(t) for t in (q, k, v, o, do))
    B, H, Tq, Tk, D = _dims(q, k, hsplit)
    _check((q, k, v, o, do), D)
    if lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.numel() != B * H * Tq:
        raise ValueError("lse must be contiguous f32 with B*H*Tq entries")
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                      device=t.device) for t in (q, k, v))
    lay = (ctypes.c_longlong * 25)(
        *_layout(q, hsplit), *_layout(k, hsplit), *_layout(v, hsplit),
        *_layout(o, hsplit), *_layout(do, hsplit))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            _DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lay, B, H, Tq, Tk,
            float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"{_error(err)}")
    return dq, dk, dv


def _error(err: int) -> str:
    return {-2: "cuTensorMapEncodeTiled is unavailable",
            -3: "an operand's TMA tensor map was refused"}.get(
                err, f"cudaError {err}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Forward over heads-major [B, H, T, D]: (out, lse f32 [B, H, Tq]).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q, k, v):
        with torch.no_grad():
            return flash_attention_reference(q, k, v, causal, scale,
                                             return_lse=True)
    out = launch_fwd(q, k, v, causal, scale)
    flash_attention_fwd.launches += 1
    return out


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        scale: Optional[float] = None):
    """Backward from the forward's out and lse: (dq, dk, dv). CPU
    tensors recompute through the plain version's autograd; CUDA tensors
    launch the kernels."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q, k, v, o, lse, do):
        return _reference_bwd(q, k, v, do, causal, scale)
    out = launch_bwd(q, k, v, o, lse, do, causal, scale)
    flash_attention_bwd.launches += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashFn(torch.autograd.Function):
    """Forward and backward through a pair of wrappers: K1's
    (flash_attention_fwd/bwd) or K2's (packed_flash.packed_flash_fwd/bwd),
    which keep their own launch counts."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, fwd, bwd):
        o, lse = fwd(q, k, v, causal, scale)
        ctx.causal, ctx.scale, ctx.bwd = causal, scale, bwd
        if any(ctx.needs_input_grad[:3]):
            # residuals only when a gradient will be asked for (the
            # primal JAX forward keeps none)
            ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    heads_major: bool = False):
    """Differentiable flash attention. q/k/v are heads-major
    [B, H, T, D] (the output stays so), or Paddle's [B, T, H, D] with
    heads_major=False (a strided view: the kernel reads it in place).
    CPU tensors run the plain version with autograd; CUDA tensors launch
    the kernels."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not heads_major:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if _on_cpu(q, k, v):
        out = flash_attention_reference(q, k, v, causal, scale)
    else:
        out = _FlashFn.apply(q, k, v, causal, scale, flash_attention_fwd,
                             flash_attention_bwd)
    return out if heads_major else out.transpose(1, 2)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [i, i, p, p, p, p, p, p, i, i, i,
                                            i, f, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_bwd.argtypes = [i, i, p, p, p, p, p, p, p, p, p,
                                            p, p, i, i, i, i, f, i, p]
        lib.flash_attention_bwd.restype = i
    return lib
