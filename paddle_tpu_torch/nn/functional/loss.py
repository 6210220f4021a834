"""Hard-label cross-entropy (port of paddle_tpu/nn/functional/loss.py
`cross_entropy` and `softmax_with_cross_entropy`, the fused hard-label
path, loss.py:31-132).

`_HardCE` is `_hard_ce_core` as a torch.autograd.Function: per row,
logsumexp(logits) minus the label's logit, in f32; its backward is one
softmax-minus-onehot pass. Neither direction holds a whole f32 [N, V]
tensor: at the GPT bench's 32 x 1024 tokens over a 32768 vocabulary
that tensor would be 4 GiB beside 2 GiB of bf16 logits, so both run
over chunks of rows. This is not a TPU kernel (XLA fused it in the JAX
package), so it stays plain torch.

Both directions run inside a `cross_entropy` profiler range, so a
torch.profiler trace of the train step can sum their device time
(tools/train_bench.py --profile); with no profiler active the range
costs a few microseconds per call.

Only the hard-label path over the last axis is ported: no soft labels,
class weights or use_softmax=False.
"""
from __future__ import annotations

import torch

from ...core.unported import require_defaults

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]

# f32 elements of one chunk (256 MiB)
_CHUNK_ELEMS = 1 << 26


def _rows_per_chunk(v: int) -> int:
    return max(1, _CHUNK_ELEMS // max(v, 1))


def _acc_dtype(logits):
    return torch.float64 if logits.dtype == torch.float64 else torch.float32


class _HardCE(torch.autograd.Function):
    """logits [N, V], lab [N] int64 in [0, V) -> per-row nll [N] in f32
    (f64 for f64 logits)."""

    @staticmethod
    def forward(ctx, logits, lab):
        with torch.profiler.record_function("cross_entropy"):
            return _HardCE._forward(ctx, logits, lab)

    @staticmethod
    def _forward(ctx, logits, lab):
        n, v = logits.shape
        acc = _acc_dtype(logits)
        lse = torch.empty(n, dtype=acc, device=logits.device)
        step = _rows_per_chunk(v)
        for s in range(0, n, step):
            x = logits[s:s + step].to(acc)
            m = x.amax(dim=-1)
            lse[s:s + step] = m + torch.log(
                torch.exp(x - m[:, None]).sum(dim=-1))
        label_logit = logits.gather(1, lab[:, None])[:, 0].to(acc)
        ctx.save_for_backward(logits, lab, lse)
        return lse - label_logit

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("cross_entropy"):
            return _HardCE._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        logits, lab, lse = ctx.saved_tensors
        n, v = logits.shape
        dx = torch.empty_like(logits)
        step = _rows_per_chunk(v)
        rows = torch.arange(n, device=logits.device)
        for s in range(0, n, step):
            e = min(s + step, n)
            p = torch.exp(logits[s:e].to(lse.dtype) - lse[s:e, None])
            p[rows[:e - s], lab[s:e]] -= 1.0
            dx[s:e] = p * g[s:e, None].to(lse.dtype)
        return dx, None


def _hard_nll(logits, label, ignore_index):
    """Per-row nll over the last axis with ignored rows zeroed, and the
    valid-row mask."""
    lab = label
    if lab.ndim == logits.ndim:
        lab = lab.squeeze(-1)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    v = logits.shape[-1]
    nll = _HardCE.apply(logits.reshape(-1, v), safe.reshape(-1))
    nll = nll.reshape(lab.shape)
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def _negative(axis: int, x) -> int:
    """axis counted from the end (the last axis is -1)."""
    return axis - x.ndim if axis >= 0 else axis


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross-entropy with hard labels ([N] or [N, 1] ints). "mean"
    averages over the rows whose label is not ignore_index (at least
    one), "sum" sums them, "none" returns them (ignored rows 0). The
    reference's class weights, soft labels, use_softmax=False and
    classes on another axis than the last are not ported yet."""
    require_defaults("cross_entropy", weight=(weight, None),
                     soft_label=(soft_label, False),
                     axis=(_negative(axis, input), -1),
                     use_softmax=(use_softmax, True))
    nll, valid = _hard_nll(input, label, ignore_index)
    if reduction == "mean":
        cnt = valid.sum().to(nll.dtype).clamp(min=1.0)
        return nll.sum() / cnt
    if reduction == "sum":
        return nll.sum()
    return nll


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row loss with the class axis kept ([..., 1]); ignored rows 0.
    With return_softmax, also the softmax of the logits. The loss is
    always the stable form, as in the reference, whatever
    numeric_stable_mode says. Soft labels and another class axis than
    the last are not ported yet."""
    require_defaults("softmax_with_cross_entropy",
                     soft_label=(soft_label, False),
                     axis=(_negative(axis, logits), -1))
    nll, _ = _hard_nll(logits, label, ignore_index)
    loss = nll[..., None]
    if return_softmax:
        return loss, torch.softmax(logits, dim=-1)
    return loss
