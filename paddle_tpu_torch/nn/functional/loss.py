"""Loss functionals (port of paddle_tpu/nn/functional/loss.py), under
the JAX package's op types (the cross-entropies, bce, nll, kl_div,
mse and l1 are on the AMP black list, so they run in float32 under
auto_cast, as in the reference).

`_HardCE` is the hard-label cross-entropy core (`_hard_ce_core`,
loss.py:31-132) as a torch.autograd.Function: per row,
logsumexp(logits) minus the label's logit, in f32; its backward is one
softmax-minus-onehot pass. Neither direction holds a whole f32 [N, V]
tensor: at the GPT bench's 32 x 1024 tokens over a 32768 vocabulary
that tensor would be 4 GiB beside 2 GiB of bf16 logits, so both run
over chunks of rows. This is not a TPU kernel (XLA fused it in the JAX
package), so it stays plain torch. Both directions run inside a
`cross_entropy` profiler range, so a torch.profiler trace of the train
step can sum their device time (tools/train_bench.py --profile).

cross_entropy and softmax_with_cross_entropy take the fused core for
hard labels over the last axis without class weights, as the JAX
package does; soft labels, class weights and another class axis take
the composed log_softmax path in the logits' dtype (float32 under
auto_cast, whose black list holds these ops). use_softmax=False reads
the input as probabilities (their log, floored at 1e-30).

ctc_loss runs the JAX package's log-space alpha recursion as a torch
loop over time steps (applying log_softmax to its input, as the JAX
package does); hsigmoid_loss builds the default tree's paths on the
host from the labels (ops/extra_ops.py `hierarchical_sigmoid`).
"""
from __future__ import annotations

import torch

from ...core.dispatch import op

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits",
           "sigmoid_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "square_error_cost", "log_loss", "ctc_loss", "dice_loss",
           "npair_loss", "hsigmoid_loss"]

# f32 elements of one chunk (256 MiB)
_CHUNK_ELEMS = 1 << 26
NEG_INF = -1e30


def _rows_per_chunk(v: int) -> int:
    return max(1, _CHUNK_ELEMS // max(v, 1))


def _acc_dtype(logits):
    return torch.float64 if logits.dtype == torch.float64 else torch.float32


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


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


def _mean_valid(nll, valid):
    cnt = valid.sum().to(nll.dtype).clamp(min=1.0)
    return nll.sum() / cnt


def _gather_nll(logp, label, axis):
    """-logp at the hard labels along `axis` (label [...] or [..., 1]
    with the class axis kept), and the label without its class axis."""
    lab = label
    if lab.ndim == logp.ndim:
        lab = lab.squeeze(axis)
    lab = lab.long()
    safe = torch.where(lab < 0, torch.zeros_like(lab), lab)
    nll = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    return nll, lab


def _weighted(nll, lab, valid, weight, reduction):
    w = weight[torch.where(valid, lab, torch.zeros_like(lab))]
    w = torch.where(valid, w, torch.zeros_like(w))
    if reduction == "mean":
        return (nll * w).sum() / torch.clamp(w.sum(), min=1e-12)
    return _reduce(nll * w, reduction)


@op("softmax_with_cross_entropy")
def _softmax_ce(logits, label, soft_label, ignore_index, axis, weight,
                reduction):
    ax = axis % logits.ndim
    if not soft_label and weight is None and ax == logits.ndim - 1:
        nll, valid = _hard_nll(logits, label, ignore_index)
        if reduction == "mean":
            return _mean_valid(nll, valid)
        return _reduce(nll, reduction)
    logp = torch.log_softmax(logits, dim=ax)
    if soft_label:
        per = -(label * logp).sum(dim=ax)
        if weight is not None:
            shape = [1] * logits.ndim
            shape[ax] = -1
            per = per * (label * weight.reshape(shape)).sum(dim=ax)
        return _reduce(per, reduction)
    nll, lab = _gather_nll(logp, label, ax)
    valid = lab != ignore_index
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if weight is not None:
        return _weighted(nll, lab, valid, weight, reduction)
    if reduction == "mean":
        return _mean_valid(nll, valid)
    return _reduce(nll, reduction)


@op("cross_entropy_probs")
def _ce_probs(probs, label, soft_label, ignore_index, axis, reduction):
    logp = torch.log(torch.clamp(probs, min=1e-30))
    ax = axis % logp.ndim
    if soft_label:
        return _reduce(-(label * logp).sum(dim=ax), reduction)
    nll, lab = _gather_nll(logp, label, ax)
    valid = lab != ignore_index
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "mean":
        return _mean_valid(nll, valid)
    return _reduce(nll, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross-entropy. Hard labels ([N] or [N, 1] ints): "mean"
    averages over the rows whose label is not ignore_index (at least
    one), or with class `weight` divides the weighted sum by the summed
    weights of those rows; "sum" sums, "none" returns them (ignored rows
    0). Soft labels: the per-row -sum(label * log_softmax), each row
    scaled by sum(label * weight) when weight is given. use_softmax=False
    takes probabilities (class weights are not applied there, as in the
    reference)."""
    if not use_softmax:
        return _ce_probs(input, label, soft_label, ignore_index, axis,
                         reduction)
    return _softmax_ce(input, label, soft_label, ignore_index, axis, weight,
                       reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row loss with the class axis kept (size 1); ignored rows 0.
    With return_softmax, also the softmax of the logits. The loss is
    always the stable form, as in the reference, whatever
    numeric_stable_mode says."""
    loss = _softmax_ce_keep(logits, label, soft_label, ignore_index, axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


@op("softmax_with_cross_entropy_keepdim")
def _softmax_ce_keep(logits, label, soft_label, ignore_index, axis):
    ax = axis % logits.ndim
    if not soft_label and ax == logits.ndim - 1:
        nll, _ = _hard_nll(logits, label, ignore_index)
        return nll[..., None]
    logp = torch.log_softmax(logits, dim=ax)
    if soft_label:
        return -(label * logp).sum(dim=ax, keepdim=True)
    nll, lab = _gather_nll(logp, label, ax)
    valid = lab != ignore_index
    return torch.where(valid, nll, torch.zeros_like(nll)).unsqueeze(ax)


@op("nll_loss")
def _nll_loss(x, label, weight, ignore_index, reduction):
    nll, lab = _gather_nll(x, label, 1)
    valid = lab != ignore_index
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if weight is not None:
        return _weighted(nll, lab, valid, weight, reduction)
    if reduction == "mean":
        return _mean_valid(nll, valid)
    return _reduce(nll, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities [N, C, ...] at the
    labels [N, ...]."""
    return _nll_loss(input, label, weight, ignore_index, reduction)


@op("mse_loss")
def _mse(x, y, reduction):
    return _reduce((x - y).square(), reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _mse(input, label, reduction)


@op("l1_loss")
def _l1(x, y, reduction):
    return _reduce((x - y).abs(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _l1(input, label, reduction)


@op("smooth_l1_loss")
def _smooth_l1(x, y, delta, reduction):
    d = x - y
    ad = d.abs()
    loss = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return _smooth_l1(input, label, delta, reduction)


@op("bce_loss")
def _bce(x, label, weight, reduction):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(x, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - x, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    return _bce(input, label, weight, reduction)


@op("bce_with_logits")
def _bce_logits(logit, label, weight, pos_weight, reduction):
    # stable: max(x, 0) - x z + log(1 + exp(-|x|))
    base = torch.clamp(logit, min=0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))
    if pos_weight is not None:
        base = base * ((pos_weight - 1) * label + 1)
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    return _bce_logits(logit, label, weight, pos_weight, reduction)


@op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(x, label, ignore_index, normalize):
    loss = torch.clamp(x, min=0) - x * label \
        + torch.log1p(torch.exp(-x.abs()))
    valid = label != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if normalize:
        loss = loss / torch.clamp(valid.sum().to(loss.dtype), min=1.0)
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    return _sigmoid_ce(x, label, ignore_index, normalize)


@op("kl_div")
def _kl_div(x, target, reduction):
    loss = target * (torch.log(torch.clamp(target, min=1e-12)) - x)
    if reduction == "batchmean":
        return loss.sum() / x.shape[0]
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """label * (log(label) - input), input being log-probabilities."""
    return _kl_div(input, label, reduction)


@op("margin_ranking_loss")
def _margin_ranking(x, y, label, margin, reduction):
    return _reduce(torch.clamp(-label * (x - y) + margin, min=0.0),
                   reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _margin_ranking(input, other, label, margin, reduction)


@op("hinge_embedding_loss")
def _hinge_embedding(x, label, margin, reduction):
    loss = torch.where(label == 1, x, torch.clamp(margin - x, min=0.0))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _hinge_embedding(input, label, margin, reduction)


@op("cosine_embedding_loss")
def _cosine_embedding(x1, x2, label, margin, reduction):
    cos = (x1 * x2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(x1, dim=-1)
        * torch.linalg.vector_norm(x2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    return _cosine_embedding(input1, input2, label, margin, reduction)


@op("triplet_margin_loss")
def _triplet(anchor, pos, neg, margin, p, eps, swap, reduction):
    def dist(a, b):
        return ((a - b).abs() + eps).pow(p).sum(-1).pow(1.0 / p)
    d_pos = dist(anchor, pos)
    d_neg = dist(anchor, neg)
    if swap:
        d_neg = torch.minimum(d_neg, dist(pos, neg))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    return _triplet(input, positive, negative, margin, p, epsilon, swap,
                    reduction)


def square_error_cost(input, label):
    """(input - label)^2, elementwise."""
    d = input - label
    return d * d


@op("log_loss")
def _log_loss(x, label, epsilon):
    return -label * torch.log(x + epsilon) \
        - (1 - label) * torch.log(1 - x + epsilon)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _log_loss(input, label, epsilon)


@op("ctc_loss")
def _ctc(log_probs, labels, input_lengths, label_lengths, blank):
    """Per-sample CTC negative log-likelihood; log_probs [T, B, C]
    (log-softmaxed), labels [B, L] padded."""
    T, B, _ = log_probs.shape
    S = 2 * labels.shape[1] + 1
    labels = labels.long()
    # extended label sequence: blank, l1, blank, l2, ..., blank
    ext = torch.full((B, S), blank, dtype=torch.long,
                     device=log_probs.device)
    ext[:, 1::2] = labels
    neg = torch.full((B, 1), NEG_INF, dtype=log_probs.dtype,
                     device=log_probs.device)
    alpha = torch.full((B, S), NEG_INF, dtype=log_probs.dtype,
                       device=log_probs.device)
    alpha0 = torch.cat([log_probs[0, :, blank][:, None],
                        log_probs[0].gather(1, ext[:, 1:2]),
                        alpha[:, 2:]], dim=1)
    same_as_prev2 = torch.cat(
        [torch.ones(B, 2, dtype=torch.bool, device=ext.device),
         ext[:, 2:] == ext[:, :-2]], dim=1)
    alphas = [alpha0]
    a = alpha0
    for t in range(1, T):
        s1 = torch.cat([neg, a[:, :-1]], dim=1)
        s2 = torch.cat([neg, neg, a[:, :-2]], dim=1)
        s2 = torch.where(same_as_prev2, torch.full_like(s2, NEG_INF), s2)
        merged = torch.logaddexp(torch.logaddexp(a, s1), s2)
        a = merged + log_probs[t].gather(1, ext)
        alphas.append(a)
    alphas = torch.stack(alphas, dim=0)                   # [T, B, S]
    t_idx = torch.clamp(input_lengths.long() - 1, 0, T - 1)
    last = alphas[t_idx, torch.arange(B, device=alphas.device)]
    s_last = 2 * label_lengths.long()
    ll_blank = last.gather(1, s_last[:, None])[:, 0]
    ll_lab = last.gather(1, torch.clamp(s_last - 1, min=0)[:, None])[:, 0]
    return -torch.logaddexp(ll_blank, ll_lab)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over log_probs [T, B, C] (log_softmax is applied to them
    first, as the JAX package does), labels [B, L]; "mean" averages the
    per-sample loss over the label lengths. norm_by_times is accepted
    and ignored, as in the JAX package."""
    from .activation import log_softmax
    out = _ctc(log_softmax(log_probs, axis=-1), labels, input_lengths,
               label_lengths, blank)
    if reduction == "mean":
        return (out / label_lengths.to(out.dtype)).mean()
    if reduction == "sum":
        return out.sum()
    return out


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - 2 |x . onehot(label)| / (|x| + |onehot|) over the non-batch
    axes, averaged over the batch."""
    from .common import one_hot
    lab = label.squeeze(-1) if label.shape[-1] == 1 else label
    lab = one_hot(lab, input.shape[-1]).to(input.dtype)
    axes = list(range(1, input.ndim))
    inse = torch.sum(input * lab, dim=axes)
    denom = torch.sum(input, dim=axes) + torch.sum(lab, dim=axes)
    return (1.0 - 2.0 * inse / (denom + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """0.25 l2_reg times the embeddings' mean squared norms, plus the
    soft-label cross-entropy of anchor @ positive^T against the rows of
    label equality, normalised."""
    bs = labels.shape[0]
    lab = labels.reshape(bs, 1).to(torch.float32)
    eq = (lab == lab.t()).to(torch.float32)
    targets = eq / torch.sum(eq, dim=1, keepdim=True)
    l2 = (torch.sum(anchor * anchor, dim=1).mean()
          + torch.sum(positive * positive, dim=1).mean()) * 0.25 * l2_reg
    sim = anchor @ positive.t()
    ce = softmax_with_cross_entropy(sim, targets, soft_label=True)
    return l2 + torch.sum(targets * ce, dim=0).mean()


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree of
    num_classes, or a custom tree (path_table, path_code). is_sparse is
    a gradient-storage hint, accepted and ignored, as in the JAX
    package."""
    from ...ops.extra_ops import hierarchical_sigmoid
    return hierarchical_sigmoid(input, weight, label, path_table=path_table,
                                path_code=path_code, bias=bias,
                                num_classes=num_classes)
