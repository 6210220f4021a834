"""gather_tree, hierarchical_sigmoid, sigmoid_focal_loss and py_func
(port of the parts of paddle_tpu/ops/extra_ops.py that nn/decode.py,
nn.functional's hsigmoid_loss and sigmoid_focal_loss, and paddle.static
reach), under the JAX package's op types.

py_func runs a Python callable on the inputs' host copies and returns
its result on their device; in a static program it is one recorded op
whose output shape and dtype come from out_template.

sigmoid_focal_loss is RetinaNet's element-wise alpha_t * (1 - p_t) **
gamma * CE(sigmoid(x), label) / normalizer, unreduced, as in the JAX
package.

gather_tree back-tracks beam-search parent pointers from the last step
to the first (a loop over time steps where the JAX package scans).
hierarchical_sigmoid takes a custom tree as (path_table, path_code), or
builds the default complete binary tree over num_classes from the
labels on the host, as the JAX package does (node (id + C) / 2^(d+1) -
1, code ((id + C) >> d) & 1)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import _OP_REGISTRY, get_op, op

__all__ = ["gather_tree", "hierarchical_sigmoid", "sigmoid_focal_loss",
           "register_legacy_aliases", "py_func"]


@op("gather_tree", differentiable=False)
def _gather_tree(ids, parents):
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device,
                         dtype=ids.dtype).expand(ids.shape[1:])
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        b = beams.long()
        toks[t] = ids[t].gather(1, b)
        beams = parents[t].gather(1, b)
    return torch.stack(toks, dim=0)


def gather_tree(ids, parents):
    """ids, parents [T, B, beam] -> the full token sequence of each final
    beam, [T, B, beam]."""
    return _gather_tree(ids, parents)


@op("hierarchical_sigmoid")
def _hsigmoid(x, w, label, path_table, path_code, bias):
    valid = path_table >= 0
    safe = torch.clamp(path_table, min=0).long()
    logit = torch.einsum("bd,bld->bl", x, w[safe])
    if bias is not None:
        logit = logit + bias[safe]
    # P(code) = sigmoid(+-logit): cost = softplus(logit) - code * logit
    cost = torch.logaddexp(logit, torch.zeros_like(logit)) \
        - path_code * logit
    return torch.where(valid, cost, torch.zeros_like(cost)).sum(
        dim=-1, keepdim=True)


def _default_paths(label, num_classes):
    C = int(num_classes)
    L = max(1, int(math.ceil(math.log2(max(C, 2)))))
    ids = label.detach().cpu().numpy().reshape(-1).astype(np.int64) + C
    tbl = np.full((len(ids), L), -1, np.int64)
    code = np.zeros((len(ids), L), np.float32)
    for b, v in enumerate(ids):
        d = 0
        while (v >> (d + 1)) > 1:
            tbl[b, d] = (v >> (d + 1)) - 1
            code[b, d] = float((v >> d) & 1)
            d += 1
        tbl[b, d] = (v >> (d + 1)) - 1
        code[b, d] = float((v >> d) & 1)
    return (torch.from_numpy(tbl).to(label.device),
            torch.from_numpy(code).to(label.device))


def hierarchical_sigmoid(input, weight, label, path_table=None,
                         path_code=None, bias=None, num_classes=None,
                         name=None):
    """Per-sample binary-tree softmax cost [B, 1]: the sum over the
    label's path of softplus(logit) - code * logit, logit = x . w[node]
    (+ bias[node]); path entries of -1 are padding."""
    if path_table is None:
        path_table, path_code = _default_paths(label, num_classes)
    return _hsigmoid(input, weight, label, path_table, path_code, bias)


@op("sigmoid_focal_loss")
def _sigmoid_focal_loss(x, label, normalizer, gamma, alpha):
    p = torch.sigmoid(x)
    ce = torch.logaddexp(x, torch.zeros_like(x)) - x * label
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    return a_t * ((1 - p_t) ** gamma) * ce / normalizer


def sigmoid_focal_loss(x, label, normalizer=1.0, alpha=0.25, gamma=2.0,
                       name=None):
    nrm = normalizer if torch.is_tensor(normalizer) else float(normalizer)
    return _sigmoid_focal_loss(x, label.to(x.dtype), nrm, float(gamma),
                               float(alpha))


def _py_call(func, xs, out_template):
    """func on host copies of xs, its result on their device (on meta
    inputs, during a static capture, out_template's shape and dtype)."""
    if xs and xs[0].device.type == "meta":
        if out_template is None:
            raise ValueError("py_func in a static program needs "
                             "out_template (an example output)")
        tmpl = out_template if torch.is_tensor(out_template) else \
            torch.as_tensor(np.asarray(out_template))
        return torch.empty(tuple(tmpl.shape), dtype=tmpl.dtype,
                           device="meta")
    host = []
    for t in xs:
        t = t.detach()
        host.append((t.float() if t.dtype == torch.bfloat16 else t)
                    .cpu().numpy())
    out = torch.as_tensor(np.asarray(func(*host)))
    return out.to(xs[0].device) if xs else out


def py_func(func, x, out_template=None, name=None):
    """reference: operators/py_func_op.cc: an arbitrary Python callable
    as an op (on host copies of the inputs); on static Variables, one
    recorded "py_func" op that calls it at every run."""
    from ..core.tensor import box, plain
    from ..static.program import _record, _var_of
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if any(_var_of(t) is not None for t in xs):
        return _record("py_func", _py_call, (func, xs, out_template), {},
                       differentiable=False)
    return box(_py_call(func, [plain(t) for t in xs], out_template))


# ----------------------------------------------------------------- aliases
def _alias(new_name, existing_name):
    """Register a legacy op name whose kernel is the same computation as
    an already-registered v2 op (the reference keeps both generations
    registered, e.g. reshape/reshape2, top_k/top_k_v2)."""
    fn = get_op(existing_name)
    if fn is not None and new_name not in _OP_REGISTRY:
        _OP_REGISTRY[new_name] = fn


# the JAX package's list (paddle_tpu/ops/extra_ops.py _ALIASES)
_ALIASES = [
    ("matmul", "matmul_v2"), ("reshape2", "reshape"),
    ("transpose2", "transpose"), ("squeeze2", "squeeze"),
    ("unsqueeze2", "unsqueeze"), ("flatten2", "flatten"),
    ("flatten_contiguous_range", "flatten"), ("top_k", "top_k_v2"),
    ("expand_v2", "expand"), ("expand_as_v2", "expand"),
    ("lookup_table", "lookup_table_v2"), ("mean", "reduce_mean"),
    ("sum", "add_n"), ("reverse", "flip"), ("tril_triu", "tril"),
    ("one_hot", "one_hot_v2"), ("kldiv_loss", "kl_div"),
    ("lrn", "local_response_norm"), ("warpctc", "ctc_loss"),
    ("margin_rank_loss", "margin_ranking_loss"),
    ("cross_entropy", "softmax_with_cross_entropy"),
    ("cross_entropy2", "softmax_with_cross_entropy"), ("norm", "p_norm"),
    ("pad", "pad_nd"), ("pad2d", "pad_nd"), ("pad3d", "pad_nd"),
    ("fill_any_like", "ones_like"), ("depthwise_conv2d", "conv2d"),
    ("depthwise_conv2d_transpose", "conv2d_transpose"),
    ("max_pool2d_with_index", "pool_max"),
    ("max_pool3d_with_index", "pool_max"), ("cudnn_lstm", "rnn_scan_lstm"),
    ("rnn", "rnn_scan_simple"), ("gru", "rnn_scan_gru"),
    ("lstm", "rnn_scan_lstm"), ("crf_decoding", "viterbi_decode"),
    ("conv3d", "conv2d"), ("conv3d_transpose", "conv2d_transpose"),
    ("bilinear_interp_v2", "interpolate"),
    ("nearest_interp_v2", "interpolate"),
    ("bicubic_interp_v2", "interpolate"),
    ("trilinear_interp_v2", "interpolate"),
    ("linear_interp_v2", "interpolate"), ("bilinear_interp", "interpolate"),
    ("nearest_interp", "interpolate"), ("bicubic_interp", "interpolate"),
    ("trilinear_interp", "interpolate"), ("linear_interp", "interpolate"),
]


def register_legacy_aliases():
    """Called from paddle_tpu_torch/__init__.py after nn.functional has
    registered its ops; aliases whose target the port has not ported
    are skipped."""
    for new, old in _ALIASES:
        _alias(new, old)
