"""gather_tree, hierarchical_sigmoid and sigmoid_focal_loss (port of the
parts of paddle_tpu/ops/extra_ops.py that nn/decode.py and
nn.functional's hsigmoid_loss and sigmoid_focal_loss reach), under the
JAX package's op types.

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

from ..core.dispatch import op

__all__ = ["gather_tree", "hierarchical_sigmoid", "sigmoid_focal_loss"]


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
