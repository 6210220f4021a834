"""Metrics (port of paddle_tpu/metric/metrics.py, after the reference's
python/paddle/metric/metrics.py).

The same host-side arithmetic as the JAX module: every metric reads its
inputs to host numpy (one device-to-host read per tensor it is given;
hapi's train and eval loops make those reads each batch, as in JAX) and
accumulates in Python and numpy. `accuracy` and `Accuracy.compute`
return CPU Tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import box


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:       # numpy has no bfloat16
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """reference: operators/metrics/accuracy_op.cc."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    topk = np.argsort(-pred, axis=-1)[..., :k].reshape(len(lab), k)
    hit = (topk == lab[:, None]).any(axis=1)
    return box(torch.from_numpy(np.asarray(hit.mean(), dtype=np.float32)))


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)
        if l.ndim == p.ndim and l.shape[-1] != 1:
            l = l.argmax(-1)  # one-hot to index
        l = l.reshape(-1)
        topk = np.argsort(-p.reshape(len(l), -1), axis=-1)[:, :self.maxk]
        correct = (topk == l[:, None])
        return box(torch.from_numpy(correct.astype(np.float32)))

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0]
        accs = []
        for k in self.topk:
            hit = c[:, :k].sum()
            self.total[self.topk.index(k)] += hit
            self.count[self.topk.index(k)] += num
            accs.append(hit / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).reshape(-1).astype(int)
        l = _np(labels).reshape(-1).astype(int)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).reshape(-1).astype(int)
        l = _np(labels).reshape(-1).astype(int)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via threshold buckets (reference: metrics.py Auc /
    operators/metrics/auc_op.cc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        l = _np(labels).reshape(-1)
        buckets = np.minimum(
            (p * self._num_thresholds).astype(int), self._num_thresholds)
        for b, lab in zip(buckets, l):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1)
        self._stat_neg = np.zeros(self._num_thresholds + 1)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name
