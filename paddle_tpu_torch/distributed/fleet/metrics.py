"""fleet.metrics: distributed evaluation metrics (port of
paddle_tpu/distributed/fleet/metrics.py; reference:
python/paddle/distributed/fleet/metrics/metric.py).

Every trainer holds local statistics (correct counts, error sums, AUC
threshold histograms); these helpers all-reduce them over the process
group (paddle.distributed.all_reduce: gloo for CPU ranks, NCCL on the
card, where the statistics ride a CUDA tensor) and compute the global
metric, which equals one process's evaluation over the union of the
data. With no process group initialised they are the identity.

These are evaluation metrics only; system metrics (throughput, latency,
counters) live in paddle_tpu_torch.obs.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sum", "max", "min", "acc", "mae", "mse", "rmse", "auc"]


def _device() -> torch.device:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and \
            dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allreduce(arr, op="sum"):
    from .. import collective as C
    t = torch.from_numpy(np.array(arr)).to(_device())
    red = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
           "min": C.ReduceOp.MIN}[op]
    C.all_reduce(t, op=red)
    return t.cpu().numpy()


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sum(input, scope=None, util=None):
    """reference: metric.py sum: the global sum of a local statistic."""
    return _allreduce(_np(input), "sum")


def max(input, scope=None, util=None):
    return _allreduce(_np(input), "max")


def min(input, scope=None, util=None):
    return _allreduce(_np(input), "min")


def _ratio(num, den):
    # one all-reduce for the (numerator, denominator) pair
    s = _allreduce(np.asarray([float(num), float(den)], np.float64), "sum")
    return float(s[0]) / float(s[1]) if s[1] else 0.0


def acc(correct, total, scope=None, util=None):
    """reference: metric.py acc: global accuracy from the local
    (correct, total) counts."""
    return _ratio(_np(correct).sum(), _np(total).sum())


def mae(abserr, total_ins_num, scope=None, util=None):
    """reference: metric.py mae: global mean absolute error from the
    local |err| sum and instance count."""
    return _ratio(_np(abserr).sum(), _np(total_ins_num).sum())


def mse(sqrerr, total_ins_num, scope=None, util=None):
    return _ratio(_np(sqrerr).sum(), _np(total_ins_num).sum())


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return float(np.sqrt(mse(sqrerr, total_ins_num)))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """reference: metric.py auc: global AUC from the trainers' threshold
    histograms (positive / negative counts per score bucket, the layout
    paddle.metric.Auc accumulates), by the trapezoid rule from the
    highest bucket down."""
    pos = _allreduce(_np(stat_pos).astype(np.float64), "sum").reshape(-1)
    neg = _allreduce(_np(stat_neg).astype(np.float64), "sum").reshape(-1)
    tot_pos = pos.sum()
    tot_neg = neg.sum()
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    area = 0.0
    tp = fp = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_tp = tp + pos[i]
        new_fp = fp + neg[i]
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    return float(area / (tot_pos * tot_neg))
