"""Fleet distributed metrics — the port's copy of
`paddle_tpu/distributed/fleet/metrics/__init__.py`.

Reference parity: python/paddle/distributed/fleet/metrics/metric.py —
global sum/max/min/auc/acc aggregated across trainers. One trainer
reduces with the identity; several (`PADDLE_TRAINERS_NUM` > 1) need the
host collectives, which are not ported yet (ROADMAP Queue 1 item 7), and
raise."""
import os

import numpy as np
import torch


def _all_reduce(arr, op='sum'):
    nproc = int(os.environ.get('PADDLE_TRAINERS_NUM', '1') or '1')
    if nproc <= 1:
        return np.asarray(arr, np.float64)
    raise NotImplementedError(
        f'fleet.metrics over {nproc} trainers needs the host collectives '
        '(ROADMAP Queue 1 item 7); one trainer reduces with the identity')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sum(input, scope=None, util=None):            # noqa: A001
    """Parity: fleet.metrics.sum — global sum across trainers."""
    return float(_all_reduce(_np(input).sum(), 'sum'))


def max(input, scope=None, util=None):            # noqa: A001
    return float(_all_reduce(_np(input).max(), 'max'))


def min(input, scope=None, util=None):            # noqa: A001
    return float(_all_reduce(_np(input).min(), 'min'))


def acc(correct, total, scope=None, util=None):
    """Parity: fleet.metrics.acc — global accuracy."""
    c = _all_reduce(_np(correct).sum(), 'sum')
    t = _all_reduce(_np(total).sum(), 'sum')
    return float(c) / float(np.maximum(t, 1e-12))


def mae(abserr, total_ins_num, scope=None, util=None):
    e = _all_reduce(_np(abserr).sum(), 'sum')
    n = _all_reduce(np.asarray(float(np.asarray(total_ins_num).sum()
                    if not np.isscalar(total_ins_num)
                    else total_ins_num)), 'sum')
    return float(e) / float(np.maximum(n, 1e-12))


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    e = _all_reduce(_np(sqrerr).sum(), 'sum')
    n = _all_reduce(np.asarray(float(np.asarray(total_ins_num).sum()
                    if not np.isscalar(total_ins_num)
                    else total_ins_num)), 'sum')
    return float(np.sqrt(e / np.maximum(n, 1e-12)))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Parity: fleet.metrics.auc — global AUC from per-trainer
    positive/negative prediction-bucket histograms (the reference's
    distributed AUC recipe: allreduce the buckets, then trapezoid)."""
    pos = _all_reduce(_np(stat_pos).reshape(-1), 'sum')
    neg = _all_reduce(_np(stat_neg).reshape(-1), 'sum')
    # walk buckets from high score to low, accumulating tp/fp
    tot_pos = new_pos = 0.0
    tot_neg = new_neg = 0.0
    area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    return float(area / (tot_pos * tot_neg))
