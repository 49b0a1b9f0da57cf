"""The port's copy of `paddle_tpu/metric/__init__.py` — parity:
python/paddle/metric (Accuracy, Precision, Recall, Auc) + functional
accuracy and mean_iou (operators/metrics/, mean_iou_op.cc). Metrics
accumulate on the host in numpy; inputs may be tensors on any device or
arrays, and tensor results are host tensors."""
import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
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
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or 'acc'
        self.maxk = max(self.topk)
        self.reset()

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        order = np.argsort(-pred, axis=-1)[..., :self.maxk]
        if label.ndim == pred.ndim:
            label = label.squeeze(-1)
        correct = (order == label[..., None])
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        for k in self.topk:
            num = correct[..., :k].sum()
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += correct.shape[0]
            accs.append(num / correct.shape[0])
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total,
                                                       self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name='precision', *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        pred_pos = (preds.round() == 1)
        self.tp += int(((labels == 1) & pred_pos).sum())
        self.fp += int(((labels == 0) & pred_pos).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name='recall', *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        pred_pos = (preds.round() == 1)
        self.tp += int(((labels == 1) & pred_pos).sum())
        self.fn += int(((labels == 1) & ~pred_pos).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Parity: paddle.metric.Auc (threshold-bucketed trapezoid AUC,
    operators/metrics/auc_op)."""

    def __init__(self, curve='ROC', num_thresholds=4095, name='auc', *args,
                 **kwargs):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        if preds.ndim == 2:
            preds = preds[:, 1]
        labels = labels.reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional accuracy (parity: operators/metrics/accuracy_op)."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    order = np.argsort(-pred, axis=-1)[:, :k]
    correct_ = (order == lab[:, None]).any(axis=1)
    return torch.tensor(correct_.mean(), dtype=torch.float32)


def mean_iou(input, label, num_classes):
    """paddle.metric.mean_iou (mean_iou_op.cc; the reference's
    ops/contrib.py:585): correct[c] counts pred == label hits at class
    c, wrong[c] both sides of each miss; the mean of correct / (correct
    + wrong) over the classes seen. Returns (mean_iou float32 scalar,
    out_wrong int32 [C], out_correct int32 [C]) on the input's device."""
    pred = torch.as_tensor(input).reshape(-1).to(torch.int64)
    lab = torch.as_tensor(label, device=pred.device).reshape(-1).to(
        torch.int64)
    C = int(num_classes)
    hit = pred == lab
    miss = (~hit).to(torch.int32)
    correct = torch.zeros(C, dtype=torch.int32, device=pred.device)
    correct.index_add_(0, pred, hit.to(torch.int32))
    wrong = torch.zeros(C, dtype=torch.int32, device=pred.device)
    wrong.index_add_(0, pred, miss).index_add_(0, lab, miss)
    denom = wrong + correct
    valid = (denom != 0).sum()
    iou = correct / denom.clamp(min=1)
    miou = (iou.sum() / valid.clamp(min=1)).to(torch.float32)
    return miou, wrong, correct
