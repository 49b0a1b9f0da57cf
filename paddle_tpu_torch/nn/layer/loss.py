"""Loss layers — counterparts of `paddle_tpu/nn/layer/loss.py:6-160`:
thin modules over the losses of `ops/nn_ops.py`, with the reference's
arguments. `HSigmoidLoss` (:161) needs `ops/contrib.py` and comes with
it (ROADMAP Queue 1 item 9c-4)."""
from torch import nn

from ...ops import nn_ops as F


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._args = dict(weight=weight, ignore_index=ignore_index,
                          reduction=reduction, soft_label=soft_label,
                          axis=axis, use_softmax=use_softmax)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._args)


class MSELoss(nn.Module):
    def __init__(self, reduction='mean'):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, reduction=self._reduction)


class L1Loss(nn.Module):
    def __init__(self, reduction='mean', name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, reduction=self._reduction)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 name=None):
        super().__init__()
        self._args = dict(weight=weight, ignore_index=ignore_index,
                          reduction=reduction)

    def forward(self, input, label):
        return F.nll_loss(input, label, **self._args)


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction='mean', name=None):
        super().__init__()
        self._weight, self._reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, weight=self._weight,
                                      reduction=self._reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction='mean', pos_weight=None,
                 name=None):
        super().__init__()
        self._args = dict(weight=weight, reduction=reduction,
                          pos_weight=pos_weight)

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, **self._args)


class KLDivLoss(nn.Module):
    def __init__(self, reduction='mean'):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, reduction=self._reduction)


class SmoothL1Loss(nn.Module):
    def __init__(self, reduction='mean', delta=1.0, name=None):
        super().__init__()
        self._reduction, self._delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, reduction=self._reduction,
                                delta=self._delta)


class MarginRankingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class TripletMarginLoss(nn.Module):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction='mean', name=None):
        super().__init__()
        self._args = dict(margin=margin, p=p, epsilon=epsilon, swap=swap,
                          reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self._args)


class CosineEmbeddingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label,
                                       margin=self._margin,
                                       reduction=self._reduction)


class SoftMarginLoss(nn.Module):
    def __init__(self, reduction='mean', name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, reduction=self._reduction)


class MultiMarginLoss(nn.Module):
    def __init__(self, p=1, margin=1.0, weight=None, reduction='mean',
                 name=None):
        super().__init__()
        self._args = dict(p=p, margin=margin, weight=weight,
                          reduction=reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, **self._args)


class CTCLoss(nn.Module):
    def __init__(self, blank=0, reduction='mean'):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self._blank, reduction=self._reduction)
