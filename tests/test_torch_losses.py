"""The port's loss functions (`ops/nn_ops.py`) and loss layers
(`nn/layer/loss.py`) against paddle_tpu's, forward and the VJP with
respect to the inputs, on the same seeded numpy inputs, under
reduction 'none', 'mean' and 'sum', at rtol 2e-4 / atol 2e-5 (fp32).

Where the port follows PaddlePaddle rather than the reference, the case
is held against an oracle built from the reference's correct part and
beside it a check that shows the reference's fault:
- `nll_loss` honours `weight` and `ignore_index` (the reference takes
  and ignores both): its 'none' is the reference's times the weight at
  the label (0 when ignored), its 'mean' that sum over the weights';
- `multi_margin_loss` honours `weight` (ignored by the reference);
- `ctc_loss`'s 'none' and 'sum' are the raw losses (the reference
  divides them by the label lengths, as PaddlePaddle's 'mean' alone
  does);
- `cross_entropy`'s weighted rows with `ignore_index` give 0 (the
  reference looks the ignored label's weight up out of range: NaN).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn.layer import loss as JLL
from paddle_tpu.ops import nn_ops as J
from paddle_tpu_torch.nn.layer import loss as TLL
from paddle_tpu_torch.ops import nn_ops as T
from torch_surface_util import FP32, check_op, rand
from torch_threads import one_intra_op_thread  # noqa: F401

R = np.random.RandomState
REDUCTIONS = ('none', 'mean', 'sum')


def _probs(r, *shape):
    return r.uniform(0.05, 0.95, shape).astype(np.float32)


def _labels(r, n, c, ignore=None):
    lab = r.randint(0, c, n).astype(np.int64)
    if ignore is not None:
        lab[::3] = ignore
    return lab


# name: (inputs, kwargs, differentiated indices, takes reduction)
LOSSES = {
    'mse_loss': (lambda r: [rand(r, 4, 5), rand(r, 4, 5)], {}, (0, 1), True),
    'l1_loss': (lambda r: [rand(r, 4, 5), rand(r, 4, 5)], {}, (0, 1), True),
    'smooth_l1_loss': (lambda r: [rand(r, 4, 5), rand(r, 4, 5)],
                       dict(delta=0.7), (0, 1), True),
    'kl_div': (lambda r: [rand(r, 4, 5), _probs(r, 4, 5)], {}, (0, 1), True),
    'margin_ranking_loss': (lambda r: [rand(r, 6), rand(r, 6),
                                       np.sign(rand(r, 6))],
                            dict(margin=0.1), (0, 1), True),
    'triplet_margin_loss': (lambda r: [rand(r, 4, 5), rand(r, 4, 5),
                                       rand(r, 4, 5)], {}, (0, 1, 2), True),
    'triplet_margin_loss-swap': (lambda r: [rand(r, 4, 5), rand(r, 4, 5),
                                            rand(r, 4, 5)],
                                 dict(swap=True, p=1.0), (0, 1, 2), True),
    'cosine_embedding_loss': (lambda r: [rand(r, 6, 5), rand(r, 6, 5),
                                         np.array([1, -1, 1, 1, -1, -1],
                                                  np.int32)],
                              dict(margin=0.2), (0, 1), True),
    'soft_margin_loss': (lambda r: [rand(r, 4, 5), np.sign(rand(r, 4, 5))],
                         {}, (0,), True),
    'multi_margin_loss': (lambda r: [rand(r, 6, 4), _labels(r, 6, 4)],
                          dict(margin=0.5), (0,), True),
    'multi_margin_loss-p2': (lambda r: [rand(r, 6, 4), _labels(r, 6, 4)],
                             dict(p=2), (0,), True),
    'binary_cross_entropy': (lambda r: [_probs(r, 4, 5), _probs(r, 4, 5)],
                             {}, (0,), True),
    'binary_cross_entropy_with_logits': (
        lambda r: [rand(r, 4, 5), _probs(r, 4, 5)],
        dict(pos_weight=2.0), (0,), True),
    'cross_entropy': (lambda r: [rand(r, 6, 5), _labels(r, 6, 5)], {}, (0,),
                      True),
    'cross_entropy-weight': (lambda r: [rand(r, 6, 5), _labels(r, 6, 5)],
                             {}, (0,), True),
    'cross_entropy-ignore': (lambda r: [rand(r, 6, 5),
                                        _labels(r, 6, 5, ignore=-100)],
                             {}, (0,), True),
    'cross_entropy-probs': (lambda r: [_probs(r, 6, 5), _labels(r, 6, 5)],
                            dict(use_softmax=False), (0,), True),
    'cross_entropy-soft': (lambda r: [rand(r, 6, 5), _probs(r, 6, 5)],
                           dict(soft_label=True), (0,), True),
    'nll_loss': (lambda r: [rand(r, 6, 5), _labels(r, 6, 5)], {}, (0,),
                 True),
    'hinge_loss': (lambda r: [rand(r, 4, 5), (rand(r, 4, 5) > 0)
                              .astype(np.float32)], {}, (0,), False),
    'log_loss': (lambda r: [_probs(r, 4, 1), (rand(r, 4, 1) > 0)
                            .astype(np.float32)], {}, (0,), False),
    'square_error_cost': (lambda r: [rand(r, 4, 5), rand(r, 4, 5)], {},
                          (0, 1), False),
    'label_smooth': (lambda r: [_probs(r, 4, 5)], dict(epsilon=0.2), (0,),
                     False),
    'npair_loss': (lambda r: [rand(r, 6, 5), rand(r, 6, 5),
                              np.array([0, 1, 0, 2, 1, 2], np.int32)], {},
                   (0, 1), False),
    'dice_loss': (lambda r: [_probs(r, 4, 3, 5),
                             r.randint(0, 5, (4, 3, 1)).astype(np.int32)],
                  {}, (0,), False),
    'sigmoid_focal_loss': (lambda r: [rand(r, 4, 5), (rand(r, 4, 5) > 0)
                                      .astype(np.float32)], {}, (0,), True),
    'sigmoid_focal_loss-normalizer': (
        lambda r: [rand(r, 4, 5), (rand(r, 4, 5) > 0).astype(np.float32),
                   np.array([3.0], np.float32)], {}, (0,), True),
}
CASES = [(n, red) for n, c in sorted(LOSSES.items())
         for red in (REDUCTIONS if c[3] else (None,))]


@pytest.mark.parametrize('name,reduction', CASES,
                         ids=[f'{n}-{r}' for n, r in CASES])
def test_loss_matches_jax(name, reduction):
    build, kw, diff, _ = LOSSES[name]
    r = R(sum(map(ord, name)))
    arrays = build(r)
    jkw = tkw = kw
    if name == 'cross_entropy-weight':
        w = _probs(r, 5)
        jkw, tkw = dict(kw, weight=Tensor(w)), dict(kw,
                                                    weight=torch.from_numpy(w))
    if reduction is not None:
        jkw = dict(jkw, reduction=reduction)
        tkw = dict(tkw, reduction=reduction)
    op = name.split('-')[0]
    check_op(lambda *a: getattr(J, op)(*a, **jkw),
             lambda *a: getattr(T, op)(*a, **tkw), arrays, diff=diff,
             what=name)


def test_kl_div_batchmean_matches_jax():
    r = R(5)
    check_op(lambda a, b: J.kl_div(a, b, reduction='batchmean'),
             lambda a, b: T.kl_div(a, b, reduction='batchmean'),
             [rand(r, 4, 5), _probs(r, 4, 5)], diff=(0, 1))


@pytest.mark.parametrize('reduction', REDUCTIONS)
def test_nll_loss_weight_and_ignore_index_follow_paddle(reduction):
    r = R(11)
    x, lab, w = rand(r, 7, 5), _labels(r, 7, 5, ignore=-1), _probs(r, 5)
    safe = np.where(lab == -1, 0, lab)
    per_row = np.asarray(J.nll_loss(Tensor(x), Tensor(safe),
                                    reduction='none').data)
    wt = np.where(lab == -1, 0.0, w[safe])
    want = {'none': per_row * wt, 'sum': (per_row * wt).sum(),
            'mean': (per_row * wt).sum() / wt.sum()}[reduction]
    got = T.nll_loss(torch.from_numpy(x), torch.from_numpy(lab),
                     weight=torch.from_numpy(w), ignore_index=-1,
                     reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    # the reference takes both arguments and ignores them
    ref = np.asarray(J.nll_loss(Tensor(x), Tensor(safe),
                                weight=Tensor(w), ignore_index=-1,
                                reduction='none').data)
    np.testing.assert_allclose(ref, per_row)
    layer = TLL.NLLLoss(weight=torch.from_numpy(w), ignore_index=-1,
                        reduction=reduction)
    np.testing.assert_allclose(layer(torch.from_numpy(x),
                                     torch.from_numpy(lab)).numpy(), want,
                               **FP32)


def test_multi_margin_loss_weight_follows_paddle():
    r = R(12)
    x, lab, w = rand(r, 6, 4), _labels(r, 6, 4), _probs(r, 4)
    per_row = np.asarray(J.multi_margin_loss(Tensor(x), Tensor(lab),
                                             reduction='none').data)
    got = T.multi_margin_loss(torch.from_numpy(x), torch.from_numpy(lab),
                              weight=torch.from_numpy(w), reduction='none')
    np.testing.assert_allclose(got.numpy(), per_row * w[lab], **FP32)
    ref = np.asarray(J.multi_margin_loss(Tensor(x), Tensor(lab),
                                         weight=Tensor(w),
                                         reduction='none').data)
    np.testing.assert_allclose(ref, per_row)


def test_cross_entropy_weight_with_ignored_rows():
    r = R(13)
    x, lab, w = rand(r, 6, 5), _labels(r, 6, 5, ignore=-100), _probs(r, 5)
    got = T.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                          weight=torch.from_numpy(w), reduction='none')
    kept = lab != -100
    want = np.asarray(J.cross_entropy(Tensor(x[kept]), Tensor(lab[kept]),
                                      weight=Tensor(w),
                                      reduction='none').data)
    np.testing.assert_allclose(got.numpy()[kept], want, **FP32)
    np.testing.assert_array_equal(got.numpy()[~kept], 0.0)
    ref = np.asarray(J.cross_entropy(Tensor(x), Tensor(lab),
                                     weight=Tensor(w),
                                     reduction='none').data)
    assert not np.isfinite(ref[~kept]).all()


def _ctc_inputs(seed=21, T_=12, B=3, C=5, S=4):
    r = R(seed)
    lp = rand(r, T_, B, C)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    labels = r.randint(1, C, (B, S)).astype(np.int32)
    il = np.array([T_, T_ - 2, T_ - 3], np.int32)
    ll = np.array([S, S - 1, 2], np.int32)
    return lp.astype(np.float32), labels, il, ll


def test_ctc_loss_mean_matches_jax():
    lp, labels, il, ll = _ctc_inputs()
    check_op(lambda a, *rest: J.ctc_loss(a, *rest, blank=0),
             lambda a, *rest: T.ctc_loss(a, *rest, blank=0),
             [lp, labels, il, ll], diff=(0,))


@pytest.mark.parametrize('reduction', ('none', 'sum'))
def test_ctc_loss_none_and_sum_are_the_raw_losses(reduction):
    lp, labels, il, ll = _ctc_inputs(22)
    per_len = np.asarray(J.ctc_loss(Tensor(lp), Tensor(labels), Tensor(il),
                                    Tensor(ll), reduction='none').data)
    raw = per_len * ll
    got = T.ctc_loss(*(torch.from_numpy(a) for a in (lp, labels, il, ll)),
                     reduction=reduction)
    np.testing.assert_allclose(got.numpy(), raw if reduction == 'none'
                               else raw.sum(), **FP32)
    # torch's own CTC agrees on the raw losses
    lib = torch.nn.functional.ctc_loss(
        torch.from_numpy(lp), torch.from_numpy(labels).long(),
        torch.from_numpy(il).long(), torch.from_numpy(ll).long(),
        reduction='none')
    np.testing.assert_allclose(lib.numpy(), raw, **FP32)


LAYERS = [
    ('CrossEntropyLoss', dict(reduction='sum'),
     lambda r: [rand(r, 6, 5), _labels(r, 6, 5)]),
    ('MSELoss', {}, lambda r: [rand(r, 4, 5), rand(r, 4, 5)]),
    ('L1Loss', dict(reduction='none'), lambda r: [rand(r, 4, 5),
                                                  rand(r, 4, 5)]),
    ('NLLLoss', {}, lambda r: [rand(r, 6, 5), _labels(r, 6, 5)]),
    ('BCELoss', {}, lambda r: [_probs(r, 4, 5), _probs(r, 4, 5)]),
    ('BCEWithLogitsLoss', dict(reduction='sum'),
     lambda r: [rand(r, 4, 5), _probs(r, 4, 5)]),
    ('KLDivLoss', dict(reduction='batchmean'),
     lambda r: [rand(r, 4, 5), _probs(r, 4, 5)]),
    ('SmoothL1Loss', dict(delta=0.5), lambda r: [rand(r, 4, 5),
                                                 rand(r, 4, 5)]),
    ('MarginRankingLoss', dict(margin=0.2),
     lambda r: [rand(r, 6), rand(r, 6), np.sign(rand(r, 6))]),
    ('TripletMarginLoss', dict(margin=0.5),
     lambda r: [rand(r, 4, 5), rand(r, 4, 5), rand(r, 4, 5)]),
    ('CosineEmbeddingLoss', {}, lambda r: [
        rand(r, 4, 5), rand(r, 4, 5), np.array([1, -1, 1, -1], np.int32)]),
    ('SoftMarginLoss', dict(reduction='sum'),
     lambda r: [rand(r, 4, 5), np.sign(rand(r, 4, 5))]),
    ('MultiMarginLoss', dict(margin=0.7),
     lambda r: [rand(r, 6, 4), _labels(r, 6, 4)]),
    ('CTCLoss', dict(blank=0), lambda r: list(_ctc_inputs(23))),
]


@pytest.mark.parametrize('i', range(len(LAYERS)),
                         ids=[c[0] for c in LAYERS])
def test_loss_layer_matches_jax(i):
    name, kw, build = LAYERS[i]
    arrays = build(R(i))
    jl, tl = getattr(JLL, name)(**kw), getattr(TLL, name)(**kw)
    check_op(lambda *a: jl(*a), lambda *a: tl(*a), arrays, diff=(0,),
             what=name)
