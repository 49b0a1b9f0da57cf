"""Neural-network functional ops — the subset of `paddle_tpu/ops/nn_ops.py`
the serving and training slices run: `gelu` (:36), `bias_gelu` (:41),
`dropout_add` (:60-110), `layer_norm` (:217) with its fused-route gate
(:243-246), `linear` (:402), `dropout` (:703-720), `embedding` (:746),
`softmax_with_cross_entropy` (:906), hard labels over the last axis on
its fused route (`_fused_hard_xent`, :768-798), over another axis, soft
labels and `return_softmax`, `cross_entropy` (:944) on it, the chunked
projection with a hard cross-entropy, `fused_linear_cross_entropy`
(:801-903), and the activations `relu`, `tanh` and `softmax` (:191)
that `nn.Transformer` and BERT use. The vision slice adds the rest of
the activations (:23-215), `batch_norm` (:268-319), `conv1d`/`conv2d`/
`conv3d` (:412-497) and the 2-D pools (:542-652). The CTR slice adds
`binary_cross_entropy` (:1013) and `binary_cross_entropy_with_logits`
(:1025), plain torch as the reference's are plain jnp. The op-surface
slice adds the rest of the losses (:977-1290, `dice_loss` :1635,
`sigmoid_focal_loss` :1655), `cross_entropy`'s `weight` and
`use_softmax`, the channels-last layouts of the convolutions and the
2-D pools, and the transposed convolutions (:500, :1538, :1562).

Dropout in training draws its keep mask from the generator bound by
`core.rng.rng_guard` (jit.TrainStep binds its own) and raises when none
is bound. `dropout_add` in training (upscale_in_train) runs the fused
dropout+residual kernels through `DropoutAddFunction`; `dropout` stays
plain PyTorch, as the reference's is plain jnp. As in jnp, a scalar
operand takes the tensor's dtype: a bf16 x is divided by (or scaled
with) 1 - p rounded to bf16.

Functions take and return torch tensors. Each public op stands for one
`run_op` of the reference, so `amp.auto_cast` does not reach inside it
(`@uncast`).
"""
import math

import torch
from torch.nn import functional as _tF

from ..amp import uncast
from ..core import rng as _rng
from ..distributed.fleet.utils import recompute as _remat
from .kernels import fused_elementwise as _fe
from .kernels import fused_norm as _fln


@uncast
def gelu(x, approximate=False):
    """jax.nn.gelu's forms, evaluated in fp32 and rounded to x's dtype."""
    return _fe.gelu_f32(x.float(), approximate).to(x.dtype)


@uncast
def bias_gelu(x, bias=None, approximate=False):
    """gelu(x + bias): the fused bias+GELU kernel on CUDA tensors, its
    plain version on CPU tensors; bias=None degrades to plain gelu."""
    if bias is None:
        return gelu(x, approximate=approximate)
    return _fe.bias_gelu(x, bias, approximate)


def _mask_shape(x, axis):
    if axis is None:
        return tuple(x.shape)
    axes = [axis] if isinstance(axis, int) else list(axis)
    axes = [a % x.dim() for a in axes]
    return tuple(d if i in axes else 1 for i, d in enumerate(x.shape))


@uncast
def dropout(x, p=0.5, axis=None, training=True, mode='upscale_in_train'):
    """Parity: operators/dropout_op (nn_ops.py:703-720). In training the
    keep mask (of x's shape, or broadcast along the dims not in `axis`)
    comes from the bound generator; upscale_in_train divides the kept
    elements by 1 - p, downscale_in_infer keeps them as they are and
    scales by 1 - p at eval."""
    if not training or p == 0.0:
        if mode == 'upscale_in_train':
            return x
        return x * _fe.keep_scale(x, p)
    keep = _rng.keep_mask(_mask_shape(x, axis), 1.0 - p, x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == 'upscale_in_train':
        return torch.where(keep, x / _fe.keep_scale(x, p), zero)
    return torch.where(keep, x, zero)


@uncast
def dropout_add(x, residual, p=0.5, training=True,
                mode='upscale_in_train'):
    """The residual join `residual + dropout(x)` (nn_ops.py:60-110). In
    training with upscale_in_train: the fused dropout+residual kernels
    (their plain versions on the CPU) on a keep mask drawn from the bound
    generator at the point the plain `dropout` would draw it; at eval or
    p=0 a plain add."""
    if not training or p == 0.0:
        if mode == 'upscale_in_train':
            return x + residual
        return x * _fe.keep_scale(x, p) + residual
    if mode != 'upscale_in_train':
        return dropout(x, p=p, training=training, mode=mode) + residual
    keep = _rng.keep_mask(tuple(x.shape), 1.0 - p, x.device)
    return _fe.dropout_add(x, residual, keep, p)


@uncast
def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-05):
    """Parity: operators/layer_norm_op. The GPT/BERT shape — last-axis
    normalisation with weight and bias of x's dtype — takes the fused
    route (kernel on CUDA, its plain version on CPU); anything else runs
    the unfused path, which promotes like the jnp reference (bf16 x with
    fp32 weight gives an fp32 result)."""
    if normalized_shape is None:
        normalized_shape = x.shape[-1:]
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(normalized_shape)
    fused_ok = (n_axes == 1 and weight is not None and bias is not None
                and x.dim() >= 2
                and tuple(normalized_shape) == (x.shape[-1],)
                and weight.dtype == x.dtype and bias.dtype == x.dtype)
    if fused_ok:
        return _fln.layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    xf = x.float()
    mean = xf.mean(axes, keepdim=True)
    var = ((xf - mean) ** 2).mean(axes, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _promoted(*ts):
    """`ts` cast to their common dtype, as jnp promotes mixed operands
    (a bf16 weight against fp32 activations gives fp32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in ts)


@uncast
def linear(x, weight, bias=None):
    """y = x @ W (+ b), W laid out [in, out] as in paddle."""
    out = torch.matmul(*_promoted(x, weight))
    return out if bias is None else out + bias


@uncast
def relu(x):
    """max(x, 0) in x's dtype."""
    return torch.relu(x)


@uncast
def tanh(x):
    """tanh in x's dtype, rounded once from float64 (torch's fp32 tanh can
    err on its first call in a process, fused_elementwise._once)."""
    return _fe._once(torch.tanh, x)


@uncast
def softmax(x, axis=-1):
    """jax.nn.softmax over `axis`, in x's dtype."""
    return _softmax(x, axis)


@uncast
def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of `weight` at integer ids `x` (lookup_table_v2); ids equal
    to a non-negative `padding_idx` look up zeros (:746-756). The
    gradient is torch's embedding backward, which sums the rows of
    repeated ids in parallel; advanced indexing's backward serialises
    them, and BERT-base's token-type table, one id for every token of a
    64 x 512 batch, took 31.5 ms of a step on an H100 that way."""
    idx = x.to(torch.long)
    out = torch.nn.functional.embedding(idx, weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return out


class _HardXent(torch.autograd.Function):
    """Hard-label softmax cross-entropy over the last axis, the custom
    VJP `_fused_hard_xent` (nn_ops.py:768-798): lg [N, C], idx [N] ->
    loss [N] fp32. Only the (low-precision) logits and the [N] fp32
    logsumexp are saved; the backward recomputes the softmax, so no
    fp32 [N, C] log-probability tensor outlives the forward. The fp32
    [N, C] temporaries of each direction are updated in place, one at a
    time."""

    @staticmethod
    def forward(ctx, lg, idx, ignore_index):
        m = lg.amax(-1, keepdim=True).float()
        e = lg.to(torch.float32, copy=True)    # never the logits themselves
        e.sub_(m).exp_()
        lse = m + torch.log(e.sum(-1, keepdim=True))
        del e
        ignored = idx == ignore_index
        safe = torch.where(ignored, torch.zeros_like(idx), idx)
        picked = lg.gather(-1, safe[:, None]).float()
        loss = (lse - picked)[:, 0]
        loss = torch.where(ignored, torch.zeros_like(loss), loss)
        ctx.save_for_backward(lg, safe, lse, ignored)
        return loss

    @staticmethod
    def backward(ctx, g):
        lg, safe, lse, ignored = ctx.saved_tensors
        p = lg.to(torch.float32, copy=True)
        p.sub_(lse).exp_()                                  # the softmax
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, safe] -= 1.0                                # - onehot
        valid = (~ignored).float()
        p.mul_((g.float() * valid)[:, None])
        return p.to(lg.dtype), None, None


@uncast
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """Parity: operators/softmax_with_cross_entropy_op (nn_ops.py:906-943).
    Hard labels over the last axis (class ids shaped like logits without
    that axis, or with a trailing 1) take the fused route: the per-row
    loss [..., 1] computed in fp32 and returned in the logits' dtype,
    rows whose label is `ignore_index` giving 0. Hard labels over
    another axis (ids shaped like logits without it, or with a 1 there)
    take the reference's log-softmax route, in fp32. Soft labels (a
    distribution of logits' shape) give -sum(label * log_softmax(logits))
    over `axis`, kept as a size-1 axis, in the logits' dtype. With
    `return_softmax`, returns (loss, softmax(logits) over `axis`)."""
    if soft_label:
        loss = _soft_xent(logits, label, axis)
    else:
        loss = _hard_xent(logits, label, ignore_index, axis)
    if return_softmax:
        return loss, _softmax(logits, axis)
    return loss


def _softmax(x, axis):
    """jax.nn.softmax's ops, in x's dtype."""
    e = torch.exp(x - x.amax(axis, keepdim=True).detach())
    return e / e.sum(axis, keepdim=True)


def _log_softmax(x, axis):
    """jax.nn.log_softmax's ops, in x's dtype."""
    shifted = x - x.amax(axis, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(axis, keepdim=True))


def _soft_xent(logits, label, axis):
    if label.shape != logits.shape:
        raise ValueError(f'softmax_with_cross_entropy: a soft label '
                         f'{tuple(label.shape)} must have the logits\' shape '
                         f'{tuple(logits.shape)}')
    label = label.to(logits.device)
    return -(label * _log_softmax(logits, axis)).sum(axis, keepdim=True)


def _hard_xent(logits, label, ignore_index, axis):
    nd = axis % logits.dim()
    lead = logits.shape[:nd] + logits.shape[nd + 1:]
    kept = logits.shape[:nd] + (1,) + logits.shape[nd + 1:]
    if label.shape not in (lead, kept):
        raise ValueError(f'softmax_with_cross_entropy: label shape '
                         f'{tuple(label.shape)} does not match logits '
                         f'{tuple(logits.shape)} over axis {axis}')
    idx = label.to(device=logits.device, dtype=torch.long)
    if nd == logits.dim() - 1:
        C = logits.shape[-1]
        out = _HardXent.apply(logits.reshape(-1, C), idx.reshape(-1),
                              ignore_index)
        return out.reshape(lead + (1,)).to(logits.dtype)
    # nn_ops.py:924-940: log-softmax in fp32, the label's entry picked
    if idx.shape == lead:
        idx = idx.unsqueeze(nd)
    ignored = idx == ignore_index
    safe = torch.where(ignored, torch.zeros_like(idx), idx)
    picked = _log_softmax(logits.float(), nd).gather(nd, safe)
    loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    return loss.to(logits.dtype)


def _reduce_loss(loss, reduction):
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    return loss


def _loss_label(label, ref):
    """A label as a tensor of `ref`'s dtype on its device (jnp's
    promotion of an integer label against a float input)."""
    return torch.as_tensor(label, device=ref.device).to(ref.dtype)


@uncast
def binary_cross_entropy(input, label, weight=None, reduction='mean'):
    """bce_loss (:1013): probabilities clipped to [1e-12, 1 - 1e-7]."""
    a = input.clamp(1e-12, 1.0 - 1e-7)
    b = _loss_label(label, input)
    loss = -(b * torch.log(a) + (1 - b) * torch.log(1 - a))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


@uncast
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction='mean', pos_weight=None):
    """sigmoid_cross_entropy_with_logits (:1025), in its stable form
    max(a, 0) - a b + log1p(exp(-|a|)); `pos_weight` scales the positive
    term by (pos_weight - 1) b + 1."""
    a = logit
    b = _loss_label(label, logit)
    loss = a.clamp(min=0) - a * b + torch.log1p(torch.exp(-a.abs()))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1) * b + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


@uncast
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction='mean', soft_label=False, axis=-1,
                  use_softmax=True):
    """Parity: nn_ops.py:944-979: a label with a size-1 class axis is
    squeezed, the per-row loss is `softmax_with_cross_entropy`'s in the
    input's dtype (with `use_softmax=False`, -log(max(input, 1e-12)) at
    the label: the input is already a distribution), times `weight` at
    the label when given, and the mean or sum is taken over it (jnp's
    mean of a bf16 array sums in fp32 and rounds once). The mean divides
    by every row, ignored ones included, as the reference's. A row whose
    label is `ignore_index` gives 0, weighted too (the reference looks
    its weight up out of range, a NaN); a soft label's weight is its
    weighted sum over the classes."""
    nd = axis % input.dim()
    if label.dim() == input.dim() and not soft_label \
            and label.shape[nd] == 1:
        label = label.squeeze(nd)
    if use_softmax:
        loss = softmax_with_cross_entropy(input, label, soft_label=soft_label,
                                          ignore_index=ignore_index,
                                          axis=axis)
    else:
        idx = label.to(device=input.device, dtype=torch.long).unsqueeze(nd)
        ignored = idx == ignore_index
        safe = torch.where(ignored, torch.zeros_like(idx), idx)
        loss = -torch.log(input.clamp(min=1e-12)).gather(nd, safe)
        loss = torch.where(ignored, torch.zeros_like(loss), loss)
    if weight is not None:
        w = weight.to(input.device)
        if soft_label:
            wt = (label.to(w.dtype) * w.reshape(
                (-1,) + (1,) * (input.dim() - 1 - nd))).sum(nd, keepdim=True)
        else:
            idx = label.to(device=input.device, dtype=torch.long)
            wt = w[torch.where(idx == ignore_index, torch.zeros_like(idx),
                               idx)].unsqueeze(nd)
        loss = loss * wt.to(loss.dtype)
    if reduction == 'none':
        return loss
    if loss.dim() > label.dim() or soft_label:
        loss = loss.squeeze(nd)
    out = _reduce_loss(loss.float(), reduction)
    return out.to(loss.dtype)


@uncast
def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction='mean'):
    """Parity: nn_ops.py:977-984, honouring `weight` and `ignore_index`
    as PaddlePaddle does (the reference takes and ignores both): input
    [N, C, ...] log-probabilities, label [N, ...]; the loss of a row is
    -weight[label]·input[label], 0 for an ignored row; 'mean' divides
    the sum by the sum of the rows' weights (by the count of rows not
    ignored without a weight)."""
    idx = label.to(device=input.device, dtype=torch.long)
    ignored = idx == ignore_index
    safe = torch.where(ignored, torch.zeros_like(idx), idx)
    picked = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    w = torch.ones_like(picked) if weight is None \
        else weight.to(device=input.device, dtype=input.dtype)[safe]
    w = torch.where(ignored, torch.zeros_like(w), w)
    loss = picked * w
    if reduction == 'mean':
        return loss.sum() / w.sum()
    return _reduce_loss(loss, reduction)


@uncast
def mse_loss(input, label, reduction='mean'):
    return _reduce_loss((input - _loss_label(label, input)) ** 2, reduction)


@uncast
def l1_loss(input, label, reduction='mean'):
    return _reduce_loss(torch.abs(input - _loss_label(label, input)),
                        reduction)


@uncast
def smooth_l1_loss(input, label, reduction='mean', delta=1.0):
    """0.5 d² / delta where |d| < delta, else |d| - delta / 2 (:1003)."""
    d = torch.abs(input - _loss_label(label, input))
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


@uncast
def kl_div(input, label, reduction='mean'):
    """label · (log label - input) (:1046), 'batchmean' the sum over the
    batch size."""
    b = _loss_label(label, input)
    loss = b * (torch.log(b.clamp(min=1e-12)) - input)
    if reduction == 'batchmean':
        return loss.sum() / input.shape[0]
    return _reduce_loss(loss, reduction)


@uncast
def hinge_loss(input, label):
    return torch.clamp(1.0 - (2 * _loss_label(label, input) - 1) * input,
                       min=0.0)


@uncast
def margin_ranking_loss(input, other, label, margin=0.0, reduction='mean'):
    loss = torch.clamp(-_loss_label(label, input)
                       * (input - _loss_label(other, input)) + margin,
                       min=0.0)
    return _reduce_loss(loss, reduction)


@uncast
def log_loss(input, label, epsilon=1e-4):
    b = _loss_label(label, input)
    return -b * torch.log(input + epsilon) \
        - (1 - b) * torch.log(1 - input + epsilon)


@uncast
def square_error_cost(input, label):
    return (input - _loss_label(label, input)) ** 2


@uncast
def label_smooth(label, prior_dist=None, epsilon=0.1):
    """(1 - epsilon)·label + epsilon·prior (uniform over the last axis
    without one)."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@uncast
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Parity: :1193-1208: softmax cross-entropy of anchor·positiveᵀ
    against the rows of equal labels, plus the l2 term."""
    sim = anchor @ positive.T
    lbl = labels.to(anchor.device).reshape(-1, 1)
    tgt = (lbl == lbl.T).to(anchor.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    ce = -torch.mean(torch.sum(tgt * _log_softmax(sim, 1), 1))
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, 1))
                    + torch.mean(torch.sum(positive * positive, 1))) / 2
    return ce + reg


@uncast
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction='mean'):
    def dist(x, y):
        return torch.pow(torch.sum(torch.pow(torch.abs(x - y) + epsilon, p),
                                   -1), 1.0 / p)
    positive = _loss_label(positive, input)
    negative = _loss_label(negative, input)
    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce_loss(torch.clamp(d_pos - d_neg + margin, min=0.0),
                        reduction)


@uncast
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction='mean'):
    """1 - cos for a positive label, max(0, cos - margin) otherwise."""
    cos = torch.sum(input1 * input2, -1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    lbl = label.to(input1.device)
    loss = torch.where(lbl > 0, 1 - cos, torch.clamp(cos - margin, min=0.0))
    return _reduce_loss(loss, reduction)


@uncast
def soft_margin_loss(input, label, reduction='mean'):
    return _reduce_loss(
        torch.log1p(torch.exp(-_loss_label(label, input) * input)),
        reduction)


@uncast
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction='mean'):
    """Parity: :1266-1277: sum over the classes other than the label of
    max(margin - x[label] + x[j], 0)^p, over C; `weight` (which the
    reference takes and ignores) scales a row by weight[label], as
    PaddlePaddle does."""
    c = input.shape[1]
    idx = label.to(device=input.device, dtype=torch.long)
    correct = input.gather(1, idx[:, None])
    loss = torch.pow(torch.clamp(margin - correct + input, min=0.0), p)
    mask = torch.ones_like(loss).scatter(1, idx[:, None], 0.0)
    loss = torch.sum(loss * mask, 1) / c
    if weight is not None:
        loss = loss * weight.to(device=input.device,
                                dtype=input.dtype)[idx]
    return _reduce_loss(loss, reduction)


def _lse2(a, b):
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


@uncast
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction='mean'):
    """Parity: operators/warpctc_op (:1280-1326): the CTC negative
    log-likelihood of each sequence by the forward recursion in log
    space over log_probs [T, B, C], labels [B, S] padded, the lengths
    [B]; impossible paths sit at -1e30, not -inf. 'mean' is the mean of
    each loss over its label length, 'sum' the sum of the losses and
    'none' the losses [B], as PaddlePaddle's (the reference divides by
    the label length under all three)."""
    lp = log_probs
    T, B, _ = lp.shape
    dev = lp.device
    lab = labels.to(device=dev, dtype=torch.long)
    S = lab.shape[1]
    L = 2 * S + 1
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    il = input_lengths.to(device=dev, dtype=torch.long)
    ll = label_lengths.to(device=dev, dtype=torch.long)
    neg = torch.full((B, 2), -1e30, dtype=lp.dtype, device=dev)
    alpha = torch.cat([lp[0, :, blank:blank + 1],
                       lp[0].gather(1, ext[:, 1:2]),
                       neg[:, :1].expand(B, L - 2)], 1)
    can_skip = torch.cat([
        torch.zeros((B, 2), dtype=torch.bool, device=dev),
        (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])], 1)
    for t in range(1, T):
        a = _lse2(alpha, torch.cat([neg[:, :1], alpha[:, :-1]], 1))
        a = torch.where(can_skip,
                        _lse2(a, torch.cat([neg, alpha[:, :-2]], 1)), a)
        new = a + lp[t].gather(1, ext)
        alpha = torch.where((t < il)[:, None], new, alpha)
    end = 2 * ll
    a1 = alpha.gather(1, end[:, None])[:, 0]
    a2 = alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    nll = -_lse2(a1, a2)
    if reduction == 'mean':
        return (nll / ll.clamp(min=1).to(nll.dtype)).mean()
    return _reduce_loss(nll, reduction)


@uncast
def dice_loss(input, label, epsilon=1e-5):
    """Parity: :1635-1652: 1 - (2|X∩Y| + eps) / (|X| + |Y| + eps) over
    every axis but the first, averaged; a [..., 1] class-id label is
    one-hot over input's last axis."""
    lbl = label.to(device=input.device, dtype=input.dtype)
    if lbl.shape[-1] == 1 and input.shape[-1] > 1:
        lbl = _tF.one_hot(lbl[..., 0].long(), input.shape[-1]).to(
            input.dtype)
    red = tuple(range(1, input.dim()))
    inter = (input * lbl).sum(red)
    union = input.sum(red) + lbl.sum(red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


@uncast
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction='sum'):
    """Parity: :1655-1681, the 2.x API: float one-hot labels, an
    optional normalizer dividing the loss."""
    y = label.to(device=logit.device, dtype=logit.dtype)
    sig = torch.sigmoid(logit)
    loss = -y * alpha * (1 - sig) ** gamma * _tF.logsigmoid(logit) \
        - (1 - y) * (1 - alpha) * sig ** gamma * _tF.logsigmoid(-logit)
    if normalizer is not None:
        loss = loss / normalizer.to(logit.device).reshape(())
    return _reduce_loss(loss, reduction)


_HALF = (torch.bfloat16, torch.float16)


def _mm_f32(a, b):
    """a @ b with an fp32 result, as dot_general with
    preferred_element_type=float32. A bf16 or fp16 pair on the card is
    one tensor-core product with fp32 accumulation and output, and no
    fp32 copy of either operand; otherwise the product of the operands
    widened to fp32 (exact, so the products are the same)."""
    if a.is_cuda and a.dtype in _HALF and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _addmm_f32(c, a, b):
    """c + a @ b for an fp32 c, the product as `_mm_f32`'s."""
    if a.is_cuda and a.dtype in _HALF and b.dtype == a.dtype:
        return torch.addmm(c, a, b, out_dtype=torch.float32)
    return torch.addmm(c, a.float(), b.float())


class _LinearXent(torch.autograd.Function):
    """The custom VJP `_linear_xent` (nn_ops.py:801-874): x [N, H], w
    [V, H] (transpose_y) or [H, V], idx [N] -> loss [N] fp32. The forward
    walks `chunks` row chunks of N/chunks and keeps only each row's
    logsumexp; the backward recomputes each chunk's logits. Products
    have fp32 results (`_mm_f32`), as the reference's dot_general; dl is
    rounded to x's dtype before the products of the backward, as the
    reference rounds it."""

    @staticmethod
    def forward(ctx, x, w, idx, ignore_index, chunks, transpose_y):
        wv = w.t() if transpose_y else w                # [H, V]
        loss, lse = [], []
        for xc, ic in zip(x.chunk(chunks), idx.chunk(chunks)):
            lg = _mm_f32(xc, wv)
            m = lg.amax(-1, keepdim=True)
            s = m + torch.log(torch.exp(lg - m).sum(-1, keepdim=True))
            ignored = ic == ignore_index
            safe = torch.where(ignored, torch.zeros_like(ic), ic)
            picked = lg.gather(-1, safe[:, None])
            lc = (s - picked)[:, 0]
            loss.append(torch.where(ignored, torch.zeros_like(lc), lc))
            lse.append(s[:, 0])
        ctx.save_for_backward(x, w, idx, torch.cat(lse))
        ctx.ignore_index, ctx.chunks = ignore_index, chunks
        ctx.transpose_y = transpose_y
        return torch.cat(loss)

    @staticmethod
    def backward(ctx, g):
        x, w, idx, lse = ctx.saved_tensors
        wv = w.t() if ctx.transpose_y else w            # [H, V]
        dw = torch.zeros(wv.shape, dtype=torch.float32, device=w.device)
        dx = []
        for xc, ic, sc, gc in zip(x.chunk(ctx.chunks), idx.chunk(ctx.chunks),
                                  lse.chunk(ctx.chunks), g.chunk(ctx.chunks)):
            p = torch.exp(_mm_f32(xc, wv) - sc[:, None])
            valid = ic != ctx.ignore_index
            safe = torch.where(valid, ic, torch.zeros_like(ic))
            rows = torch.arange(p.shape[0], device=p.device)
            p[rows, safe] -= 1.0                            # - onehot
            p.mul_((gc.float() * valid.float())[:, None])
            dl = p.to(x.dtype)
            del p
            dx.append(_mm_f32(dl, wv.t()).to(x.dtype))
            dw = _addmm_f32(dw, xc.t(), dl)
        dw = dw.t() if ctx.transpose_y else dw
        return torch.cat(dx), dw.to(w.dtype), None, None, None, None


@uncast
def fused_linear_cross_entropy(x, weight, label, ignore_index=-100,
                               reduction='mean', chunks=8,
                               transpose_y=True):
    """Projection + hard-label softmax cross-entropy without the [N, V]
    logits (nn_ops.py:879-903): x [..., H] @ weight^T (weight [V, H],
    transpose_y=True) or x @ weight (weight [H, V], transpose_y=False)
    against label [...]. `chunks` steps down until it divides N. Rows
    whose label is `ignore_index` give 0 (and count in the mean, as in
    the reference). The loss is fp32."""
    lead = tuple(x.shape[:-1])
    N = math.prod(lead)
    c = chunks
    while N % c:
        c -= 1
    idx = label.reshape(N).to(device=x.device, dtype=torch.long)
    out = _LinearXent.apply(x.reshape(N, x.shape[-1]), weight, idx,
                            ignore_index, c, transpose_y)
    return _reduce_loss(out.reshape(lead), reduction)


# ---- the rest of the activations (nn_ops.py:23-215, math.py:60-64) ----------
@uncast
def sigmoid(x):
    return torch.sigmoid(x)


@uncast
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@uncast
def elu(x, alpha=1.0):
    return _tF.elu(x, alpha)


@uncast
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@uncast
def celu(x, alpha=1.0):
    return _tF.celu(x, alpha)


@uncast
def silu(x):
    return _tF.silu(x)


swish = silu


@uncast
def mish(x):
    return x * torch.tanh(_tF.softplus(x))


@uncast
def leaky_relu(x, negative_slope=0.01):
    return _tF.leaky_relu(x, negative_slope)


@uncast
def prelu(x, weight, data_format='NCHW'):
    """where(x > 0, x, x * w), a weight of more than one element laid
    along the channel axis (1 for NC*, the last otherwise)."""
    if weight.numel() > 1 and x.dim() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith('NC') else -1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, x * weight)


@uncast
def softplus(x, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.logaddexp(scaled, torch.zeros_like(x)) / beta)


@uncast
def softsign(x):
    return x / (1 + x.abs())


@uncast
def hardsigmoid(x):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@uncast
def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@uncast
def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@uncast
def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@uncast
def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@uncast
def tanhshrink(x):
    return x - tanh(x)


@uncast
def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


@uncast
def log_sigmoid(x):
    return _tF.logsigmoid(x)


@uncast
def maxout(x, groups, axis=1):
    """The max over `groups` consecutive channels of `axis`."""
    axis %= x.dim()
    shape = list(x.shape)
    shape[axis] //= groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(axis + 1)


@uncast
def log_softmax(x, axis=-1):
    """jax.nn.log_softmax over `axis`, in x's dtype."""
    return _log_softmax(x, axis)


# ---- batch norm (nn_ops.py:268-319) -----------------------------------------
_CHANNELS_LAST = ('NLC', 'NHWC', 'NDHWC')


@uncast
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format='NCHW', use_global_stats=None):
    """Parity: operators/batch_norm_op. In training (and not
    `use_global_stats`) x is normalised by its batch statistics over
    every axis but the channel's, taken in fp32, and the running
    statistics are updated in place as the reference updates them:
    running = momentum * running + (1 - momentum) * batch, with the
    BIASED batch variance (torch's own update takes the unbiased one and
    `momentum` as the share taken, so it is not used). The recompute of
    a remat checkpoint leaves them alone, so they move once a step under
    every policy. Otherwise x is normalised by the running statistics.

    The normalisation is ATen's batch norm, which computes in fp32 and
    rounds once to x's dtype; the reference normalises a bf16 x in bf16
    with its fp32 statistics rounded down (:313), so bf16 outputs differ
    by a few bf16 roundings (tests/test_torch_vision_ops.py states the
    bar). A low-precision weight and bias are widened to fp32 for it."""
    last = data_format in _CHANNELS_LAST and x.dim() > 2
    if last:
        x = x.movedim(-1, 1)
    pdt = torch.float32 if x.dtype in _HALF else x.dtype
    w = None if weight is None else weight.to(pdt)
    b = None if bias is None else bias.to(pdt)
    if training and not use_global_stats:
        out, mean, invstd = torch.native_batch_norm(
            x, w, b, None, None, True, 0.0, epsilon)
        if running_mean is not None and not _remat.in_recompute():
            _update_running(running_mean, running_var, mean, invstd,
                            momentum, epsilon)
    else:
        out = _tF.batch_norm(x, running_mean.to(pdt), running_var.to(pdt),
                             w, b, False, 0.0, epsilon)
    return out.movedim(1, -1) if last else out


def _update_running(running_mean, running_var, mean, invstd, momentum,
                    epsilon):
    """The reference's update (:284-289) from ATen's saved batch mean and
    1 / sqrt(var + eps); the biased variance is recovered in float64."""
    with torch.no_grad():
        var = (invstd.double().pow(-2) - epsilon).to(running_var.dtype)
        mean = mean.detach().to(running_mean.dtype)
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)


# ---- convolution (nn_ops.py:412-497) ----------------------------------------
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _conv_padding(padding, nd=2):
    """'SAME' / 'VALID', or one (low, high) pair a spatial dimension
    from an int, a list of nd ints or a list of 2·nd ints (:418-428)."""
    if isinstance(padding, str):
        pad = padding.upper()
        if pad not in ('SAME', 'VALID'):
            raise ValueError(f'bad padding {padding!r}')
        return pad
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd:
        return [tuple(p) if isinstance(p, (list, tuple)) else (p, p)
                for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    raise ValueError(f'bad padding {padding}')


def _explicit_pads(pad, spatial, k, stride, dilation):
    """(low, high) a spatial dimension. 'SAME' pads as XLA does: the
    output is ceil(in / stride) and an odd total puts the extra row at
    the high end."""
    if pad == 'VALID':
        return [(0, 0)] * len(spatial)
    if pad != 'SAME':
        return list(pad)
    pads = []
    for d, kk, s, dl in zip(spatial, k, stride, dilation):
        out = -(-d // s)
        total = max((out - 1) * s + (kk - 1) * dl + 1 - d, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads):
    """`F.pad`'s list: the last dimension first, low then high."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _conv_nd(x, weight, bias, stride, pad, dilation, groups, nd):
    x, weight = _promoted(x, weight)
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    pads = _explicit_pads(pad, x.shape[2:], weight.shape[2:], stride,
                          dilation)
    conv = (_tF.conv1d, _tF.conv2d, _tF.conv3d)[nd - 1]
    if all(lo == hi >= 0 for lo, hi in pads):
        out = conv(x, weight, None, stride, [lo for lo, _ in pads],
                   dilation, groups)
    else:
        out = conv(_tF.pad(x, _torch_pad(pads)), weight, None, stride, 0,
                   dilation, groups)
    if bias is not None:
        # added after the convolution, in its dtype (:454-458)
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


_LAYOUTS = {1: ('NCL', 'NLC'), 2: ('NCHW', 'NHWC'), 3: ('NCDHW', 'NDHWC')}


def _channels_last(data_format, nd):
    """Whether `data_format` puts the channels last (NLC, NHWC, NDHWC);
    any other name than the two of its rank raises."""
    first, last = _LAYOUTS[nd]
    if data_format not in (first, last):
        raise ValueError(f'data_format must be {first!r} or {last!r}, got '
                         f'{data_format!r}')
    return data_format == last


def _channels_first(x, last):
    """x with its channels at axis 1: a channels-last x permuted, not
    copied (an NHWC tensor seen as NCHW is torch's channels_last memory
    format, which cuDNN convolves and pools without a layout transform)."""
    return x.movedim(-1, 1) if last else x


def _restore(out, last):
    return out.movedim(1, -1) if last else out


def _conv1d_args(padding, stride, dilation):
    """The reference's conv1d arguments (:462-474): an int or the first
    entry of a list pads both ends; a list's first stride and dilation."""
    if not isinstance(padding, str):
        p = padding if isinstance(padding, int) else padding[0]
        padding = [(p, p)]
    stride = stride if isinstance(stride, int) else stride[0]
    dilation = dilation if isinstance(dilation, int) else dilation[0]
    return _conv_padding(padding, 1), stride, dilation


@uncast
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCHW'):
    """Parity: operators/conv_op (:431-459): x [N, C, H, W] (NCHW) or
    [N, H, W, C] (NHWC), weight [O, C/groups, kh, kw] in either layout,
    as PaddlePaddle's (the reference asks for an HWIO weight in NHWC,
    :439, and raises on Paddle's). Padding is an int, a per-dimension
    list, a 2·nd list of (low, high), or 'SAME' / 'VALID'; an asymmetric
    padding (XLA's 'SAME' at stride > 1 among them) is applied with
    `F.pad` before the convolution. The output has x's dtype and layout;
    the bias is added after the convolution."""
    last = _channels_last(data_format, 2)
    return _restore(_conv_nd(_channels_first(x, last), weight, bias, stride,
                             _conv_padding(padding), dilation, groups, 2),
                    last)


@uncast
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCL'):
    """Parity: :462-474, x [N, C, L] (NCL) or [N, L, C] (NLC, which the
    reference refuses), weight [O, C/groups, k]: an int or the first
    entry of a list pads both ends."""
    last = _channels_last(data_format, 1)
    pad, stride, dilation = _conv1d_args(padding, stride, dilation)
    return _restore(_conv_nd(_channels_first(x, last), weight, bias, stride,
                             pad, dilation, groups, 1), last)


@uncast
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCDHW'):
    """Parity: :477-497, x [N, C, D, H, W] (NCDHW) or [N, D, H, W, C]
    (NDHWC, which the reference reads as NCDHW), weight [O, C/groups,
    kd, kh, kw]."""
    last = _channels_last(data_format, 3)
    return _restore(_conv_nd(_channels_first(x, last), weight, bias, stride,
                             _conv_padding(padding, 3), dilation, groups,
                             3), last)


# ---- transposed convolution (nn_ops.py:500-530, :1515-1595) ----------------
def _transpose_pads(padding, nd, k, stride, dilation):
    """(low, high) a spatial dimension of a transposed convolution: an
    int, a per-dimension list or a 2·nd list of pairs as the forward
    convolution's; 'VALID' none; 'SAME' PaddlePaddle's, a total of
    max(dilation·(k - 1) + 1 - stride, 0) so that out = in·stride."""
    pad = _conv_padding(padding, nd)
    if pad == 'VALID':
        return [(0, 0)] * nd
    if pad == 'SAME':
        pads = []
        for kk, s, d in zip(k, stride, dilation):
            total = max(d * (kk - 1) + 1 - s, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    return list(pad)


def _output_padding(in_sizes, k, stride, pads, dilation, opad, output_size):
    """output_padding from a requested output_size (:1515-1535): the
    difference from the size without it, which must lie in
    [0, stride)."""
    if output_size is None:
        return opad
    sizes = [output_size] * len(in_sizes) if isinstance(output_size, int) \
        else [int(v) for v in output_size]
    out = []
    for d, kk, st, (lo, hi), dil, want in zip(in_sizes, k, stride, pads,
                                              dilation, sizes):
        base = (int(d) - 1) * st - lo - hi + dil * (kk - 1) + 1
        extra = int(want) - base
        if not 0 <= extra < st:
            raise ValueError(
                f'output_size {want} unreachable: base {base}, stride {st} '
                f'(need base <= output_size < base+stride)')
        out.append(extra)
    return tuple(out)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, output_size, nd):
    """x [N, Cin, *in] channels first, weight [Cin, Cout/groups, *k]
    (PaddlePaddle's and torch's layout, grouped natively)."""
    x, weight = _promoted(x, weight)
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    k = tuple(weight.shape[2:])
    pads = _transpose_pads(padding, nd, k, stride, dilation)
    opad = _output_padding(x.shape[2:], k, stride, pads, dilation,
                           _pair(output_padding, nd), output_size)
    conv = (_tF.conv_transpose1d, _tF.conv_transpose2d,
            _tF.conv_transpose3d)[nd - 1]
    if all(lo == hi for lo, hi in pads):
        out = conv(x, weight, None, stride, [lo for lo, _ in pads], opad,
                   groups, dilation)
    else:
        # a transposed convolution's padding crops its full output
        out = conv(x, weight, None, stride, 0, opad, groups, dilation)
        out = out[(slice(None), slice(None)) + tuple(
            slice(lo, n - hi) for (lo, hi), n in zip(pads, out.shape[2:]))]
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


@uncast
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format='NCHW'):
    """Parity: operators/conv_transpose_op (:500-530): x NCHW or NHWC,
    weight [C_in, C_out/groups, kh, kw] in either layout; `output_size`
    picks the output_padding. Grouped transposes regroup the weight as
    PaddlePaddle does (the reference's regroup is disabled and its
    groups > 1 raises)."""
    last = _channels_last(data_format, 2)
    return _restore(_conv_transpose_nd(
        _channels_first(x, last), weight, bias, stride, padding,
        output_padding, dilation, groups, output_size, 2), last)


@uncast
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCL'):
    """Parity: :1538-1559, x NCL or NLC, weight [C_in, C_out/groups, k]."""
    last = _channels_last(data_format, 1)
    return _restore(_conv_transpose_nd(
        _channels_first(x, last), weight, bias, stride, padding,
        output_padding, dilation, groups, output_size, 1), last)


@uncast
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCDHW'):
    """Parity: :1562-1595, x NCDHW or NDHWC, weight [C_in, C_out/groups,
    kd, kh, kw]."""
    last = _channels_last(data_format, 3)
    return _restore(_conv_transpose_nd(
        _channels_first(x, last), weight, bias, stride, padding,
        output_padding, dilation, groups, output_size, 3), last)


# ---- 2-D pooling (nn_ops.py:542-652) ----------------------------------------
def _pool_pads(padding, k, s, spatial, ceil_mode):
    """((low, high) a dimension, 'SAME' or None). With `ceil_mode` the
    high side grows as the reference's 1-D and 3-D pools grow it
    (`_pool_nd`, :1400-1437): out = ceil((d + low + high - k) / s) + 1
    windows, high = max((out - 1)·s + k - d - low, high). PaddlePaddle
    honours `ceil_mode` in 2-D too; the reference's 2-D pools ignore it
    (ROADMAP Queue 3)."""
    pad = _conv_padding(padding)
    pads = _explicit_pads(pad, spatial, k, s, (1, 1))
    if ceil_mode and pad != 'SAME':
        pads = [(lo, max(-(-(d + lo + hi - kk) // st) * st + kk - d - lo, hi))
                for (lo, hi), d, kk, st in zip(pads, spatial, k, s)]
    return pads, (pad if isinstance(pad, str) else None)


def _native_pads(pads, k):
    """The symmetric padding torch's pools take (at most half the
    window), else None."""
    if all(lo == hi and 0 <= lo <= kk // 2 for (lo, hi), kk in zip(pads, k)):
        return [lo for lo, _ in pads]
    return None


@uncast
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCHW'):
    """Parity: :569-615, x NCHW or NHWC (the reference pools an NHWC x
    over W and C, :543-600); the padding pads with -inf. With
    `return_mask`, also the int32 flat index into each channel's H·W map
    of every window's maximum (the first, in window order, on ties), in
    x's layout."""
    last = _channels_last(data_format, 2)
    res = _max_pool2d(_channels_first(x, last), kernel_size, stride,
                      padding, return_mask, ceil_mode)
    if return_mask:
        return _restore(res[0], last), _restore(res[1], last)
    return _restore(res, last)


def _max_pool2d(x, kernel_size, stride, padding, return_mask, ceil_mode):
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    pads, named = _pool_pads(padding, k, s, x.shape[2:], ceil_mode)
    if return_mask and named is not None:
        raise NotImplementedError(
            'max_pool2d(return_mask=True) needs explicit padding')
    native = _native_pads(pads, k)
    if native is not None:
        res = _tF.max_pool2d(x, k, s, native, return_indices=return_mask)
    else:
        res = _tF.max_pool2d(
            _tF.pad(x, _torch_pad(pads), value=-math.inf), k, s, 0,
            return_indices=return_mask)
    if not return_mask:
        return res
    out, idx = res
    if native is None:
        # flat indices of the padded map back to the unpadded one
        wp = x.shape[3] + pads[1][0] + pads[1][1]
        idx = (idx // wp - pads[0][0]) * x.shape[3] + idx % wp - pads[1][0]
    return out, idx.to(torch.int32)


@uncast
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCHW'):
    """Parity: :542-566. The padding pads with zeros; `exclusive` divides
    each window's sum by its count of real (unpadded) cells, except under
    'SAME', which divides by the window's size as the reference does;
    `divisor_override` divides every sum by itself. x is NCHW or NHWC
    (pooled over H and W in either)."""
    last = _channels_last(data_format, 2)
    return _restore(_avg_pool2d(_channels_first(x, last), kernel_size,
                                stride, padding, ceil_mode, exclusive,
                                divisor_override), last)


def _avg_pool2d(x, kernel_size, stride, padding, ceil_mode, exclusive,
                divisor_override):
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    pads, named = _pool_pads(padding, k, s, x.shape[2:], ceil_mode)
    by_count = exclusive and named != 'SAME' and any(
        lo or hi for lo, hi in pads)
    native = _native_pads(pads, k)
    if native is not None:
        return _tF.avg_pool2d(x, k, s, native, count_include_pad=not by_count,
                              divisor_override=divisor_override)
    flat = _torch_pad(pads)
    summed = _tF.avg_pool2d(_tF.pad(x, flat), k, s, 0, divisor_override=1)
    if divisor_override:
        return summed / divisor_override
    if not by_count:
        return summed / (k[0] * k[1])
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = _tF.avg_pool2d(_tF.pad(ones, flat), k, s, 0, divisor_override=1)
    return summed / counts.clamp(min=1)


def _output_hw(output_size, x):
    oh, ow = _pair(output_size)
    return (x.shape[2] if oh is None else oh,
            x.shape[3] if ow is None else ow)


@uncast
def adaptive_avg_pool2d(x, output_size, data_format='NCHW'):
    """Parity: :618-642: window i of a dimension d covers
    [floor(i·d / out), ceil((i + 1)·d / out)), as torch's does; a None
    size keeps the input's. x is NCHW or NHWC."""
    last = _channels_last(data_format, 2)
    x = _channels_first(x, last)
    return _restore(_tF.adaptive_avg_pool2d(x, _output_hw(output_size, x)),
                    last)


@uncast
def adaptive_max_pool2d(x, output_size, return_mask=False):
    """Parity: :645-652, with the mask of `max_pool2d`. The reference
    raises on a size that does not divide the input; the port takes
    PaddlePaddle's floor/ceil windows there, as `adaptive_avg_pool2d`
    and the reference's own 1-D and 3-D adaptive pools do (ROADMAP
    Queue 3)."""
    res = _tF.adaptive_max_pool2d(x, _output_hw(output_size, x),
                                  return_indices=return_mask)
    if not return_mask:
        return res
    return res[0], res[1].to(torch.int32)


@uncast
def flatten(x, start_axis=0, stop_axis=-1):
    """Parity: manip.py:92-99."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)
