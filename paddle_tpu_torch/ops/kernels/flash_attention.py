"""Flash attention — counterpart of `paddle_tpu/ops/pallas/flash_attention.py`
on both of its layouts.

Packed [B, L, H*D]: its forward, dQ and dK/dV bodies
(`_flash_fwd_kernel_packed`, :278; `_flash_bwd_dq_kernel_packed`, :336;
`_flash_bwd_dkv_kernel_packed`, :390) under the `_flash_attn_packed`
custom VJP (:797), and the entries `flash_attention_packed` (:821),
`mha_flash_attention_blhd` (:833) and `causal_attention` (:865) on its
packed route (:909-920).
`FlashAttnPackedFunction` runs the forward (o and the per-row logsumexp
lse [B, L, H] fp32, saved for the backward) and the two-pass backward
from lse and delta = rowsum(dO * O) per head (computed here in plain
PyTorch, as JAX computes it outside its kernels, :560-561).

BHLD [B*H, L, D]: its bodies `_flash_fwd_kernel` (:68),
`_flash_bwd_dq_kernel` (:137) and `_flash_bwd_dkv_kernel` (:191) as
`_flash_forward` (:455) and `_flash_backward` (:614), with an optional
[B, L_k] key bias (program b*H + h reads row b, `_bias_spec` :258) and
an optional one-byte [B*H, L, L] attention-dropout keep mask (bool or
int8; nonzero = kept) whose kept probabilities are scaled by
inv_keep = fp32(1 / (1 - p)) in the P·V product and in dP, while the
softmax normalizer sums the undropped probabilities (:119-127). Under
`FlashAttnFunction` they serve the custom VJPs `flash_attention_bhld`
(:723), `_flash_attn_dropout` (:748; the mask gets no gradient) and
`_flash_attn_biased` (:773; the bias gradient is zeros, :788), and
through them `flash_attention` (:852), `mha_flash_attention` (:933) and
`causal_attention(dropout > 0)` (:881-908): GPT training with attention
dropout, its keep mask drawn from the bound generator
(`core.rng.keep_mask`) where the reference draws it.

Every entry dispatches by device: CUDA tensors launch the hand-written
kernels in `csrc/flash_attention.cu` (bf16 forward, dQ and dK/dV on
the tensor cores, which round P keep and dS to bf16 before the products
that consume them; every fp32 pass on the CUDA cores), CPU tensors run
the plain versions
(`flash_attention_packed_plain`/`_bwd_plain`, `flash_forward_plain`/
`flash_backward_plain`), which materialise the scores and compute the
same function in one step (the online softmax's exact-arithmetic
equivalent).

Numerics are the Pallas bodies': the forward scales q BEFORE the dot,
both backward passes scale the dot AFTER it; the optional fp32 key bias
is added, then causal entries are set to -1e30 (NEG_INF, :40); l_safe =
max(l, 1e-30); o is written in q's dtype. The gradient of the key bias
is zeros (:815, :788).
"""
import math

import torch

from ...amp import uncast
from ...core import rng as _rng
from . import _build

FWD_KERNEL = 'flash_fwd'
DQ_KERNEL = 'flash_bwd_dq'
DKV_KERNEL = 'flash_bwd_dkv'
BHLD_FWD_KERNEL = 'flash_bhld_fwd'
BHLD_DQ_KERNEL = 'flash_bhld_bwd_dq'
BHLD_DKV_KERNEL = 'flash_bhld_bwd_dkv'
for _k in (FWD_KERNEL, DQ_KERNEL, DKV_KERNEL, BHLD_FWD_KERNEL,
           BHLD_DQ_KERNEL, BHLD_DKV_KERNEL):
    _build.register(_k)
MASK_DTYPES = (torch.bool, torch.int8)   # the port's draw, JAX's mask8

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)        # csrc/flash_attention.cu instantiations


def attention_delta(o, do, num_heads, head_dim):
    """delta = rowsum(dO * O) per head: fp32 [B, L, H]."""
    B, L, _ = o.shape
    return (do.float() * o.float()).reshape(
        B, L, num_heads, head_dim).sum(-1)


def bhld_delta(o, do):
    """delta = rowsum(dO * O): fp32 [B*H, L] (:631-632)."""
    return (do.float() * o.float()).sum(-1).contiguous()


def _inv_keep(mask, dropout):
    """The keep factor's scale, 1 / (1 - p) (rounded to fp32 where used)."""
    return 1.0 / (1.0 - dropout) if mask is not None else 1.0


def _keep_factor(mask, dropout):
    """where(mask != 0, inv_keep, 0) in fp32 (:125, :180, :234)."""
    return (mask != 0).float() * _inv_keep(mask, dropout)


def _masked(s, bias, num_heads, causal):
    """The key bias (program bh reads row bh // num_heads), then the
    causal mask, on fp32 scores [B*H, Lq, Lk]."""
    if bias is not None:
        s = s + bias.float().repeat_interleave(num_heads, 0)[:, None, :]
    if causal:
        Lq, Lk = s.shape[-2:]
        keep = torch.ones(Lq, Lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_forward_plain(q, k, v, bias=None, num_heads=1, causal=True,
                        dropout_mask=None, dropout=0.0):
    """Plain PyTorch BHLD forward: (o [B*H, L, D] in q's dtype, lse
    [B*H, L] fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    s = _masked(s, bias, num_heads, causal)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    if dropout_mask is not None:
        p = p * _keep_factor(dropout_mask, dropout)
    o = torch.matmul(p, v.float()) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return o.to(q.dtype), lse


def flash_backward_plain(q, k, v, o, lse, do, bias=None, num_heads=1,
                         causal=True, dropout_mask=None, dropout=0.0):
    """Plain PyTorch BHLD backward from the forward's lse: (dq, dk, dv)
    in q's, k's and v's dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = _masked(torch.matmul(qf, kf.transpose(-1, -2)) * scale, bias,
                num_heads, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    pv = p
    if dropout_mask is not None:
        d = _keep_factor(dropout_mask, dropout)
        dp, pv = dp * d, p * d
    ds = p * (dp - bhld_delta(o, do)[..., None])
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(pv.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bhld(t, num_heads):
    """[B, L, H*D] -> [B*H, L, D] (a view where the strides allow)."""
    B, L, HD = t.shape
    D = HD // num_heads
    return t.reshape(B, L, num_heads, D).transpose(1, 2).reshape(
        B * num_heads, L, D)


def _packed(t, B):
    """[B*H, L, D] -> [B, L, H*D]."""
    BH, L, D = t.shape
    return t.reshape(B, BH // B, L, D).transpose(1, 2).reshape(
        B, L, BH // B * D)


def flash_attention_packed_plain(q, k, v, num_heads, head_dim, bias=None,
                                 causal=False):
    """Plain PyTorch forward: (o [B, L, H*D] in q's dtype, lse [B, L, H]
    fp32) — the BHLD plain forward on the heads laid out [B*H, L, D]."""
    B, L, _ = q.shape
    o, lse = flash_forward_plain(*(_bhld(t, num_heads) for t in (q, k, v)),
                                 bias, num_heads, causal)
    return _packed(o, B), lse.reshape(B, num_heads, L).transpose(
        1, 2).contiguous()


def flash_attention_packed_bwd_plain(q, k, v, o, lse, do, num_heads,
                                     head_dim, bias=None, causal=False):
    """Plain PyTorch backward from the forward's lse: (dq, dk, dv) in
    q's, k's and v's dtypes — the BHLD plain backward on [B*H, L, D]."""
    B, L, _ = q.shape
    grads = flash_backward_plain(
        *(_bhld(t, num_heads) for t in (q, k, v, o)),
        lse.transpose(1, 2).reshape(B * num_heads, L), _bhld(do, num_heads),
        bias, num_heads, causal)
    return tuple(_packed(g, B) for g in grads)


def _check(q, k, v, bias, num_heads, head_dim, name):
    B, L, HD = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'{name}: q, k and v must share one [B, L, H*D] '
                         f'shape, got {tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    if HD != num_heads * head_dim:
        raise ValueError(f'{name}: last dim {HD} != {num_heads} heads x '
                         f'{head_dim}')
    if head_dim not in HEAD_DIMS:
        raise ValueError(f'{name}: no kernel for head_dim {head_dim} '
                         f'(built for {HEAD_DIMS})')
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f'{name}: q, k and v must share a dtype')
    if bias is not None and (bias.shape != (B, L)
                             or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f'{name}: bias must be a contiguous fp32 [{B}, {L}]')
    _build.require_contiguous(name, q=q, k=k, v=v)
    return _build.dtype_code(q, name)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned16(t):
    """t, or a copy of it at a 16-byte aligned address: the bf16 kernels
    load their rows 16 bytes a thread (a view that starts inside its
    storage may not be aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_kernel(q, k, v, bias, num_heads, head_dim, causal):
    code = _check(q, k, v, bias, num_heads, head_dim, FWD_KERNEL)
    B, L, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, L, num_heads, dtype=torch.float32, device=q.device)
    if B * L == 0:
        return o, lse
    q, k, v = (_aligned16(t) for t in (q, k, v))
    _build.launch('ptt_flash_fwd', FWD_KERNEL, q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), _ptr(bias), o.data_ptr(),
                  lse.data_ptr(), B, L, num_heads, head_dim,
                  1.0 / math.sqrt(head_dim), int(bool(causal)), code)
    return o, lse


def _bwd_args(q, k, v, do, num_heads, head_dim, bias, causal):
    code = _check(q, k, v, bias, num_heads, head_dim, DQ_KERNEL)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError('flash backward: dO must match q in shape and dtype')
    B, L, _ = q.shape
    return (B, L, num_heads, head_dim, 1.0 / math.sqrt(head_dim),
            int(bool(causal)), code)


def _dq_kernel(q, k, v, bias, do, lse, delta, args):
    """The dQ kernel alone; `args` from _bwd_args, `do` and `delta`
    contiguous."""
    dq = torch.empty_like(q)
    _build.launch('ptt_flash_bwd_dq', DQ_KERNEL, q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), _ptr(bias), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args)
    return dq


def _dkv_kernel(q, k, v, bias, do, lse, delta, args):
    """The dK/dV kernel alone."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch('ptt_flash_bwd_dkv', DKV_KERNEL, q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), _ptr(bias), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), *args)
    return dk, dv


def _bwd_kernels(q, k, v, o, lse, do, num_heads, head_dim, bias, causal):
    args = _bwd_args(q, k, v, do, num_heads, head_dim, bias, causal)
    if q.shape[0] * q.shape[1] == 0:
        return tuple(torch.empty_like(t) for t in (q, k, v))
    q, k, v, do = (_aligned16(t.contiguous()) for t in (q, k, v, do))
    delta = attention_delta(o, do, num_heads, head_dim).contiguous()
    dq = _dq_kernel(q, k, v, bias, do, lse, delta, args)
    return (dq,) + _dkv_kernel(q, k, v, bias, do, lse, delta, args)


def flash_attention_packed_fwd(q, k, v, num_heads, head_dim, bias=None,
                               causal=False):
    """(o, lse): the forward kernel on CUDA tensors, its plain version on
    CPU tensors."""
    if _build.on_cpu(q, k, v):
        return flash_attention_packed_plain(q, k, v, num_heads, head_dim,
                                            bias, causal)
    return _fwd_kernel(q, k, v, bias, num_heads, head_dim, causal)


def flash_attention_packed_bwd(q, k, v, o, lse, do, num_heads, head_dim,
                               bias=None, causal=False):
    """(dq, dk, dv): the dQ and dK/dV kernels on CUDA tensors, the plain
    backward on CPU tensors."""
    if _build.on_cpu(q, k, v, do):
        return flash_attention_packed_bwd_plain(q, k, v, o, lse, do,
                                                num_heads, head_dim, bias,
                                                causal)
    return _bwd_kernels(q, k, v, o, lse, do, num_heads, head_dim, bias,
                        causal)


class FlashAttnPackedFunction(torch.autograd.Function):
    """The `_flash_attn_packed` custom VJP: saves q, k, v, the bias, o
    and lse; no [L, L] tensor survives the forward on the card."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, head_dim, causal):
        o, lse = flash_attention_packed_fwd(q, k, v, num_heads, head_dim,
                                            bias, causal)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.cfg = (num_heads, head_dim, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        num_heads, head_dim, causal = ctx.cfg
        dq, dk, dv = flash_attention_packed_bwd(q, k, v, o, lse, do,
                                                num_heads, head_dim, bias,
                                                causal)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None, None


@uncast
def flash_attention_packed(q, k, v, num_heads, head_dim, bias=None,
                           causal=False):
    """q/k/v [B, L, H*D] -> [B, L, H*D]; bias optional [B, L_k] additive
    key bias (taken in fp32). Differentiable in q, k and v."""
    if bias is not None:
        bias = bias.float().contiguous()
    return FlashAttnPackedFunction.apply(q, k, v, bias, num_heads, head_dim,
                                         causal)


# ---------------------------------------------------------------------------
# BHLD [B*H, L, D]: optional key bias, optional attention-dropout keep mask
# ---------------------------------------------------------------------------
def _check_bhld(q, k, v, bias, mask, num_heads, name):
    BH, L, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'{name}: q, k and v must share one [B*H, L, D] '
                         f'shape, got {tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    if D not in HEAD_DIMS:
        raise ValueError(f'{name}: no kernel for head_dim {D} '
                         f'(built for {HEAD_DIMS})')
    if num_heads < 1 or BH % num_heads:
        raise ValueError(f'{name}: {BH} programs are not a multiple of '
                         f'{num_heads} heads')
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f'{name}: q, k and v must share a dtype')
    B = BH // num_heads
    if bias is not None and (bias.shape != (B, L)
                             or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f'{name}: bias must be a contiguous fp32 [{B}, {L}]')
    if mask is not None and (mask.shape != (BH, L, L)
                             or mask.dtype not in MASK_DTYPES
                             or not mask.is_contiguous()):
        raise ValueError(f'{name}: the keep mask must be a contiguous '
                         f'one-byte [{BH}, {L}, {L}]')
    _build.require_contiguous(name, q=q, k=k, v=v)
    return _build.dtype_code(q, name)


def _bhld_args(q, num_heads, causal, mask, dropout):
    """The launch's trailing geometry and scalars: B, L, H, D, scale,
    inv_keep, causal."""
    BH, L, D = q.shape
    return (BH // num_heads, L, num_heads, D, 1.0 / math.sqrt(D),
            _inv_keep(mask, dropout), int(bool(causal)))


def _bhld_fwd_kernel(q, k, v, bias, mask, num_heads, causal, dropout):
    code = _check_bhld(q, k, v, bias, mask, num_heads, BHLD_FWD_KERNEL)
    BH, L, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(BH, L, dtype=torch.float32, device=q.device)
    if BH * L == 0:
        return o, lse
    q, k, v = (_aligned16(t) for t in (q, k, v))
    _build.launch('ptt_flash_bhld_fwd', BHLD_FWD_KERNEL, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                  _ptr(mask), o.data_ptr(), lse.data_ptr(),
                  *_bhld_args(q, num_heads, causal, mask, dropout), code)
    return o, lse


def _bhld_bwd_args(q, k, v, do, bias, mask, num_heads, causal, dropout):
    code = _check_bhld(q, k, v, bias, mask, num_heads, BHLD_DQ_KERNEL)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError('flash backward: dO must match q in shape and dtype')
    return _bhld_args(q, num_heads, causal, mask, dropout) + (code,)


def _bhld_dq_kernel(q, k, v, bias, mask, do, lse, delta, args):
    """The BHLD dQ kernel alone; `args` from _bhld_bwd_args, `do` and
    `delta` contiguous."""
    dq = torch.empty_like(q)
    _build.launch('ptt_flash_bhld_bwd_dq', BHLD_DQ_KERNEL, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                  _ptr(mask), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), *args)
    return dq


def _bhld_dkv_kernel(q, k, v, bias, mask, do, lse, delta, args):
    """The BHLD dK/dV kernel alone."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch('ptt_flash_bhld_bwd_dkv', BHLD_DKV_KERNEL, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                  _ptr(mask), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *args)
    return dk, dv


def _bhld_bwd_kernels(q, k, v, o, lse, do, bias, mask, num_heads, causal,
                      dropout):
    args = _bhld_bwd_args(q, k, v, do, bias, mask, num_heads, causal,
                          dropout)
    if q.shape[0] * q.shape[1] == 0:
        return tuple(torch.empty_like(t) for t in (q, k, v))
    q, k, v, do = (_aligned16(t.contiguous()) for t in (q, k, v, do))
    delta = bhld_delta(o, do)
    dq = _bhld_dq_kernel(q, k, v, bias, mask, do, lse, delta, args)
    return (dq,) + _bhld_dkv_kernel(q, k, v, bias, mask, do, lse, delta,
                                    args)


def _flash_forward(q, k, v, bias=None, num_heads=1, causal=True,
                   dropout_mask=None, dropout=0.0):
    """(o, lse): the BHLD forward kernel on CUDA tensors, its plain
    version on CPU tensors."""
    extra = [t for t in (bias, dropout_mask) if t is not None]
    if _build.on_cpu(q, k, v, *extra):
        return flash_forward_plain(q, k, v, bias, num_heads, causal,
                                   dropout_mask, dropout)
    return _bhld_fwd_kernel(q, k, v, bias, dropout_mask, num_heads, causal,
                            dropout)


def _flash_backward(q, k, v, o, lse, do, bias=None, num_heads=1,
                    causal=True, dropout_mask=None, dropout=0.0):
    """(dq, dk, dv): the BHLD dQ and dK/dV kernels on CUDA tensors, the
    plain backward on CPU tensors."""
    extra = [t for t in (bias, dropout_mask) if t is not None]
    if _build.on_cpu(q, k, v, do, *extra):
        return flash_backward_plain(q, k, v, o, lse, do, bias, num_heads,
                                    causal, dropout_mask, dropout)
    return _bhld_bwd_kernels(q, k, v, o, lse, do, bias, dropout_mask,
                             num_heads, causal, dropout)


class FlashAttnFunction(torch.autograd.Function):
    """The BHLD custom VJPs in one Function: saves q, k, v, the bias, the
    keep mask, o and lse (the mask is the only O(L^2) residual); the mask
    gets no gradient, the bias gets zeros."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, num_heads, causal, dropout):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = _flash_forward(q, k, v, bias, num_heads, causal, mask,
                                dropout)
        ctx.save_for_backward(q, k, v, bias, mask, o, lse)
        ctx.cfg = (num_heads, causal, dropout)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask, o, lse = ctx.saved_tensors
        num_heads, causal, dropout = ctx.cfg
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do.contiguous(), bias,
                                     num_heads, causal, mask, dropout)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None, None, None


@uncast
def flash_attention_bhld(q, k, v):
    """Causal, no bias, no dropout (:723): q/k/v [B*H, L, D]."""
    return FlashAttnFunction.apply(q, k, v, None, None, 1, True, 0.0)


def _flash_attn_dropout(rate, q, k, v, mask8):
    """Causal with the one-byte keep mask [B*H, L, L] at `rate` (:748)."""
    return FlashAttnFunction.apply(q, k, v, None, mask8, 1, True,
                                   float(rate))


def _flash_attn_biased(causal, num_heads, q, k, v, bias):
    """With a [B, L_k] key bias (:773), taken in fp32."""
    return FlashAttnFunction.apply(q, k, v, bias.float().contiguous(), None,
                                   num_heads, causal, 0.0)


@uncast
def flash_attention(q, k, v, bias=None, num_heads=1, causal=True):
    """Array-level entry (:852): q/k/v [B*H, L, D]; bias optional [B, L_k]
    additive key bias (B*H = B * num_heads). With no bias and not causal
    it runs the biased kernel with a zero bias, as the reference does."""
    if bias is None:
        if causal:
            return flash_attention_bhld(q, k, v)
        bias = torch.zeros(q.shape[0] // num_heads, k.shape[1],
                           dtype=torch.float32, device=q.device)
    return _flash_attn_biased(causal, num_heads, q, k, v, bias)


@uncast
def mha_flash_attention(q, k, v, key_bias=None, causal=False):
    """Tensor-level entry for multi-head attention (:933): q/k/v
    [B, nh, L, hd]; key_bias optional [B, L_k] additive. Returns
    [B, nh, L, hd]."""
    B, H, L, D = q.shape
    o = flash_attention(q.reshape(B * H, L, D),
                        k.reshape(B * H, k.shape[2], D),
                        v.reshape(B * H, v.shape[2], D), bias=key_bias,
                        num_heads=H, causal=causal)
    return o.reshape(B, H, L, D)


@uncast
def mha_flash_attention_blhd(q, k, v, key_bias=None, causal=False):
    """Tensor-level entry for nn.MultiHeadAttention's transpose-free
    route (:833): q/k/v [B, L, nh, hd] -> [B, L, nh, hd], through the
    packed [B, L, nh*hd] kernels (both reshapes are views of the
    projections' outputs; a non-contiguous input is copied by the
    reshape, a misaligned one by the kernel's wrapper). key_bias
    optional [B, L_k] additive; None is the reference's zero bias
    (:826), which adds nothing, so no bias is passed."""
    B, L, H, D = q.shape
    o = flash_attention_packed(*(t.reshape(B, t.shape[1], H * D)
                                 for t in (q, k, v)), H, D, bias=key_bias,
                               causal=causal)
    return o.reshape(B, L, H, D)


@uncast
def causal_attention(qkv, num_heads, head_dim, dropout=0.0):
    """GPTAttention's entry: qkv [B, L, nh*3*hd] in the (head, 3, hd)
    Megatron packing -> context [B, L, nh*hd].

    dropout == 0: the packed route. JAX passes a zero key bias there;
    adding zeros changes nothing, so no bias is passed.

    dropout > 0 (training): the dropout-fused BHLD route (:881-908). The
    keep mask [B, nh, L, L] is drawn here from the bound generator, where
    the reference draws its bernoulli mask with `dropout_key`; with no
    generator bound (the counterpart of a missing key) it raises
    RuntimeError, and a rate outside (0, 1) raises ValueError."""
    B, L, _ = qkv.shape
    x = qkv.reshape(B, L, num_heads, 3, head_dim)
    if dropout:
        if not 0.0 < dropout < 1.0:
            raise ValueError(f'attention dropout rate must be in [0, 1), '
                             f'got {dropout}')
        q, k, v = (x[:, :, :, i].transpose(1, 2).reshape(
            B * num_heads, L, head_dim) for i in range(3))
        keep = _rng.keep_mask((B, num_heads, L, L), 1.0 - dropout,
                              qkv.device)
        o = _flash_attn_dropout(dropout, q, k, v,
                                keep.reshape(B * num_heads, L, L))
        return o.reshape(B, num_heads, L, head_dim).transpose(1, 2).reshape(
            B, L, num_heads * head_dim)
    q, k, v = (t.reshape(B, L, num_heads * head_dim) for t in x.unbind(3))
    return flash_attention_packed(q, k, v, num_heads, head_dim, causal=True)
