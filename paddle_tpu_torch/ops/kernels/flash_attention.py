"""Flash attention on the packed [B, L, H*D] layout — counterpart of
`paddle_tpu/ops/pallas/flash_attention.py`: its packed forward, dQ and
dK/dV bodies (`_flash_fwd_kernel_packed`, :278;
`_flash_bwd_dq_kernel_packed`, :336; `_flash_bwd_dkv_kernel_packed`,
:390) under the `_flash_attn_packed` custom VJP (:797), and the entries
`flash_attention_packed` (:821) and `causal_attention` (:865) on its
packed route (:909-920).

`FlashAttnPackedFunction` runs the forward (o and the per-row logsumexp
lse [B, L, H] fp32, saved for the backward) and the two-pass backward
from lse and delta = rowsum(dO * O) per head (computed here in plain
PyTorch, as JAX computes it outside its kernels, :560-561). Both
directions dispatch by device: CUDA tensors launch the hand-written
kernels in `csrc/flash_attention.cu`, CPU tensors run
`flash_attention_packed_plain` and `flash_attention_packed_bwd_plain`,
which materialise the [B, H, L, L] scores and compute the same function
in one step (the online softmax's exact-arithmetic equivalent).

Numerics are the Pallas bodies': the forward scales q BEFORE the dot,
both backward passes scale the dot AFTER it; the optional [B, L_k] fp32
key bias is added, then causal entries are set to -1e30 (NEG_INF, :40);
l_safe = max(l, 1e-30); o is written in q's dtype. The gradient of the
key bias is zeros (:815). The BHLD and dropout-fused kernels are not
ported yet: `causal_attention(dropout > 0)` raises.
"""
import math

import torch

from . import _build

FWD_KERNEL = 'flash_fwd'
DQ_KERNEL = 'flash_bwd_dq'
DKV_KERNEL = 'flash_bwd_dkv'
for _k in (FWD_KERNEL, DQ_KERNEL, DKV_KERNEL):
    _build.register(_k)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)        # csrc/flash_attention.cu instantiations


def _heads(t, H, D):
    """[B, L, H*D] -> fp32 [B, H, L, D]."""
    B, L, _ = t.shape
    return t.reshape(B, L, H, D).transpose(1, 2).float()


def _packed(t, dtype):
    """fp32 [B, H, L, D] -> [B, L, H*D] in `dtype`."""
    B, H, L, D = t.shape
    return t.transpose(1, 2).reshape(B, L, H * D).to(dtype)


def _masked(s, bias, causal):
    """The key bias, then the causal mask, on scores [B, H, Lq, Lk]."""
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if causal:
        Lq, Lk = s.shape[-2:]
        keep = torch.ones(Lq, Lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def attention_delta(o, do, num_heads, head_dim):
    """delta = rowsum(dO * O) per head: fp32 [B, L, H]."""
    B, L, _ = o.shape
    return (do.float() * o.float()).reshape(
        B, L, num_heads, head_dim).sum(-1)


def flash_attention_packed_plain(q, k, v, num_heads, head_dim, bias=None,
                                 causal=False):
    """Plain PyTorch forward: (o [B, L, H*D] in q's dtype, lse [B, L, H]
    fp32)."""
    H, D = num_heads, head_dim
    scale = 1.0 / math.sqrt(D)
    s = torch.matmul(_heads(q, H, D) * scale, _heads(k, H, D).transpose(-1, -2))
    s = _masked(s, bias, causal)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, _heads(v, H, D)) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1).transpose(1, 2)
    return _packed(o, q.dtype), lse.contiguous()


def flash_attention_packed_bwd_plain(q, k, v, o, lse, do, num_heads,
                                     head_dim, bias=None, causal=False):
    """Plain PyTorch backward from the forward's lse: (dq, dk, dv) in
    q's, k's and v's dtypes."""
    H, D = num_heads, head_dim
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh, doh = (_heads(t, H, D) for t in (q, k, v, do))
    s = _masked(torch.matmul(qh, kh.transpose(-1, -2)) * scale, bias, causal)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = attention_delta(o, do, H, D).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    dq = scale * torch.matmul(ds, kh)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    return _packed(dq, q.dtype), _packed(dk, k.dtype), _packed(dv, v.dtype)


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


def _fwd_kernel(q, k, v, bias, num_heads, head_dim, causal):
    code = _check(q, k, v, bias, num_heads, head_dim, FWD_KERNEL)
    B, L, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, L, num_heads, dtype=torch.float32, device=q.device)
    if B * L == 0:
        return o, lse
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
    do = do.contiguous()
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


def flash_attention_packed(q, k, v, num_heads, head_dim, bias=None,
                           causal=False):
    """q/k/v [B, L, H*D] -> [B, L, H*D]; bias optional [B, L_k] additive
    key bias (taken in fp32). Differentiable in q, k and v."""
    if bias is not None:
        bias = bias.float().contiguous()
    return FlashAttnPackedFunction.apply(q, k, v, bias, num_heads, head_dim,
                                         causal)


def causal_attention(qkv, num_heads, head_dim, dropout=0.0):
    """GPTAttention's entry: qkv [B, L, nh*3*hd] in the (head, 3, hd)
    Megatron packing -> context [B, L, nh*hd], on the packed route. JAX
    passes a zero key bias there; adding zeros changes nothing, so no
    bias is passed."""
    if dropout:
        raise NotImplementedError(
            'causal_attention with attention dropout > 0 needs the '
            'dropout-fused BHLD flash kernels, which are not ported yet '
            '(slice 4)')
    B, L, _ = qkv.shape
    x = qkv.reshape(B, L, num_heads, 3, head_dim)
    q, k, v = (t.reshape(B, L, num_heads * head_dim) for t in x.unbind(3))
    return flash_attention_packed(q, k, v, num_heads, head_dim, causal=True)
