"""Fused bias + GELU and dropout + residual, forward and backward —
counterpart of `paddle_tpu/ops/pallas/fused_elementwise.py` (its
`_bg_fwd_kernel`, :64, and `_bg_bwd_kernel`, :69, under the `bias_gelu`
custom VJP, :86; its `_da_fwd_kernel`, :149, and `_da_bwd_kernel`,
:156, under the `dropout_add` custom VJP, :162).

`bias_gelu(x, bias, approximate)` computes gelu(x + bias) with the bias
cast to x's dtype first (fused_elementwise.py:105, :143), through
`BiasGeluFunction`, which saves x and the bias and whose backward
computes dx = dy * gelu'(x + b) and db, the fp32 sum of that over rows,
cast to the bias's dtype (:134). Both
directions dispatch by device: CUDA tensors launch the hand-written
kernels in `csrc/fused_elementwise.cu`, CPU tensors run
`bias_gelu_plain` and `bias_gelu_bwd_plain`.

Numerics: both routes add in x's dtype and evaluate the GELU (tanh form
with 0.044715 when `approximate`, the erf form otherwise — jax.nn.gelu's
two forms) and its derivative (`gelu_grad_f32`, the port's copy of
`_gelu_grad`, :48-58) in fp32; the forward rounds once to x's dtype. The
plain versions take each tanh, erf, erfc and exp from float64, rounded
once to fp32 (`_once`: torch's fp32 ones can err on their first call in
a process); the kernel's tanh form computes u / (1 + e^(-2z)), the same
function without the cancellation of 1 + tanh z. The JAX route rounds
inside bf16 arithmetic instead, so in bf16 the two agree to a few bf16
ulps (the tests hold them at 5e-2); in fp32 they agree to float
rounding.

`dropout_add(x, residual, keep, p)` computes where(keep, x / (1-p), 0)
rounded to x's dtype, plus the residual, through `DropoutAddFunction`,
which saves the keep mask; its backward gives dx = where(keep, dy /
(1-p), 0) and the residual's gradient dy itself (:195-207). Both
directions dispatch by device as `BiasGeluFunction` does. The keep mask
is drawn by the caller (`ops/nn_ops.dropout_add`) and stored as a torch
bool tensor, one byte an element, where the reference keeps an fp32 0/1
mask: "keep iff true" reads as its "keep iff > 0.5". On the gpt_1p3b
step the 48 saved masks then take 48 x 34 MB ~ 1.6 GB, where fp32 masks
would take ~6.4 GB. Numerics: as jnp does for a bf16 x divided by a
Python float, the divisor 1-p is rounded to x's dtype first, and the
quotient is rounded to x's dtype before the residual add; the plain
versions and the kernels agree bit for bit.
"""
import functools
import math

import torch

from . import _build

KERNEL = 'bias_gelu'
BWD_KERNEL = 'bias_gelu_bwd'
DA_KERNEL = 'dropout_add'
DA_BWD_KERNEL = 'dropout_add_bwd'
for _name in (KERNEL, BWD_KERNEL, DA_KERNEL, DA_BWD_KERNEL):
    _build.register(_name)

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)

# csrc/fused_elementwise.cu's backward: a CTA takes a column tile of
# BWD_TILE_VECS 16-byte vectors (one warp wide) over a chunk of rows; its
# launch bounds promise BWD_CTAS_PER_SM CTAs an SM
BWD_TILE_VECS = 32
BWD_CTAS_PER_SM = 4
# its forward: a CTA's FWD_TILE_VECS threads take one 16-byte vector each of
# a column tile over FWD_LOADS rows, all loads issued before the first is
# used (kThreads, kFwdLoads); its launch bounds promise FWD_CTAS_PER_SM CTAs
# an SM (kFwdCtasPerSm)
FWD_TILE_VECS = 256
FWD_LOADS = 4
FWD_CTAS_PER_SM = 4
MAX_GRID_Y = 65535


def _vectors(n, dtype):
    """16-byte vectors of `dtype` that a row of n elements spans."""
    return -(-n // (16 // dtype.itemsize))


def bias_gelu_bwd_grid(rows, n, dtype, sms):
    """(column tiles, chunks, rows_per_chunk) of the backward kernel's
    first pass for [rows, n] of `dtype` on a card of `sms` SMs: about as
    many CTAs as are resident at once, each over one column tile of a
    chunk of contiguous rows, the chunk's dbias one row of the [chunks, n]
    fp32 scratch."""
    tiles = -(-_vectors(n, dtype) // BWD_TILE_VECS)
    want = max(1, BWD_CTAS_PER_SM * sms // tiles)
    return (tiles, *_build.row_chunks(rows, want, n * 4))


@functools.lru_cache(maxsize=256)
def bias_gelu_fwd_grid(rows, n, dtype, sms):
    """(column tiles, chunks, rows_per_chunk) of the forward kernel for
    [rows, n] of `dtype` on a card of `sms` SMs. A thread owns one 16-byte
    vector of a row's columns over a chunk of rows. Rows too few to fill
    the card's resident CTAs one vector a thread (a decode step) take a
    chunk each: no row loop. Otherwise a chunk is FWD_LOADS rows, one trip
    of a CTA that then ends, so CTAs launched in order sweep memory as a
    copy does; more rows than 65535 such chunks hold lengthen the chunks."""
    tiles = -(-_vectors(n, dtype) // FWD_TILE_VECS)
    per = 1 if rows * tiles <= FWD_CTAS_PER_SM * sms else FWD_LOADS
    per = max(per, -(-rows // MAX_GRID_Y))
    return tiles, -(-rows // per), per


def _once(op, z):
    """op(z) evaluated in float64 and rounded once to z's dtype.

    torch 2.13.0+cpu (MKL) can return the fp32 tanh, erf, erfc and exp of
    the FIRST such call in a process wrong by up to a few 1e-4 on one
    intra-op thread's share of the elements (a race at the first call,
    seen in fresh processes with 4 to 64 threads); later calls, and the
    float64 ops on every call tried, are right to under an fp32 rounding.
    """
    return op(z.double()).to(z.dtype)


def gelu_f32(u, approximate):
    """jax.nn.gelu's two forms on an fp32 tensor, op for op, with the tanh
    and erfc each rounded once from float64 (`_once`)."""
    if approximate:
        inner = _SQRT_2_OVER_PI * (u + 0.044715 * (u * u * u))
        return u * (0.5 * (1.0 + _once(torch.tanh, inner)))
    return 0.5 * u * _once(torch.erfc, -u * math.sqrt(0.5))


def gelu_grad_f32(u, approximate):
    """d gelu(u) / du on an fp32 tensor, op for op as `_gelu_grad`, with
    the tanh, exp and erf each rounded once from float64 (`_once`)."""
    if approximate:
        c = _SQRT_2_OVER_PI
        inner = c * (u + 0.044715 * (u * u * u))
        t = _once(torch.tanh, inner)
        return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * c * \
            (1.0 + 3 * 0.044715 * (u * u))
    phi = _once(torch.exp, -0.5 * u * u) * (1.0 / math.sqrt(2.0 * math.pi))
    cdf = 0.5 * (1.0 + _once(torch.erf, u * (1.0 / math.sqrt(2.0))))
    return cdf + u * phi


def bias_gelu_plain(x, bias, approximate):
    """Plain PyTorch gelu(x + bias) (the kernel's reference, and the
    CPU route)."""
    u = (x + bias.to(x.dtype)).float()
    return gelu_f32(u, approximate).to(x.dtype)


def bias_gelu_bwd_plain(x, bias, dy, approximate):
    """Plain PyTorch backward: (dx in x's dtype, db fp32 [N])."""
    u = (x + bias.to(x.dtype)).float()
    du = dy.float() * gelu_grad_f32(u, approximate)
    return du.to(x.dtype), du.reshape(-1, x.shape[-1]).sum(0)


def _check(x, bias, name):
    N = x.shape[-1]
    if bias.shape != (N,):
        raise ValueError(f'{name}: bias must be [{N}], got '
                         f'{tuple(bias.shape)}')
    code = _build.dtype_code(x, name)
    _build.require_contiguous(name, x=x)
    if bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return code, bias.contiguous()


def _fwd_kernel(x, bias, approximate):
    code, b = _check(x, bias, KERNEL)
    N = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // max(N, 1)
    if rows == 0 or N == 0:
        return y
    _tiles, chunks, per = bias_gelu_fwd_grid(rows, N, x.dtype,
                                             _build.sm_count(x.device))
    _build.launch('ptt_bias_gelu_fwd', KERNEL, x.device, x.data_ptr(),
                  b.data_ptr(), y.data_ptr(), rows, N, chunks, per,
                  int(bool(approximate)), code)
    return y


def bias_gelu_fwd(x, bias, approximate):
    """y: the forward kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if _build.on_cpu(x, bias):
        return bias_gelu_plain(x, bias, approximate)
    return _fwd_kernel(x, bias, approximate)


def _bwd_kernel(x, bias, dy, approximate):
    code, b = _check(x, bias, BWD_KERNEL)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError('bias_gelu_bwd: dy must match x in shape and dtype')
    dy = dy.contiguous()
    N = x.shape[-1]
    rows = x.numel() // max(N, 1)
    dx = torch.empty_like(x)
    if rows == 0 or N == 0:
        return dx, torch.zeros(N, dtype=torch.float32, device=x.device)
    db = torch.empty(N, dtype=torch.float32, device=x.device)
    _tiles, chunks, per = bias_gelu_bwd_grid(rows, N, x.dtype,
                                             _build.sm_count(x.device))
    part = torch.empty(chunks, N, dtype=torch.float32, device=x.device)
    _build.launch('ptt_bias_gelu_bwd', BWD_KERNEL, x.device, x.data_ptr(),
                  b.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
                  db.data_ptr(), rows, N, chunks, per, int(bool(approximate)),
                  code, launches=2)
    return dx, db


def bias_gelu_bwd(x, bias, dy, approximate):
    """(dx, db fp32): the backward kernel on CUDA tensors, its plain
    version on CPU tensors."""
    if _build.on_cpu(x, bias, dy):
        return bias_gelu_bwd_plain(x, bias, dy, approximate)
    return _bwd_kernel(x, bias, dy, approximate)


class BiasGeluFunction(torch.autograd.Function):
    """The `bias_gelu` custom VJP: saves x and the bias; the backward
    recomputes u = x + b once."""

    @staticmethod
    def forward(ctx, x, bias, approximate):
        y = bias_gelu_fwd(x, bias, approximate)
        ctx.save_for_backward(x, bias)
        ctx.approximate = approximate
        return y

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        dx, db = bias_gelu_bwd(x, bias, dy, ctx.approximate)
        return dx, db.to(bias.dtype), None


def bias_gelu(x, bias, approximate):
    """x [..., N], bias [N]. Differentiable in x and bias; when no
    gradient is recorded (grad mode off, or neither input requires one)
    the forward runs without the autograd Function, whose bookkeeping
    costs a decode step more host time than the launch."""
    if torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad):
        return BiasGeluFunction.apply(x, bias, approximate)
    return bias_gelu_fwd(x, bias, approximate)


# ---------------------------------------------------------------------------
# dropout + residual add
# ---------------------------------------------------------------------------
def keep_scale(x, p):
    """1 - p as a 0-dim tensor of x's dtype on x's device: the divisor jnp
    uses for `x / (1.0 - p)` (a weak-typed scalar takes x's dtype)."""
    return torch.tensor(1.0 - p, dtype=torch.float32,
                        device=x.device).to(x.dtype)


def dropout_add_plain(x, residual, keep, p):
    """Plain PyTorch forward (the kernel's reference, and the CPU route):
    where(keep, x / (1-p), 0) in x's dtype, + residual."""
    dropped = torch.where(keep, x / keep_scale(x, p), torch.zeros_like(x))
    return dropped.to(x.dtype) + residual


def dropout_add_bwd_plain(keep, dy, p):
    """Plain PyTorch backward: dx = where(keep, dy / (1-p), 0)."""
    return torch.where(keep, dy / keep_scale(dy, p),
                       torch.zeros_like(dy)).to(dy.dtype)


def _check_keep(keep, like, name):
    if keep.dtype != torch.bool or keep.shape != like.shape:
        raise ValueError(f'{name}: keep must be a bool mask of shape '
                         f'{tuple(like.shape)}, got {keep.dtype} '
                         f'{tuple(keep.shape)}')


def _da_fwd_kernel(x, residual, keep, p):
    code = _build.dtype_code(x, DA_KERNEL)
    if residual.dtype != x.dtype or residual.shape != x.shape:
        raise ValueError('dropout_add: residual must match x in shape and '
                         'dtype')
    _check_keep(keep, x, DA_KERNEL)
    x, residual, keep = (t.contiguous() for t in (x, residual, keep))
    y = torch.empty_like(x)
    if x.numel():
        _build.launch('ptt_dropout_add_fwd', DA_KERNEL, x.device,
                      x.data_ptr(), residual.data_ptr(), keep.data_ptr(),
                      y.data_ptr(), x.numel(), 1.0 - p, code)
    return y


def _da_bwd_kernel(keep, dy, p):
    code = _build.dtype_code(dy, DA_BWD_KERNEL)
    _check_keep(keep, dy, DA_BWD_KERNEL)
    keep, dy = keep.contiguous(), dy.contiguous()
    dx = torch.empty_like(dy)
    if dy.numel():
        _build.launch('ptt_dropout_add_bwd', DA_BWD_KERNEL, dy.device,
                      keep.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                      dy.numel(), 1.0 - p, code)
    return dx


def dropout_add_fwd(x, residual, keep, p):
    """y: the forward kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if _build.on_cpu(x, residual, keep):
        return dropout_add_plain(x, residual, keep, p)
    return _da_fwd_kernel(x, residual, keep, p)


def dropout_add_bwd(keep, dy, p):
    """dx: the backward kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if _build.on_cpu(keep, dy):
        return dropout_add_bwd_plain(keep, dy, p)
    return _da_bwd_kernel(keep, dy, p)


class DropoutAddFunction(torch.autograd.Function):
    """The `dropout_add` custom VJP: saves the keep mask; the residual's
    gradient is the incoming gradient itself."""

    @staticmethod
    def forward(ctx, x, residual, keep, p):
        y = dropout_add_fwd(x, residual, keep, p)
        ctx.save_for_backward(keep)
        ctx.p = p
        return y

    @staticmethod
    def backward(ctx, dy):
        (keep,) = ctx.saved_tensors
        return dropout_add_bwd(keep, dy, ctx.p), dy, None, None


def dropout_add(x, residual, keep, p):
    """residual + upscale-dropout(x) with the caller's bool keep mask (of
    x's shape). Differentiable in x and the residual."""
    return DropoutAddFunction.apply(x, residual, keep, p)
