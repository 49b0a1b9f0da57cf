"""Fused LayerNorm forward and backward — counterpart of
`paddle_tpu/ops/pallas/fused_norm.py` (its `_fwd_kernel`, :52, and
`_bwd_kernel`, :63, under the `fused_layer_norm` custom VJP, :138).

`layer_norm(x, weight, bias, eps)` normalises over the last axis with
weight and bias of x's dtype. When a gradient is needed it runs
`LayerNormFunction`, whose forward also keeps the fp32 mean and rstd
[rows] and whose backward computes dx, dw and db from them; otherwise
it runs the forward alone (serving pays for no statistics). Both
directions dispatch by device: CUDA tensors launch the hand-written
kernels in `csrc/fused_norm.cu`, CPU tensors run `layer_norm_fwd_plain`
and `layer_norm_bwd_plain`, the same functions in plain PyTorch.

Op order is the Pallas bodies': mean and variance in fp32 (two-pass),
normalise in fp32, cast to x's dtype, then `* w` and `+ b` in x's dtype;
dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) with
dxhat = dy * w in fp32; dw sums dy * xhat with xhat cast to x's dtype
and back, db sums dy, both in fp32 over all rows, and the Function
returns them cast to the weight's and the bias's dtype (fused_norm.py:
165-166).
"""
import torch

from . import _build

KERNEL = 'layer_norm'
BWD_KERNEL = 'layer_norm_bwd'
_build.register(KERNEL)
_build.register(BWD_KERNEL)

# csrc/fused_norm.cu's backward: a CTA of BWD_THREADS threads takes whole
# rows, a thread 16-byte vectors tid + BWD_THREADS k of each, k < K; rows
# of up to 1, 2 or 4 vectors a thread pass through a ring of 5 row buffers
# in shared memory (40 KB a CTA for each vector a thread), so 2, 2 and 1
# CTAs an SM; wider rows stream (K = 0), one CTA an SM, for any n below
# BWD_MAX_N (2n partial columns indexed in 32 bits).
BWD_THREADS = 256
BWD_CTAS_PER_SM = {1: 2, 2: 2, 4: 1, 0: 1}
BWD_MAX_N = 1 << 30


def layer_norm_bwd_grid(rows, n, dtype, sms):
    """(chunks, rows_per_chunk) of the backward kernel's first pass for
    [rows, n] of `dtype` on a card of `sms` SMs: about as many CTAs as are
    resident at once, each over a chunk of contiguous rows, its dw and db
    partial one row of the [chunks, 2n] fp32 scratch."""
    if n >= BWD_MAX_N:
        raise ValueError(f'layer_norm_bwd: rows of {n} elements exceed the '
                         f'kernel\'s limit of {BWD_MAX_N - 1}')
    vectors = -(-n // (16 // torch.empty((), dtype=dtype).element_size()))
    per_thread = -(-vectors // BWD_THREADS)
    k = next((k for k in (1, 2, 4) if per_thread <= k), 0)
    return _build.row_chunks(rows, BWD_CTAS_PER_SM[k] * sms, 2 * n * 4)


# csrc/fused_norm.cu's forward register body: CTAs of FWD_THREADS threads;
# a row takes W warps (1, 2, 4 or 8) and each lane K 16-byte vectors of it
# (up to FWD_LANE_VALUES values a lane, so rows up to n = 16384); a CTA
# walks blocks of 8 / W rows, at most FWD_CTAS_PER_SM[K] CTAs an SM (what
# its launch bounds keep resident); wider rows take the shared-memory body
# (W = 0), one CTA a row.
FWD_THREADS = 256
FWD_LANE_VALUES = 64
FWD_WARPS = (1, 2, 4, 8)
FWD_CTAS_PER_SM = {1: 6, 2: 4, 4: 2, 8: 1, 16: 1}


def layer_norm_fwd_plan(rows, n, dtype, sms):
    """(warps_per_row W, vecs_per_lane K, rows_per_block, ctas) of the
    forward kernel for [rows, n] of `dtype` on a card of `sms` SMs. When
    the rows give every SM FWD_CTAS_PER_SM[2] CTAs (a train step), two
    vectors a lane over the fewest warps that hold the row (4 warps at
    n = 2048 in bf16); with fewer rows (a decode step), one vector a lane
    over more warps, so each row's few lanes finish sooner. Rows wider
    than 8 warps of two vectors take 8 warps of the fewest vectors that
    hold them. CTAs: as many as stay resident, or one a block of rows.
    Lane l of a row takes the vectors l + 32 W k, k < K; CTA c takes the
    blocks c, c + ctas, ..., of rows_per_block rows each (group g of its
    warps row g of a block). W = 0 is the shared-memory body (one CTA a
    row)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    vectors = -(-n // vec)
    if vectors > 32 * FWD_WARPS[-1] * (FWD_LANE_VALUES // vec):
        return 0, 0, 1, rows

    def fewest(k):
        return next((w for w in FWD_WARPS if vectors <= 32 * w * k),
                    FWD_WARPS[-1])

    w = fewest(2)
    if vectors <= 32 or -(-rows * w // (FWD_THREADS // 32)) < \
            FWD_CTAS_PER_SM[2] * sms:
        w = fewest(1)
    k = next(k for k in (1, 2, 4, 8, 16) if vectors <= 32 * w * k)
    per = FWD_THREADS // 32 // w
    return w, k, per, min(-(-rows // per), FWD_CTAS_PER_SM[k] * sms)


def layer_norm_fwd_plain(x, weight, bias, eps):
    """Plain PyTorch LayerNorm over the last axis: (y, mean, rstd), the
    statistics fp32 [rows] (the kernel's reference, and the CPU
    route)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = ((xf - mean) * rstd).to(x.dtype)
    return out * weight + bias, mean.reshape(-1), rstd.reshape(-1)


def layer_norm_plain(x, weight, bias, eps):
    """The forward's output alone."""
    return layer_norm_fwd_plain(x, weight, bias, eps)[0]


def layer_norm_bwd_plain(x, weight, dy, mean, rstd):
    """Plain PyTorch LayerNorm backward from the saved statistics:
    (dx in x's dtype, dw fp32 [N], db fp32 [N])."""
    N = x.shape[-1]
    xf = x.reshape(-1, N).float()
    dyf = dy.reshape(-1, N).float()
    mean, rstd = mean.reshape(-1, 1), rstd.reshape(-1, 1)
    xhat = (xf - mean) * rstd
    dxhat = dyf * weight.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    xhat_c = xhat.to(x.dtype).float()
    return dx, (dyf * xhat_c).sum(0), dyf.sum(0)


def _check(x, weight, bias):
    N = x.shape[-1]
    if weight.shape != (N,) or bias.shape != (N,):
        raise ValueError(f'layer_norm: weight/bias must be [{N}], got '
                         f'{tuple(weight.shape)}/{tuple(bias.shape)}')
    if not (weight.dtype == bias.dtype == x.dtype):
        raise TypeError('layer_norm: x, weight and bias must share a dtype')
    _build.require_contiguous(KERNEL, x=x, weight=weight, bias=bias)
    return _build.dtype_code(x, KERNEL)


def _fwd_kernel(x, weight, bias, eps, with_stats):
    code = _check(x, weight, bias)
    N = x.shape[-1]
    rows = x.numel() // max(N, 1)
    y = torch.empty_like(x)
    mean = rstd = None
    if with_stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    if rows == 0 or N == 0:
        return y, mean, rstd
    warps, vecs, _per, ctas = layer_norm_fwd_plan(
        rows, N, x.dtype, _build.sm_count(x.device))
    _build.launch('ptt_layer_norm_fwd', KERNEL, x.device, x.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                  mean.data_ptr() if with_stats else None,
                  rstd.data_ptr() if with_stats else None, rows, N,
                  float(eps), warps, vecs, ctas, code)
    return y, mean, rstd


def _bwd_kernel(x, weight, dy, mean, rstd):
    code = _build.dtype_code(x, BWD_KERNEL)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError('layer_norm_bwd: dy must match x in shape and dtype')
    dy = dy.contiguous()
    N = x.shape[-1]
    rows = x.numel() // max(N, 1)
    dx = torch.empty_like(x)
    if rows == 0 or N == 0:
        zeros = torch.zeros(N, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    chunks, per = layer_norm_bwd_grid(rows, N, x.dtype,
                                      _build.sm_count(x.device))
    part = torch.empty(chunks, 2 * N, dtype=torch.float32, device=x.device)
    dw_db = torch.empty(2 * N, dtype=torch.float32, device=x.device)
    _build.launch('ptt_layer_norm_bwd', BWD_KERNEL, x.device, x.data_ptr(),
                  weight.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                  rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
                  dw_db.data_ptr(), rows, N, chunks, per, code, launches=2)
    return dx, dw_db[:N], dw_db[N:]


def layer_norm_bwd(x, weight, dy, mean, rstd):
    """(dx, dw fp32, db fp32): the backward kernel on CUDA tensors, its
    plain version on CPU tensors."""
    if _build.on_cpu(x, weight, dy, mean, rstd):
        return layer_norm_bwd_plain(x, weight, dy, mean, rstd)
    return _bwd_kernel(x, weight, dy, mean, rstd)


class LayerNormFunction(torch.autograd.Function):
    """The `fused_layer_norm` custom VJP: mean and rstd are the saved
    residuals; the backward recomputes no reduction of the forward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        if _build.on_cpu(x, weight, bias):
            y, mean, rstd = layer_norm_fwd_plain(x, weight, bias, eps)
        else:
            y, mean, rstd = _fwd_kernel(x, weight, bias, eps, True)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.out_dtypes = (weight.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, dy, mean, rstd)
        w_dtype, b_dtype = ctx.out_dtypes
        return dx, dw.to(w_dtype), db.to(b_dtype), None


def layer_norm(x, weight, bias, eps):
    """x [..., N]; weight, bias [N] of x's dtype. Differentiable in x,
    weight and bias."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, eps)
    if _build.on_cpu(x, weight, bias):
        return layer_norm_plain(x, weight, bias, eps)
    return _fwd_kernel(x, weight, bias, eps, False)[0]
