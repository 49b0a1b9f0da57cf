"""Math, reduction, comparison and logic ops — counterpart of
`paddle_tpu/ops/math.py`, with paddle's names and arguments.

The elementwise, unary and product ops are built by `common.binary`,
`unary` and `defop` under the reference's op names, so `amp.auto_cast`
casts them as it casts the reference's (`matmul` white-listed, `exp`
black-listed, ...); every other op stands for one `run_op` of the
reference and is `@uncast`. A Python scalar beside a tensor takes the
tensor's dtype (`common.as_tensor`).

Where the reference computes on the host with numpy (`mode`,
`nonzero`, `histogram`), the port computes on the device. Rules kept
from the reference: `median` of an even count is the mean of the two
middle values; `mode` breaks a tie towards the smallest value (the
first of `np.unique`'s counts); `std` and `var` are unbiased by default;
`quantile` interpolates linearly between the sorted values; `take`
clips its indices into range. Index outputs are int64 (the reference's
are int32 under JAX's default 32-bit mode).
"""
import builtins
import math as _math

import torch

from ..amp import uncast
from .common import (as_tensor, binary, convert_dtype, defop, register,
                     register_public, unary)

# ---- elementwise binary (operators/elementwise/) --------------------------
add = binary('elementwise_add', torch.add)
subtract = binary('elementwise_sub', torch.subtract)
multiply = binary('elementwise_mul', torch.multiply)
divide = binary('elementwise_div', torch.divide)
floor_divide = binary('elementwise_floordiv', torch.floor_divide)
remainder = binary('elementwise_mod', torch.remainder)
pow = binary('elementwise_pow', torch.pow)
maximum = binary('elementwise_max', torch.maximum)
minimum = binary('elementwise_min', torch.minimum)
fmax = binary('elementwise_fmax', torch.fmax)
fmin = binary('elementwise_fmin', torch.fmin)
atan2 = binary('atan2', torch.atan2)
hypot = binary('hypot', torch.hypot)

mod = remainder
floor_mod = remainder

# ---- unary math -----------------------------------------------------------
exp = unary('exp', torch.exp)
expm1 = unary('expm1', torch.expm1)
log = unary('log', torch.log)
log2 = unary('log2', torch.log2)
log10 = unary('log10', torch.log10)
log1p = unary('log1p', torch.log1p)
sqrt = unary('sqrt', torch.sqrt)
rsqrt = unary('rsqrt', torch.rsqrt)
square = unary('square', torch.square)
abs = unary('abs', torch.abs)
sign = unary('sign', torch.sign)
floor = unary('floor', torch.floor)
ceil = unary('ceil', torch.ceil)
round = unary('round', torch.round)
trunc = unary('trunc', torch.trunc)
reciprocal = unary('reciprocal', lambda x: 1.0 / x)
neg = unary('neg', torch.neg)
sin = unary('sin', torch.sin)
cos = unary('cos', torch.cos)
tan = unary('tan', torch.tan)
asin = unary('asin', torch.asin)
acos = unary('acos', torch.acos)
atan = unary('atan', torch.atan)
sinh = unary('sinh', torch.sinh)
cosh = unary('cosh', torch.cosh)
tanh = unary('tanh', torch.tanh)
asinh = unary('asinh', torch.asinh)
acosh = unary('acosh', torch.acosh)
atanh = unary('atanh', torch.atanh)
sigmoid = unary('sigmoid', torch.sigmoid)
erf = unary('erf', torch.erf)
lgamma = unary('lgamma', torch.lgamma)
digamma = unary('digamma', torch.digamma)


# ---- scale / clip / assign ------------------------------------------------
def _scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    return x * scale + bias if bias_after_scale else (x + bias) * scale


def _clip(x, min=None, max=None):
    return torch.clamp(x, min, max)


scale = defop('scale', _scale)
clip = defop('clip', _clip)
assign = defop('assign', lambda x: x + 0)
increment = defop('increment', lambda x, value=1.0: x + value)
stanh = defop('stanh', lambda x, scale_a=0.67, scale_b=1.7159:
              scale_b * torch.tanh(scale_a * x))


@uncast
def clip_by_norm(x, max_norm):
    x = as_tensor(x)
    norm = torch.sqrt(torch.sum(x * x))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


# ---- matmul family --------------------------------------------------------
def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


matmul = binary('matmul_v2', _matmul)
bmm = binary('bmm', torch.matmul)
mm = matmul
dot = binary('dot', lambda x, y: torch.sum(x * y, dim=-1))
inner = binary('inner', torch.inner)
outer = binary('outer', lambda x, y: torch.outer(x.reshape(-1),
                                                 y.reshape(-1)))
kron = binary('kron', torch.kron)
cross = binary('cross', lambda x, y, axis=-1: torch.linalg.cross(x, y,
                                                                  dim=axis))
mv = binary('mv', torch.matmul)


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return add(scale(as_tensor(input), beta), scale(matmul(x, y), alpha))


def multiply_(x, y):
    return multiply(x, y)


# ---- reductions (operators/reduce_ops/) -----------------------------------
def _axis(axis):
    """None, an int, or a tuple of ints (an empty list is None)."""
    if isinstance(axis, (list, tuple)):
        return tuple(axis) if len(axis) else None
    return axis


def _float_input(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _reduce(name, fn):
    @uncast
    def op(x, axis=None, keepdim=False, name=None):
        return fn(as_tensor(x), _axis(axis), keepdim)
    op.__name__ = name
    return register(name, op)


def _all_dims(x, axis):
    return tuple(range(x.dim())) if axis is None else axis


def _prod(x, axis, keepdim):
    if axis is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    dims = (axis,) if isinstance(axis, int) else axis
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


sum = _reduce('reduce_sum', lambda x, a, k: torch.sum(
    x, _all_dims(x, a), keepdim=k))
mean = _reduce('reduce_mean', lambda x, a, k: torch.mean(
    _float_input(x), _all_dims(x, a), keepdim=k))
max = _reduce('reduce_max', lambda x, a, k: torch.amax(
    x, _all_dims(x, a), keepdim=k))
min = _reduce('reduce_min', lambda x, a, k: torch.amin(
    x, _all_dims(x, a), keepdim=k))
prod = _reduce('reduce_prod', _prod)
amax = max
amin = min
nansum = _reduce('nansum', lambda x, a, k: torch.nansum(
    x, _all_dims(x, a), keepdim=k))
nanmean = _reduce('nanmean', lambda x, a, k: torch.nanmean(
    _float_input(x), _all_dims(x, a), keepdim=k))
logsumexp = _reduce('logsumexp', lambda x, a, k: torch.logsumexp(
    _float_input(x), _all_dims(x, a), keepdim=k))


def all(x, axis=None, keepdim=False, name=None):
    x = as_tensor(x)
    return torch.all(x, _all_dims(x, _axis(axis)), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    x = as_tensor(x)
    return torch.any(x, _all_dims(x, _axis(axis)), keepdim=keepdim)


@uncast
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = as_tensor(x)
    return torch.std(x, _axis(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@uncast
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = as_tensor(x)
    return torch.var(x, _axis(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _sorted_along(x, axis):
    """x sorted along `axis` moved last, or flattened when None."""
    if axis is None:
        return torch.sort(x.reshape(-1)).values
    return torch.sort(x.movedim(axis, -1), dim=-1).values


@uncast
def median(x, axis=None, keepdim=False, name=None):
    """The middle value along `axis` (all of x when None); for an even
    count the mean of the two middle values, as jnp.median (torch's
    median takes the lower one)."""
    x = as_tensor(x)
    s = _sorted_along(x, axis)
    n = s.shape[-1]
    if n % 2:
        out = s[..., n // 2]
    else:
        out = (s[..., n // 2 - 1] + s[..., n // 2]) / 2
    if keepdim:
        out = out.reshape((1,) * x.dim()) if axis is None \
            else out.unsqueeze(axis % x.dim())
    return out


@uncast
def quantile(x, q, axis=None, keepdim=False):
    """jnp.quantile's linear interpolation between the sorted values
    (torch.quantile refuses inputs of more than 2^24 elements); a 1-D q
    adds a leading axis."""
    x = as_tensor(x)
    s = _sorted_along(x, axis)
    n = s.shape[-1]
    qs = torch.as_tensor(q, dtype=torch.float64)
    outs = []
    for qi in qs.reshape(-1).tolist():
        pos = qi * (n - 1)
        lo = int(_math.floor(pos))
        hi = builtins.min(lo + 1, n - 1)
        frac = pos - lo
        out = s[..., lo] * (1 - frac) + s[..., hi] * frac if frac \
            else s[..., lo]
        if keepdim:
            out = out.reshape((1,) * x.dim()) if axis is None \
                else out.unsqueeze(axis % x.dim())
        outs.append(out)
    return torch.stack(outs) if qs.dim() else outs[0]


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis`, the smallest of them on a
    tie (the reference's np.unique counts), computed on the device: in
    each sorted row, the first position where a run of equal values
    reaches the row's longest run."""
    x = as_tensor(x)
    s = torch.sort(x.movedim(axis, -1), dim=-1).values
    n = s.shape[-1]
    pos = torch.arange(n, device=x.device).expand(s.shape)
    start = torch.ones(s.shape, dtype=torch.bool, device=x.device)
    start[..., 1:] = s[..., 1:] != s[..., :-1]
    run_start = torch.where(start, pos, torch.zeros_like(pos)).cummax(-1)
    run_len = pos - run_start.values + 1
    first = run_len.argmax(-1, keepdim=True)
    out = s.gather(-1, first).squeeze(-1)
    return out.unsqueeze(axis % x.dim()) if keepdim else out


# ---- cum ops --------------------------------------------------------------
def cumsum_(a, axis):
    return torch.cumsum(a, axis)


@uncast
def cumsum(x, axis=None, dtype=None, name=None):
    x = as_tensor(x)
    out = torch.cumsum(x.reshape(-1) if axis is None else x,
                       0 if axis is None else axis)
    return out if dtype is None else out.to(convert_dtype(dtype))


@uncast
def cumprod(x, dim=None, dtype=None, name=None):
    x = as_tensor(x)
    out = torch.cumprod(x.reshape(-1) if dim is None else x,
                        0 if dim is None else dim)
    return out if dtype is None else out.to(convert_dtype(dtype))


# ---- arg / sort / topk ----------------------------------------------------
def argmax(x, axis=None, keepdim=False, dtype='int64', name=None):
    x = as_tensor(x)
    out = torch.argmax(x, axis, keepdim=keepdim and axis is not None)
    return out.to(convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype='int64', name=None):
    x = as_tensor(x)
    out = torch.argmin(x, axis, keepdim=keepdim and axis is not None)
    return out.to(convert_dtype(dtype))


def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(as_tensor(x), dim=axis, descending=descending,
                         stable=True)


@uncast
def sort(x, axis=-1, descending=False, name=None):
    return torch.sort(as_tensor(x), dim=axis, descending=descending,
                      stable=True).values


@uncast
def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """Parity: operators/top_k_v2_op: (values, int64 indices) of the k
    largest (or smallest) along `axis` (the last when None)."""
    x = as_tensor(x)
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    res = torch.topk(x, k, dim=-1 if axis is None else axis,
                     largest=largest, sorted=sorted)
    return res.values, res.indices


def nonzero(x, as_tuple=False):
    """The int64 indices of x's nonzero entries, [count, ndim] (or one
    tensor an axis), on x's device."""
    x = as_tensor(x)
    if as_tuple:
        return torch.nonzero(x, as_tuple=True)
    return torch.nonzero(x)


# ---- comparison and logic (operators/controlflow/compare_op.cc) ----------
def _cmp(name, fn):
    @uncast
    def op(x, y, name=None):
        tx = as_tensor(x)
        return fn(tx, as_tensor(y, ref=tx))
    op.__name__ = name
    return register(name, op)


equal = _cmp('equal', torch.eq)
not_equal = _cmp('not_equal', torch.ne)
less_than = _cmp('less_than', torch.lt)
less_equal = _cmp('less_equal', torch.le)
greater_than = _cmp('greater_than', torch.gt)
greater_equal = _cmp('greater_equal', torch.ge)
logical_and = _cmp('logical_and', torch.logical_and)
logical_or = _cmp('logical_or', torch.logical_or)
logical_xor = _cmp('logical_xor', torch.logical_xor)
bitwise_and = _cmp('bitwise_and', torch.bitwise_and)
bitwise_or = _cmp('bitwise_or', torch.bitwise_or)
bitwise_xor = _cmp('bitwise_xor', torch.bitwise_xor)


def equal_all(x, y, name=None):
    """A 0-dim bool tensor: same shape and every entry equal."""
    x, y = as_tensor(x), as_tensor(y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(x, y).all()


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return isclose(x, y, rtol, atol, equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = as_tensor(x)
    return torch.isclose(x, as_tensor(y, ref=x), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def logical_not(x, name=None):
    return torch.logical_not(as_tensor(x))


def bitwise_not(x, name=None):
    return torch.bitwise_not(as_tensor(x))


def isnan(x, name=None):
    return torch.isnan(as_tensor(x))


def isinf(x, name=None):
    return torch.isinf(as_tensor(x))


def isfinite(x, name=None):
    return torch.isfinite(as_tensor(x))


@uncast
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(as_tensor(x), nan, posinf, neginf)


# ---- norms ----------------------------------------------------------------
@uncast
def norm(x, p='fro', axis=None, keepdim=False, name=None):
    """Parity: operators/p_norm_op + norm_op (the reference's rules):
    no axis and p 'fro' or 2 is the 2-norm of every entry (keepdim
    ignored); no axis and another p the vector p-norm of the flattened
    x; an axis (or a pair, a matrix norm) numpy's norm."""
    x = as_tensor(x)
    if axis is None:
        if p in ('fro', 2):
            return torch.sqrt(torch.sum(x * x))
        return torch.linalg.vector_norm(x.reshape(-1), ord=p)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if isinstance(ax, tuple) and len(ax) == 2:
        return torch.linalg.matrix_norm(x, ord='fro' if p == 'fro' else p,
                                        dim=ax, keepdim=keepdim)
    return torch.linalg.vector_norm(x, ord=2 if p == 'fro' else p, dim=ax,
                                    keepdim=keepdim)


@uncast
def dist(x, y, p=2, name=None):
    x, y = as_tensor(x), as_tensor(y)
    d = (x - y).reshape(-1)
    if p == 0:
        return torch.sum(d != 0).to(x.dtype)
    if p == float('inf'):
        return torch.max(torch.abs(d))
    if p == float('-inf'):
        return torch.min(torch.abs(d))
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)


# ---- where / select -------------------------------------------------------
@uncast
def where(condition, x=None, y=None, name=None):
    condition = as_tensor(condition)
    if x is None and y is None:
        return nonzero(condition)
    tx = as_tensor(x)
    return torch.where(condition, tx, as_tensor(y, ref=tx))


def multiplex(inputs, index, name=None):
    """Row i of the result is row i of inputs[index[i]]."""
    stacked = torch.stack([as_tensor(t) for t in inputs])
    idx = as_tensor(index).reshape(-1).to(device=stacked.device,
                                          dtype=torch.long)
    return stacked[idx, torch.arange(idx.shape[0], device=stacked.device)]


# ---- misc -----------------------------------------------------------------
@uncast
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(as_tensor(x), offset, axis1, axis2).sum(-1)


@uncast
def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D x as a diagonal matrix (the rest `padding_value`); a 2-D
    x's diagonal."""
    x = as_tensor(x)
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x), offset)
            out = out + (1 - mask) * padding_value
        return out
    return torch.diagonal(x, offset)


@uncast
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """The last axis of x as the `offset` diagonal of square matrices in
    the last two axes (the reference's; `dim1`/`dim2` other than the
    last two are not honoured there either)."""
    return torch.diag_embed(as_tensor(x), offset, -2, -1)


@uncast
def lerp(x, y, weight, name=None):
    x, y = as_tensor(x), as_tensor(y)
    return x + weight * (y - x)


@uncast
def frac(x):
    x = as_tensor(x)
    return x - torch.trunc(x)


def rad2deg(x):
    return scale(as_tensor(x), 180.0 / _math.pi)


def deg2rad(x):
    return scale(as_tensor(x), _math.pi / 180.0)


def gcd(x, y):
    x = as_tensor(x)
    return torch.gcd(x, as_tensor(y, ref=x))


def lcm(x, y):
    x = as_tensor(x)
    return torch.lcm(x, as_tensor(y, ref=x))


def count_nonzero(x, axis=None, keepdim=False):
    x = as_tensor(x)
    return (x != 0).sum(_all_dims(x, _axis(axis)), keepdim=keepdim)


@uncast
def heaviside(x, y):
    x = as_tensor(x)
    return torch.heaviside(x, as_tensor(y, ref=x))


def histogram(input, bins=100, min=0, max=0):
    """int64 counts of `bins` equal bins over [min, max] (the data's
    range when both are 0), on the device."""
    x = as_tensor(input)
    x = x if x.is_floating_point() else x.float()
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    return torch.histc(x, bins, lo, hi).to(torch.int64)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def bincount(x, weights=None, minlength=0):
    x = as_tensor(x)
    w = None if weights is None else as_tensor(weights).reshape(-1)
    return torch.bincount(x.reshape(-1), w, minlength)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    x, s = as_tensor(x), as_tensor(sorted_sequence)
    return torch.searchsorted(s, x, out_int32=out_int32, right=right)


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return bucketize(values, sorted_sequence, out_int32, right)


@uncast
def take(x, index, mode='raise'):
    """Entries of the flattened x at `index`, clipped into range as the
    reference's jnp.take(mode='clip')."""
    x, index = as_tensor(x), as_tensor(index)
    flat = x.reshape(-1)
    return flat[index.to(device=x.device, dtype=torch.long).clamp(
        0, flat.numel() - 1)]


@uncast
def tensordot(x, y, axes=2, name=None):
    return torch.tensordot(as_tensor(x), as_tensor(y), dims=axes)


@uncast
def logcumsumexp(x, axis=None, name=None):
    x = as_tensor(x)
    if axis is None:
        return torch.logcumsumexp(x.reshape(-1), 0)
    return torch.logcumsumexp(x, axis)


@uncast
def renorm(x, p, axis, max_norm):
    """Each slice along `axis` whose p-norm exceeds max_norm scaled to
    max_norm / (norm + 1e-7)."""
    x = as_tensor(x)
    moved = x.movedim(axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.pow(torch.sum(torch.pow(torch.abs(flat), p), 1), 1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return (flat * factor[:, None]).reshape(moved.shape).movedim(0, axis)


@uncast
def diff(x, n=1, axis=-1, prepend=None, append=None):
    x = as_tensor(x)
    return torch.diff(x, n, axis,
                      None if prepend is None else as_tensor(prepend, x),
                      None if append is None else as_tensor(append, x))


@uncast
def trapezoid(y, x=None, dx=None, axis=-1):
    y = as_tensor(y)
    if x is not None:
        return torch.trapezoid(y, as_tensor(x), dim=axis)
    return torch.trapezoid(y, dx=dx or 1.0, dim=axis)


@uncast
def vander(x, n=None, increasing=False):
    """Columns x^(n-1) .. x^0 (x^0 .. x^(n-1) when increasing), as powers
    (torch.vander's backward fails on an in-place cumprod)."""
    x = as_tensor(x)
    n = x.shape[0] if n is None else n
    p = torch.arange(n, device=x.device, dtype=x.dtype)
    return x.unsqueeze(-1) ** (p if increasing else p.flip(0))


@uncast
def angle(x, name=None):
    return torch.angle(as_tensor(x))


@uncast
def conj(x, name=None):
    return torch.conj(as_tensor(x)).resolve_conj()


@uncast
def polar(abs, angle):
    return torch.polar(as_tensor(abs), as_tensor(angle))


def crop(x, shape=None, offsets=None):
    from . import manip
    x = as_tensor(x)
    shape_ = [x.shape[i] if s == -1 else s for i, s in enumerate(shape)]
    offsets = offsets or [0] * x.dim()
    return manip.slice(x, list(range(x.dim())), offsets,
                       [o + s for o, s in zip(offsets, shape_)])


__all__ = [
    'abs', 'acos', 'acosh', 'add', 'addmm', 'all', 'allclose', 'amax',
    'amin', 'angle', 'any', 'argmax', 'argmin', 'argsort', 'asin', 'asinh',
    'assign', 'atan', 'atan2', 'atanh', 'bincount', 'bitwise_and',
    'bitwise_not', 'bitwise_or', 'bitwise_xor', 'bmm', 'broadcast_shape',
    'bucketize', 'ceil', 'clip', 'clip_by_norm', 'conj', 'cos', 'cosh',
    'count_nonzero', 'crop', 'cross', 'cumprod', 'cumsum', 'cumsum_',
    'deg2rad', 'diag', 'diag_embed', 'diff', 'digamma', 'dist', 'divide',
    'dot', 'equal', 'equal_all', 'erf', 'exp', 'expm1', 'floor',
    'floor_divide', 'floor_mod', 'fmax', 'fmin', 'frac', 'gcd',
    'greater_equal', 'greater_than', 'heaviside', 'histogram', 'hypot',
    'increment', 'inner', 'isclose', 'isfinite', 'isinf', 'isnan', 'kron',
    'lcm', 'lerp', 'less_equal', 'less_than', 'lgamma', 'log', 'log10',
    'log1p', 'log2', 'logcumsumexp', 'logical_and', 'logical_not',
    'logical_or', 'logical_xor', 'logsumexp', 'matmul', 'max', 'maximum',
    'mean', 'median', 'min', 'minimum', 'mm', 'mod', 'mode', 'multiplex',
    'multiply', 'multiply_', 'mv', 'nan_to_num', 'nanmean', 'nansum', 'neg',
    'nonzero', 'norm', 'not_equal', 'outer', 'polar', 'pow', 'prod',
    'quantile', 'rad2deg', 'reciprocal', 'remainder', 'renorm', 'round',
    'rsqrt', 'scale', 'searchsorted', 'sigmoid', 'sign', 'sin', 'sinh',
    'sort', 'sqrt', 'square', 'stanh', 'std', 'subtract', 'sum', 'take',
    'tan', 'tanh', 'tensordot', 'topk', 'trace', 'trapezoid', 'trunc',
    'vander', 'var', 'where']
register_public(globals(), __all__)
