"""Shape and layout manipulation ops — counterpart of
`paddle_tpu/ops/manip.py`, with paddle's names and arguments. Every op
stands for one `run_op` of the reference, so none is reached by
`amp.auto_cast`.

Rules kept from the reference: `reshape`'s 0 copies the input's
dimension; `split` takes a list of sections with one -1 for the rest;
`gather` and `index_select` take a flattened index; `scatter` with
`overwrite=False` zeroes the rows it targets and then adds every update
into them. Under `overwrite=True` a repeated index keeps one of its
updates, which one is not defined on the card (CUDA's scatter order):
pass unique indices. `unique` returns sorted values with the first
index, the inverse and the counts it is asked for; `unique_consecutive`
collapses runs. `masked_select`, `unique` and `nonzero`-like results run
on the device (the reference computes them on the host). Index outputs
are int64.
"""
import builtins
import math

import torch
import torch.nn.functional as _tF

from ..amp import uncast
from .common import as_tensor, convert_dtype, register, register_public


def _norm_shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return [shape]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in shape]


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else v


@uncast
def cast(x, dtype):
    x = as_tensor(x)
    dt = convert_dtype(dtype)
    return x if dt == x.dtype else x.to(dt)


@uncast
def reshape(x, shape, name=None):
    """paddle's reshape: a 0 copies the input's dimension there."""
    x = as_tensor(x)
    shape = _norm_shape(shape)
    return x.reshape([x.shape[i] if s == 0 else s
                      for i, s in enumerate(shape)])


def transpose(x, perm, name=None):
    return as_tensor(x).permute(*perm)


def moveaxis(x, source, destination):
    return torch.movedim(as_tensor(x), source, destination)


def swapaxes(x, axis0, axis1):
    return torch.swapaxes(as_tensor(x), axis0, axis1)


transpose_ = transpose


def squeeze(x, axis=None, name=None):
    """Drops the size-1 axes (those of `axis` that have size 1)."""
    x = as_tensor(x)
    if axis is None:
        return x.squeeze()
    axis = [axis] if isinstance(axis, int) else axis
    ax = tuple(a for a in axis if x.shape[a] == 1)
    return x.squeeze(ax) if ax else x


def unsqueeze(x, axis, name=None):
    x = as_tensor(x)
    axis = [axis] if isinstance(axis, (int, torch.Tensor)) else axis
    for ax in sorted(_int(a) for a in axis):
        x = x.unsqueeze(ax)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = as_tensor(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


@uncast
def concat(x, axis=0, name=None):
    tensors = [as_tensor(t) for t in x]
    return torch.cat(tensors, dim=_int(axis))


@uncast
def stack(x, axis=0, name=None):
    return torch.stack([as_tensor(t) for t in x], dim=axis)


def split(x, num_or_sections, axis=0, name=None):
    """Parity: operators/split_op: `num_or_sections` equal parts, or a
    list of sizes with at most one -1 standing for the rest."""
    x = as_tensor(x)
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_int(s) for s in num_or_sections]
        if -1 in sizes:
            rest = dim - builtins.sum(s for s in sizes if s != -1)
            sizes = [rest if s == -1 else s for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unstack(x, axis=0, num=None):
    return list(torch.unbind(as_tensor(x), dim=axis))


def unbind(x, axis=0):
    return unstack(x, axis=axis)


def tile(x, repeat_times, name=None):
    return as_tensor(x).tile(tuple(_norm_shape(repeat_times)))


def expand(x, shape, name=None):
    """Broadcast to `shape`; -1 keeps the input's dimension."""
    x = as_tensor(x)
    shape = _norm_shape(shape)
    lead = len(shape) - x.dim()
    return x.expand([x.shape[i - lead] if s == -1 else s
                     for i, s in enumerate(shape)])


def expand_as(x, y, name=None):
    return expand(x, as_tensor(y).shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*[as_tensor(t) for t in inputs]))


def flip(x, axis, name=None):
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(as_tensor(x), ax)


def roll(x, shifts, axis=None, name=None):
    x = as_tensor(x)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(as_tensor(x), k, list(axes))


# ---- gather / scatter ------------------------------------------------------
def _index(index, x):
    return as_tensor(index).to(device=x.device, dtype=torch.long)


@uncast
def gather(x, index, axis=0, name=None):
    """Parity: operators/gather_op: the entries of `axis` at the
    flattened `index`."""
    x = as_tensor(x)
    return torch.index_select(x, _int(axis), _index(index, x).reshape(-1))


@uncast
def gather_nd(x, index, name=None):
    """x at the coordinates of index's last axis (a prefix of x's axes)."""
    x = as_tensor(x)
    idx = _index(index, x)
    return x[tuple(idx.movedim(-1, 0))]


@uncast
def take_along_axis(x, indices, axis):
    x = as_tensor(x)
    return torch.take_along_dim(x, _index(indices, x), dim=axis)


@uncast
def put_along_axis(x, indices, values, axis, reduce='assign'):
    """x with `values` written ('assign') or added ('add') at `indices`
    along `axis`."""
    x = as_tensor(x)
    idx = _index(indices, x)
    v = as_tensor(values, ref=x)
    v = v.to(x.device).expand(idx.shape) if v.dim() == 0 else v
    if reduce == 'add':
        return x.scatter_add(axis, idx, v)
    return x.scatter(axis, idx, v)


@uncast
def scatter(x, index, updates, overwrite=True, name=None):
    """Parity: operators/scatter_op: rows of x at `index` set to
    `updates` (overwrite), or zeroed and then summed into (not). A
    repeated index under overwrite keeps one update, in an order CUDA
    does not define: use unique indices."""
    x = as_tensor(x)
    u = as_tensor(updates, ref=x)
    idx = _index(index, x).reshape(-1)
    if overwrite:
        return x.index_copy(0, idx, u)
    return x.index_fill(0, idx, 0).index_add(0, idx, u)


@uncast
def scatter_nd_add(x, index, updates, name=None):
    """x plus each update added at its coordinates (index's last axis);
    repeated coordinates accumulate."""
    x = as_tensor(x)
    u = as_tensor(updates, ref=x)
    idx = _index(index, x)
    k = idx.shape[-1]
    flat_idx = idx.reshape(-1, k)
    strides = torch.tensor([math.prod(x.shape[j + 1:k]) for j in range(k)],
                           dtype=torch.long, device=x.device)
    rows = (flat_idx * strides).sum(-1)
    lead = x.reshape((-1,) + tuple(x.shape[k:]))
    return lead.index_add(0, rows, u.reshape((-1,) + tuple(x.shape[k:]))) \
        .reshape(x.shape)


def scatter_nd(index, updates, shape, name=None):
    updates = as_tensor(updates)
    zeros = torch.zeros(_norm_shape(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


@uncast
def index_select(x, index, axis=0, name=None):
    x = as_tensor(x)
    return torch.index_select(x, axis, _index(index, x).reshape(-1))


@uncast
def index_sample(x, index):
    """Parity: operators/index_sample_op: row i of x at index[i]."""
    x = as_tensor(x)
    return torch.gather(x, 1, _index(index, x))


def masked_select(x, mask, name=None):
    """The entries of x where the (broadcast) mask is true, as a 1-D
    tensor on x's device."""
    x = as_tensor(x)
    return torch.masked_select(x, as_tensor(mask).to(x.device))


@uncast
def masked_fill(x, mask, value):
    x = as_tensor(x)
    return x.masked_fill(as_tensor(mask).to(x.device), value)


# ---- slicing ---------------------------------------------------------------
@uncast
def slice(x, axes, starts, ends, name=None):
    """Parity: operators/slice_op: negative bounds count from the end,
    bounds past it clip."""
    x = as_tensor(x)
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, _norm_shape(starts), _norm_shape(ends)):
        dim = x.shape[ax]
        st = st + dim if st < 0 else builtins.min(st, dim)
        en = en + dim if en < 0 else builtins.min(en, dim)
        idx[ax] = builtins.slice(st, en)
    return x[tuple(idx)]


@uncast
def strided_slice(x, axes, starts, ends, strides, name=None):
    """numpy's slicing (a negative stride included) on each of `axes`."""
    x = as_tensor(x)
    for ax, st, en, sd in zip(axes, _norm_shape(starts), _norm_shape(ends),
                              _norm_shape(strides)):
        rng = range(*builtins.slice(st, en, sd).indices(x.shape[ax]))
        x = torch.index_select(x, ax, torch.tensor(list(rng),
                                                   dtype=torch.long,
                                                   device=x.device))
    return x


@uncast
def getitem(x, idx):
    """x[idx] (a bool tensor index selects as `masked_select`)."""
    return as_tensor(x)[idx]


def tril(x, diagonal=0, name=None):
    return torch.tril(as_tensor(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(as_tensor(x), diagonal)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(as_tensor(x), offset, axis1, axis2)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype='int64', name=None):
    """The sorted unique values (of the flattened x, or slices along
    `axis`), with the first index of each, the inverse and the counts
    when asked; int64 index outputs, on x's device."""
    x = as_tensor(x)
    vals, inverse, counts = torch.unique(
        x, sorted=True, return_inverse=True, return_counts=True, dim=axis)
    outs = [vals]
    if return_index:
        n = x.shape[axis] if axis is not None else x.numel()
        pos = torch.arange(n, device=x.device)
        first = torch.full((vals.shape[0 if axis is None else axis],), n,
                           dtype=torch.long, device=x.device)
        outs.append(first.scatter_reduce(0, inverse.reshape(-1), pos,
                                         'amin'))
    if return_inverse:
        outs.append(inverse.reshape(-1))
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    """Each run of equal consecutive values (of the flattened x) once,
    with the inverse and the run lengths when asked."""
    x = as_tensor(x)
    vals, inverse, counts = torch.unique_consecutive(
        x.reshape(-1) if axis is None else x, return_inverse=True,
        return_counts=True, dim=axis)
    outs = [vals]
    if return_inverse:
        outs.append(inverse)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


# ---- padding and the rest --------------------------------------------------
_PAD_MODES = {'constant': 'constant', 'reflect': 'reflect',
              'replicate': 'replicate', 'circular': 'circular'}


@uncast
def pad(x, pad, mode='constant', value=0.0, data_format='NCHW', name=None):
    """Parity: operators/pad3d: a pad of 2·ndim entries pads every axis
    (low, high in axis order); a shorter one pads the trailing axes, the
    last axis first (torch's order)."""
    x = as_tensor(x)
    pad = _norm_shape(pad)
    if len(pad) == 2 * x.dim():
        pad = [p for i in reversed(range(x.dim()))
               for p in (pad[2 * i], pad[2 * i + 1])]
    if mode == 'constant':
        return _tF.pad(x, pad, mode='constant', value=value)
    return _tF.pad(x, pad, mode=_PAD_MODES[mode])


def one_hot(x, num_classes, name=None):
    """fp32 one-hot rows of the class ids x."""
    x = as_tensor(x)
    return _tF.one_hot(x.to(torch.long), num_classes).to(torch.float32)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Parity: operators/shard_index_op: an id of this shard as its
    offset in the shard, any other as `ignore_value`."""
    idx = as_tensor(input)
    size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    return torch.where((idx >= lo) & (idx < hi), idx - lo,
                       torch.full_like(idx, ignore_value))


def meshgrid(*args, **kwargs):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*[as_tensor(t) for t in ts], indexing='ij'))


@uncast
def repeat_interleave(x, repeats, axis=None):
    x = as_tensor(x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


@uncast
def as_complex(x):
    return torch.view_as_complex(as_tensor(x).contiguous())


@uncast
def as_real(x):
    return torch.view_as_real(as_tensor(x))


@uncast
def real(x):
    x = as_tensor(x)
    return torch.real(x) if x.is_complex() else x


@uncast
def imag(x):
    x = as_tensor(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def numel(x):
    x = as_tensor(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def shape(x):
    x = as_tensor(x)
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@uncast
def space_to_depth(x, blocksize):
    """[N, C, H, W] -> [N, C·b·b, H/b, W/b], blocks ordered (row in the
    block, column in the block, channel), as the reference's."""
    x = as_tensor(x)
    n, c, h, w = x.shape
    b = blocksize
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@uncast
def pixel_shuffle(x, upscale_factor, data_format='NCHW'):
    return _tF.pixel_shuffle(as_tensor(x), upscale_factor)


register('cast', cast)
register('reshape2', reshape)
register('transpose2', transpose)
register('concat', concat)
__all__ = [
    'as_complex', 'as_real', 'broadcast_tensors', 'broadcast_to', 'cast',
    'chunk', 'concat', 'diagonal', 'expand', 'expand_as', 'flatten', 'flip',
    'gather', 'gather_nd', 'getitem', 'imag', 'index_sample',
    'index_select', 'masked_fill', 'masked_select', 'meshgrid', 'moveaxis',
    'numel', 'one_hot', 'pad', 'pixel_shuffle', 'put_along_axis', 'real',
    'repeat_interleave', 'reshape', 'roll', 'rot90', 'scatter',
    'scatter_nd', 'scatter_nd_add', 'shape', 'shard_index', 'slice',
    'space_to_depth', 'split', 'squeeze', 'stack', 'strided_slice',
    'swapaxes', 'take_along_axis', 'tile', 'transpose', 'transpose_', 'tril',
    'triu', 'unbind', 'unique', 'unique_consecutive', 'unsqueeze',
    'unstack']
register_public(globals(), __all__)
