"""Tensor creation and random ops — counterpart of
`paddle_tpu/ops/creation.py`, and `to_tensor` (`core/tensor.py:396`).

An op that makes a tensor from nothing takes `device=None` (or paddle's
`place=`, 'gpu' for the card), resolved by `device.resolve_device`: on
the card unless the caller asks for 'cpu', and an error when there is no
card. An op on a tensor runs where the tensor is. Default dtypes are the
reference's: float32, and int64 for `arange` over ints, `randint` and
`randperm`.

The random ops draw from the package generator of their device
(`core.rng.generator`, seeded by `core.rng.seed`) or from a `generator=`
the caller passes; never from torch's default generator. `uniform`'s
`seed=s` (s != 0) draws from a fresh generator seeded with s, as the
reference's `jax.random.key(seed)` does. The streams are torch's, not
the reference's: the tests hold the draws by their moments.
"""
import torch

from ..device import resolve_device
from ..core import rng as _rng
from .common import as_tensor, convert_dtype, register_public


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _dt(dtype, default=torch.float32):
    return convert_dtype(dtype) if dtype is not None else default


def place_device(device=None, place=None):
    """The device of a creation op: `device`, else paddle's `place`
    ('gpu', 'gpu:1', 'cpu' or a torch device), else the card."""
    if device is None and place is not None:
        device = place
        if isinstance(place, str) and place.startswith('gpu'):
            device = 'cuda' + place[3:]
    return resolve_device(device)


def _gen(device, generator):
    return generator if generator is not None else _rng.generator(device)


def _val(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def to_tensor(data, dtype=None, place=None, stop_gradient=True,
              device=None):
    """Parity: paddle.to_tensor: `data` (a tensor, numpy array, list or
    scalar) copied to the device; a Python float list is float32."""
    dev = place_device(device, place)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=_dt(dtype, data.dtype),
                               copy=True)
    else:
        out = torch.as_tensor(data, dtype=convert_dtype(dtype), device=dev)
        if dtype is None and out.dtype == torch.float64 and \
                not hasattr(data, 'dtype'):
            out = out.float()
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def zeros(shape, dtype=None, name=None, device=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device(device))


def ones(shape, dtype=None, name=None, device=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype=None, name=None, device=None):
    return torch.full(_shape(shape), _val(fill_value), dtype=_dt(dtype),
                      device=resolve_device(device))


def empty(shape, dtype=None, name=None, device=None):
    """Zeros, as the reference's (a fresh buffer is never read
    uninitialised)."""
    return zeros(shape, dtype, device=device)


def zeros_like(x, dtype=None, name=None):
    x = as_tensor(x)
    return torch.zeros_like(x, dtype=_dt(dtype, x.dtype))


def ones_like(x, dtype=None, name=None):
    x = as_tensor(x)
    return torch.ones_like(x, dtype=_dt(dtype, x.dtype))


def full_like(x, fill_value, dtype=None, name=None):
    x = as_tensor(x)
    return torch.full_like(x, _val(fill_value), dtype=_dt(dtype, x.dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    start, end, step = _val(start), _val(end), _val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = torch.int64 if all(isinstance(v, int) for v in
                                   (start, end, step)) else torch.float32
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=resolve_device(device))


def linspace(start, stop, num, dtype=None, name=None, device=None):
    return torch.linspace(_val(start), _val(stop), int(_val(num)),
                          dtype=_dt(dtype), device=resolve_device(device))


def logspace(start, stop, num, base=10.0, dtype=None, device=None):
    return torch.logspace(_val(start), _val(stop), int(_val(num)),
                          base=base, dtype=_dt(dtype),
                          device=resolve_device(device))


def eye(num_rows, num_columns=None, dtype=None, name=None, device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype),
                     device=resolve_device(device))


def assign(x, output=None):
    """A copy of `x` (a float copy stays in the autograd graph); with
    `output`, written into it."""
    x = as_tensor(x)
    out = x + 0 if x.is_floating_point() else x.clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x):
    return assign(x)


def tril_(*a, **k):
    from . import manip
    return manip.tril(*a, **k)


def diagflat(x, offset=0):
    return torch.diagflat(as_tensor(x), offset)


def complex(real, imag):
    real = as_tensor(real)
    return torch.complex(real, as_tensor(imag, ref=real))


# ---- random ----------------------------------------------------------------
def uniform(shape, dtype='float32', min=-1.0, max=1.0, seed=0, name=None,
            device=None, generator=None):
    """Parity: operators/uniform_random_op: U[min, max)."""
    dev = resolve_device(device)
    if seed:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return out.uniform_(min, max, generator=_gen(dev, generator))


def rand(shape, dtype=None, name=None, device=None, generator=None):
    return uniform(shape, dtype or 'float32', 0.0, 1.0, device=device,
                   generator=generator)


def randn(shape, dtype=None, name=None, device=None, generator=None):
    dev = resolve_device(device)
    return torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                       generator=_gen(dev, generator))


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None,
           generator=None):
    """N(mean, std); tensor means or stds broadcast and set the shape
    and the device."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        shp = torch.broadcast_shapes(
            getattr(mean, 'shape', ()), getattr(std, 'shape', ()))
        z = torch.randn(shp, dtype=torch.float32, device=ref.device,
                        generator=_gen(ref.device, generator))
        return z * std + mean
    dev = resolve_device(device)
    z = torch.randn(_shape(shape), dtype=torch.float32, device=dev,
                    generator=_gen(dev, generator))
    return z * std + mean


def gaussian(shape, mean=0.0, std=1.0, dtype='float32', name=None,
             device=None, generator=None):
    return randn(shape, dtype, device=device, generator=generator) * std \
        + mean


def standard_normal(shape, dtype=None, name=None, device=None,
                    generator=None):
    return randn(shape, dtype, device=device, generator=generator)


def randint(low=0, high=None, shape=(1,), dtype='int64', name=None,
            device=None, generator=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device(device)
    return torch.randint(low, high, _shape(shape),
                         dtype=_dt(dtype, torch.int64), device=dev,
                         generator=_gen(dev, generator))


def randint_like(x, low=0, high=None, dtype=None, generator=None):
    x = as_tensor(x)
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, tuple(x.shape),
                         dtype=_dt(dtype, x.dtype), device=x.device,
                         generator=_gen(x.device, generator))


def randperm(n, dtype='int64', name=None, device=None, generator=None):
    dev = resolve_device(device)
    return torch.randperm(n, dtype=_dt(dtype, torch.int64), device=dev,
                          generator=_gen(dev, generator))


def shuffle(x, axis=0, generator=None):
    """`x` with its entries along `axis` in a random order."""
    x = as_tensor(x)
    perm = torch.randperm(x.shape[axis], device=x.device,
                          generator=_gen(x.device, generator))
    return x.index_select(axis, perm)


def bernoulli(x, name=None, generator=None):
    """1 with probability x, else 0, in x's dtype."""
    x = as_tensor(x)
    return torch.bernoulli(x, generator=_gen(x.device, generator))


def poisson(x, generator=None):
    x = as_tensor(x)
    return torch.poisson(x, generator=_gen(x.device, generator))


def multinomial(x, num_samples=1, replacement=False, name=None,
                generator=None):
    """Class ids drawn from the rows of `x` (weights, normalised per
    row), int64."""
    x = as_tensor(x)
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(x.device, generator))


def truncated_gaussian_random(shape, mean=0.0, std=1.0, dtype='float32',
                              device=None, generator=None):
    """N(0, 1) truncated to [-2, 2], then scaled by std and shifted by
    mean (the reference's jax.random.truncated_normal)."""
    dev = resolve_device(device)
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=_gen(dev, generator))
    return out * std + mean


__all__ = [
    'to_tensor', 'zeros', 'ones', 'full', 'empty', 'zeros_like', 'ones_like',
    'full_like', 'empty_like', 'arange', 'linspace', 'logspace', 'eye',
    'assign', 'clone', 'tril_', 'diagflat', 'complex', 'uniform', 'rand',
    'randn', 'normal', 'gaussian', 'standard_normal', 'randint',
    'randint_like', 'randperm', 'shuffle', 'bernoulli', 'poisson',
    'multinomial', 'truncated_gaussian_random']
register_public(globals(), __all__)
