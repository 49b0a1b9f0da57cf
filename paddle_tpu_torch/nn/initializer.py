"""Weight initializers — counterparts of `paddle_tpu/nn/initializer.py`:
`Constant`, `Uniform`, `Normal`, `TruncatedNormal`, `XavierUniform`,
`XavierNormal`, `KaimingUniform`, `KaimingNormal`, `Assign`,
`Orthogonal`, `Dirac` and `calculate_gain`.

An initializer fills a tensor in place, `init(tensor, generator=None)`,
drawing from the given `torch.Generator` (a layer passes its own) or,
when there is none, from the package generator of the tensor's device
(`core.rng.generator`, which `paddle_tpu_torch.seed` seeds); never from
torch's default generator. The reference draws from its global key
stream, so the values differ and the tests hold their moments. Fans
follow the reference's `_fan_in_out` (:56-65): a 2-D weight is [in,
out]; a conv weight [out, in/groups, *k] has fan_in in·k and fan_out
out·k. As in the reference, the Kaiming initializers take the ReLU gain
whatever `negative_slope` says, `TruncatedNormal` cuts the standard
normal at ±2 before scaling, and `Dirac` ignores `groups`.
"""
import math

import torch

from ..core import rng as _rng


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) >= 3:
        rf = math.prod(shape[2:])
        return shape[1] * rf, shape[0] * rf
    n = math.prod(shape) if shape else 1
    return n, n


def _gen(tensor, generator):
    return generator if generator is not None else \
        _rng.generator(tensor.device)


class Initializer:
    def __call__(self, tensor, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.fill_(self.value)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.uniform_(self.low, self.high,
                                   generator=_gen(tensor, generator))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.normal_(self.mean, self.std,
                                  generator=_gen(tensor, generator))


class TruncatedNormal(Initializer):
    """N(0, 1) cut to [-2, 2], times std, plus mean."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            torch.nn.init.trunc_normal_(tensor, 0.0, 1.0, -2.0, 2.0,
                                        generator=_gen(tensor, generator))
            return tensor.mul_(self.std).add_(self.mean)


class _Fans(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fan_in_out(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)


class XavierUniform(_Fans):
    """U(-a, a), a = gain·sqrt(6 / (fan_in + fan_out))."""

    def __call__(self, tensor, generator=None):
        fi, fo = self._fans(tensor.shape)
        a = self.gain * math.sqrt(6.0 / (fi + fo))
        with torch.no_grad():
            return tensor.uniform_(-a, a, generator=_gen(tensor, generator))


class XavierNormal(_Fans):
    """N(0, s), s = gain·sqrt(2 / (fan_in + fan_out))."""

    def __call__(self, tensor, generator=None):
        fi, fo = self._fans(tensor.shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        with torch.no_grad():
            return tensor.normal_(0.0, std,
                                  generator=_gen(tensor, generator))


class KaimingUniform(Initializer):
    """U(-a, a), a = sqrt(6 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity='relu'):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, tensor, generator=None):
        fi = self.fan_in if self.fan_in is not None else \
            _fan_in_out(tensor.shape)[0]
        a = math.sqrt(6.0 / fi)
        with torch.no_grad():
            return tensor.uniform_(-a, a, generator=_gen(tensor, generator))


class KaimingNormal(Initializer):
    """N(0, s), s = sqrt(2 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity='relu'):
        self.fan_in = fan_in

    def __call__(self, tensor, generator=None):
        fi = self.fan_in if self.fan_in is not None else \
            _fan_in_out(tensor.shape)[0]
        with torch.no_grad():
            return tensor.normal_(0.0, math.sqrt(2.0 / fi),
                                  generator=_gen(tensor, generator))


class Assign(Initializer):
    """The given values (a tensor, an array or a list), reshaped to the
    tensor's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, tensor, generator=None):
        v = torch.as_tensor(self.value).reshape(tensor.shape)
        with torch.no_grad():
            return tensor.copy_(v)


class Orthogonal(Initializer):
    """gain times an orthonormal matrix, as jax's orthogonal initializer:
    the tensor as [numel / shape[-1], shape[-1]], the Q of the QR of a
    normal draw with its signs fixed by R's diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, tensor, generator=None):
        cols = tensor.shape[-1]
        rows = tensor.numel() // cols
        z = torch.empty(max(rows, cols), min(rows, cols),
                        dtype=torch.float32, device=tensor.device)
        z.normal_(generator=_gen(tensor, generator))
        q, r = torch.linalg.qr(z)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        with torch.no_grad():
            return tensor.copy_((self.gain * q).reshape(tensor.shape))


class Dirac(Initializer):
    """1 at [i, i, centre] for i < min(out, in), else 0."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            tensor.zero_()
            centre = tuple(s // 2 for s in tensor.shape[2:])
            for i in range(min(tensor.shape[0], tensor.shape[1])):
                tensor[(i, i) + centre] = 1.0
            return tensor


def calculate_gain(nonlinearity, param=None):
    gains = {'sigmoid': 1.0, 'linear': 1.0, 'conv2d': 1.0, 'tanh': 5.0 / 3,
             'relu': math.sqrt(2.0), 'selu': 3.0 / 4}
    if nonlinearity == 'leaky_relu':
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    return gains.get(nonlinearity, 1.0)
