"""paddle.distribution — counterpart of `paddle_tpu/distribution.py`:
`Uniform`, `Normal`, `Categorical`, `Beta`, `MultivariateNormalDiag` and
`kl_divergence`, by the reference's formulas.

The reference builds `log_prob`, `entropy` and the KL from `.data`, so
they carry no gradient there; the port's are torch ops on the given
tensors and do (ROADMAP Queue 3). Samples draw from the package
generator of the parameters' device (`core.rng.generator`, seeded by
`paddle_tpu_torch.seed`); threefry's streams cannot be matched, so the
tests hold the samples' statistics. A parameter given as a tensor stays
on its device; one given as a Python number or array becomes an fp32
tensor on the device of the other parameter when that one is a tensor,
else on `device` (the card unless the caller passes device='cpu').
"""
import math

import torch
import torch.nn.functional as F

from .core import rng
from .device import resolve_device


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _params(*xs, device=None):
    """The parameters as tensors on one device: a tensor's own, else
    `resolve_device(device)`."""
    if device is None:
        device = next((x.device for x in xs
                       if isinstance(x, torch.Tensor)), None)
    device = resolve_device(device)
    return tuple(_as_tensor(x, device) for x in xs)


def _gen(t):
    return rng.generator(t.device)


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(self.log_prob(value))


class Uniform(Distribution):
    def __init__(self, low, high, name=None, device=None):
        self.low, self.high = _params(low, high, device=device)

    def sample(self, shape=(), seed=0):
        shp = tuple(shape) + tuple(self.low.shape)
        u = torch.rand(shp, generator=_gen(self.low), device=self.low.device,
                       dtype=self.low.dtype)
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        value = _as_tensor(value, self.low.device)
        inside = (value >= self.low) & (value < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)

    def sample(self, shape=(), seed=0):
        shp = tuple(shape) + tuple(self.loc.shape)
        eps = torch.randn(shp, generator=_gen(self.loc),
                          device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        value = _as_tensor(value, self.loc.device)
        var = self.scale ** 2
        return (-((value - self.loc) ** 2) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def kl_divergence(self, other):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


class Categorical(Distribution):
    def __init__(self, logits, name=None, device=None):
        self.logits, = _params(logits, device=device)

    def sample(self, shape=(), seed=0):
        batch = tuple(self.logits.shape[:-1])
        n = math.prod(tuple(shape)) if shape else 1
        p = F.softmax(self.logits, dim=-1).reshape(-1,
                                                   self.logits.shape[-1])
        draws = torch.multinomial(p, n, replacement=True,
                                  generator=_gen(self.logits))
        draws = draws.T.reshape(tuple(shape) + batch)
        return draws

    def log_prob(self, value):
        value = torch.as_tensor(value, device=self.logits.device)
        logp = F.log_softmax(self.logits, dim=-1)
        logp = logp.expand(tuple(value.shape) + logp.shape[-1:]) \
            if logp.dim() - 1 < value.dim() else logp
        return logp.gather(-1, value.to(torch.int64).unsqueeze(-1))[..., 0]

    def entropy(self):
        logp = F.log_softmax(self.logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)


class Beta(Distribution):
    def __init__(self, alpha, beta, device=None):
        self.alpha, self.beta = _params(alpha, beta, device=device)

    def sample(self, shape=(), seed=0):
        shp = tuple(shape) + tuple(self.alpha.shape)
        gen = _gen(self.alpha)
        x = torch._standard_gamma(self.alpha.expand(shp).contiguous(),
                                  generator=gen)
        y = torch._standard_gamma(self.beta.expand(shp).contiguous(),
                                  generator=gen)
        return x / (x + y)

    def log_prob(self, value):
        v = _as_tensor(value, self.alpha.device)
        a, b = self.alpha, self.beta
        betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return (a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v) - betaln


class MultivariateNormalDiag(Distribution):
    """loc [.., d], scale [.., d, d] of which only the diagonal counts
    (the reference's contract, fluid distributions.py:531)."""

    def __init__(self, loc, scale, name=None, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)

    def _diag(self):
        d = self.scale
        return torch.diagonal(d, dim1=-2, dim2=-1) if d.dim() >= 2 else d

    def sample(self, shape=(), seed=0):
        shp = tuple(shape) + tuple(self.loc.shape)
        eps = torch.randn(shp, generator=_gen(self.loc),
                          device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + self._diag() * eps

    def log_prob(self, value):
        v = _as_tensor(value, self.loc.device)
        sig = self._diag()
        z = (v - self.loc) / sig
        return (-0.5 * z * z - torch.log(sig)
                - 0.5 * math.log(2 * math.pi)).sum(-1)

    def entropy(self):
        sig = self._diag()
        d = sig.shape[-1]
        return 0.5 * d * (1.0 + math.log(2 * math.pi)) + \
            torch.log(sig * sig).sum(-1) * 0.5

    def kl_divergence(self, other):
        s1, s2 = self._diag(), other._diag()
        var1, var2 = s1 * s1, s2 * s2
        dmu = self.loc - other.loc
        return 0.5 * ((var1 / var2).sum(-1) + (dmu * dmu / var2).sum(-1)
                      - s1.shape[-1]
                      + torch.log(var2).sum(-1) - torch.log(var1).sum(-1))


def kl_divergence(p, q):
    if isinstance(p, Normal) and isinstance(q, Normal):
        return p.kl_divergence(q)
    if isinstance(p, MultivariateNormalDiag) and \
            isinstance(q, MultivariateNormalDiag):
        return p.kl_divergence(q)
    raise NotImplementedError(type(p))
