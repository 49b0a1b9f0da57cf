"""The port's `distribution` against `paddle_tpu.distribution` on the
same numpy parameters: `log_prob`, `entropy`, `probs` and
`kl_divergence` at the round's fp32 bars (rtol 2e-4 / atol 2e-5); the
port's carry gradients (the reference builds them from `.data`, ROADMAP
Queue 3), held against the closed form. Samples draw from torch's
generator, which cannot match threefry: their means and variances over
40,000 draws fall within 4 standard errors of the distribution's."""
import math

import numpy as np
import pytest
import torch

from paddle_tpu import distribution as jd
from paddle_tpu.core.tensor import Tensor
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import distribution as td

FP32 = dict(rtol=2e-4, atol=2e-5)
R = np.random.RandomState(0)
LOC = R.randn(3).astype(np.float32)
SCALE = (R.rand(3) + 0.5).astype(np.float32)
VAL = R.randn(3).astype(np.float32)
LOGITS = R.randn(2, 5).astype(np.float32)


def _pair(name, *args):
    return getattr(jd, name)(*[Tensor(a) for a in args]), \
        getattr(td, name)(*[torch.from_numpy(a) for a in args])


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.data),
                               **FP32)


CASES = [
    ('Normal', (LOC, SCALE), VAL),
    ('Uniform', (LOC - 1, LOC + SCALE), LOC + 0.25 * SCALE),
    ('Categorical', (LOGITS,), np.array([1, 4], np.int64)),
    ('Beta', ((SCALE + 0.5), (SCALE * 2)), (SCALE / 3).astype(np.float32)),
    ('MultivariateNormalDiag', (LOC, np.diag(SCALE).astype(np.float32)),
     VAL),
]


@pytest.mark.parametrize('name,args,value', CASES, ids=[c[0] for c in CASES])
def test_densities_match_reference(name, args, value):
    j, t = _pair(name, *args)
    jv = Tensor(value.astype(np.int32) if value.dtype == np.int64 else value)
    _close(t.log_prob(torch.from_numpy(value)), j.log_prob(jv))
    _close(t.probs(torch.from_numpy(value)), j.probs(jv))
    if name != 'Beta':
        _close(t.entropy(), j.entropy())


@pytest.mark.parametrize('name', ['Normal', 'MultivariateNormalDiag'])
def test_kl_matches_reference(name):
    a = (LOC, SCALE) if name == 'Normal' else (LOC, np.diag(SCALE))
    b = (VAL, SCALE * 1.7) if name == 'Normal' else \
        (VAL, np.diag(SCALE * 1.7))
    a = tuple(x.astype(np.float32) for x in a)
    b = tuple(x.astype(np.float32) for x in b)
    jp, tp = _pair(name, *a)
    jq, tq = _pair(name, *b)
    _close(td.kl_divergence(tp, tq), jd.kl_divergence(jp, jq))


def test_log_prob_carries_gradient():
    loc = torch.tensor(LOC, requires_grad=True)
    scale = torch.tensor(SCALE, requires_grad=True)
    td.Normal(loc, scale).log_prob(torch.from_numpy(VAL)).sum().backward()
    z = (VAL - LOC) / SCALE
    np.testing.assert_allclose(loc.grad.numpy(), z / SCALE, **FP32)
    np.testing.assert_allclose(scale.grad.numpy(), (z * z - 1) / SCALE,
                               **FP32)


def test_sample_statistics():
    tpaddle.seed(3)
    n = 40000

    def within(x, mean, var):
        x = x.double()
        se_m = math.sqrt(var / n)
        se_v = var * math.sqrt(2.0 / n) * 1.5
        assert abs(float(x.mean()) - mean) < 4 * se_m
        assert abs(float(x.var()) - var) < 4 * se_v
    s = td.Normal(1.5, 2.0, device='cpu').sample([n])
    assert s.shape == (n,)
    within(s, 1.5, 4.0)
    within(td.Uniform(-1.0, 3.0, device='cpu').sample([n]), 1.0, 16.0 / 12)
    a, b = 2.0, 5.0
    within(td.Beta(a, b, device='cpu').sample([n]), a / (a + b),
           a * b / ((a + b) ** 2 * (a + b + 1)))
    mv = td.MultivariateNormalDiag(torch.tensor([0.5, -1.0]),
                                   torch.diag(torch.tensor([1.0, 3.0])))
    s = mv.sample([n])
    within(s[:, 0], 0.5, 1.0)
    within(s[:, 1], -1.0, 9.0)
    logits = torch.tensor([0.0, 1.0, 2.0])
    c = td.Categorical(logits).sample([n])
    p = torch.softmax(logits, 0)
    freq = torch.bincount(c, minlength=3).double() / n
    assert torch.all((freq - p).abs() < 4 * torch.sqrt(p * (1 - p) / n))
    assert td.Categorical(torch.from_numpy(LOGITS)).sample([6]).shape == \
        (6, 2)


def test_python_numbers_go_to_the_card_unless_asked():
    """A parameter given as a number lands on the card by default, beside
    a tensor parameter on that tensor's device, else on `device`."""
    assert td.Normal(torch.zeros(2), 2.0).scale.device.type == 'cpu'
    assert td.Uniform(0.0, 1.0, device='cpu').high.device.type == 'cpu'
    if torch.cuda.is_available():
        assert td.Normal(1.5, 2.0).loc.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            td.Normal(1.5, 2.0)
