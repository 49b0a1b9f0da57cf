"""The port's op surface as a whole: every public function of the
reference's `ops/{creation,math,manip,linalg,fft}.py` has a counterpart
of the same name (the list computed from the JAX modules), the
top-level names resolve lazily, the creation and random ops, the rules
the port keeps from the reference (median, mode, a scalar beside an int
tensor, scatter), and `amp.auto_cast` over the new ops.

Creation ops are compared with JAX's exactly (they are deterministic).
The random ops' streams are torch's, so they are held by their moments
(at 5 standard errors of a draw of 20000), by reproducibility under
`seed()` and an explicit generator, and by torch's default generator
staying untouched.
"""
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as ptt
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import common as jcommon
from paddle_tpu.ops import creation as JC
from paddle_tpu.ops import manip as JM
from paddle_tpu.ops import math as JMa
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.ops import common as tcommon
from paddle_tpu_torch.ops import creation as TC
from paddle_tpu_torch.ops import manip as TM
from paddle_tpu_torch.ops import math as TMa
from torch_surface_util import assert_same

REPO = Path(__file__).resolve().parents[1]
MODULES = ('creation', 'math', 'manip', 'linalg', 'fft')
# reference functions without a port counterpart: (reason, where it goes)
EXCLUDED = {
    'linalg.histogramdd': ('the reference raises NotImplementedError: '
                           'there is nothing to port', 'none'),
    'math.inner_outer_placeholder': ('an empty stub of the reference, no '
                                     'paddle API', 'none'),
}


def _reference_ops(mod):
    helpers = {id(v) for v in vars(jcommon).values() if callable(v)}
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith('_') and callable(v)
                  and not inspect.ismodule(v) and not inspect.isclass(v)
                  and getattr(v, '__module__', '').startswith('paddle_tpu')
                  and id(v) not in helpers)


@pytest.mark.parametrize('name', MODULES)
def test_every_reference_op_has_a_port_counterpart(name):
    ref = importlib.import_module(f'paddle_tpu.ops.{name}')
    port = importlib.import_module(f'paddle_tpu_torch.ops.{name}')
    want = [n for n in _reference_ops(ref) if f'{name}.{n}' not in EXCLUDED]
    assert len(want) > 10
    missing = [n for n in want if not callable(getattr(port, n, None))]
    assert not missing, missing
    assert set(want) <= set(port.__all__)
    assert set(want) <= set(tcommon.OP_REGISTRY)


def test_top_level_names_resolve_and_the_package_imports_no_torch():
    code = ('import sys, paddle_tpu_torch as p\n'
            'assert "torch" not in sys.modules, "eager torch import"\n'
            'names = ("add", "concat", "randn", "to_tensor", "seed", '
            '"linalg", "fft", "ParamAttr", "einsum", "float32")\n'
            'print(all(getattr(p, n) is not None for n in names))\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         timeout=120)
    assert res.returncode == 0, res.stderr.decode()
    assert res.stdout.decode().split()[-1] == 'True'
    for n in ('add', 'concat', 'median', 'scatter', 'zeros', 'bincount',
              'crop', 'to_tensor', 'get_rng_state'):
        assert callable(getattr(ptt, n)), n
    assert ptt.linalg.svd is not None and ptt.fft.rfft is not None
    assert ptt.ParamAttr is ptt.nn.ParamAttr
    with pytest.raises(AttributeError):
        ptt.no_such_op


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
CREATION = [
    ('zeros', ([2, 3],), {}), ('ones', ([2, 3],), dict(dtype='int32')),
    ('full', ([2, 2], 1.5), {}), ('empty', ([3],), {}),
    ('arange', (5,), {}), ('arange', (1, 2.5, 0.5), {}),
    ('linspace', (0, 1, 5), {}), ('logspace', (0, 2, 3), {}),
    ('eye', (3, 4), {}),
]


@pytest.mark.parametrize('case', range(len(CREATION)))
def test_creation_op_matches_jax(case):
    name, args, kw = CREATION[case]
    assert_same(getattr(TC, name)(*args, device='cpu', **kw),
                getattr(JC, name)(*args, **kw), what=name)
    got = getattr(TC, name)(*args, device='cpu', **kw)
    want = np.asarray(getattr(JC, name)(*args, **kw).data)
    assert got.is_floating_point() == np.issubdtype(want.dtype, np.floating)


@pytest.mark.parametrize('name', ['zeros_like', 'ones_like', 'empty_like',
                                  'full_like', 'assign', 'clone', 'tril_',
                                  'diagflat', 'complex'])
def test_creation_op_on_a_tensor_matches_jax(name):
    x = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    args = {'full_like': (2.5,), 'complex': (x,)}.get(name, ())
    targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                  for a in args)
    jargs = tuple(Tensor(a) if isinstance(a, np.ndarray) else a
                  for a in args)
    assert_same(getattr(TC, name)(torch.from_numpy(x), *targs),
                getattr(JC, name)(Tensor(x), *jargs), what=name)


def test_to_tensor_and_creation_devices():
    t = TC.to_tensor([1.0, 2.0], place='cpu', stop_gradient=False)
    assert t.dtype == torch.float32 and t.requires_grad
    assert TC.to_tensor(np.arange(3), device='cpu').dtype == torch.int64
    assert TC.to_tensor([1, 2], dtype='int32', place='cpu').dtype == \
        torch.int32
    src = torch.ones(2)
    copy = TC.to_tensor(src, place='cpu')
    copy += 1
    assert float(src[0]) == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            TC.zeros([2])
        with pytest.raises(RuntimeError, match='no CUDA device'):
            TC.to_tensor([1.0], place='gpu')


# ---------------------------------------------------------------------------
# random
# ---------------------------------------------------------------------------
N = 20000
RANDOM = {
    'uniform': (lambda **g: TC.uniform([N], min=-2.0, max=4.0, **g),
                1.0, 36 / 12),
    'rand': (lambda **g: TC.rand([N], **g), 0.5, 1 / 12),
    'randn': (lambda **g: TC.randn([N], **g), 0.0, 1.0),
    'standard_normal': (lambda **g: TC.standard_normal([N], **g), 0.0, 1.0),
    'normal': (lambda **g: TC.normal(2.0, 3.0, [N], **g), 2.0, 9.0),
    'normal-tensor': (lambda **g: TC.normal(torch.full((N,), -1.0), 0.5,
                                            **g), -1.0, 0.25),
    'gaussian': (lambda **g: TC.gaussian([N], 1.0, 2.0, **g), 1.0, 4.0),
    'randint': (lambda **g: TC.randint(0, 10, [N], **g).float(), 4.5,
                99 / 12),
    'randint_like': (lambda **g: TC.randint_like(torch.zeros(N), 0, 4, **g)
                     .float(), 1.5, 15 / 12),
    'bernoulli': (lambda **g: TC.bernoulli(torch.full((N,), 0.3), **g),
                  0.3, 0.21),
    'poisson': (lambda **g: TC.poisson(torch.full((N,), 3.0), **g), 3.0,
                3.0),
    'multinomial': (lambda **g: TC.multinomial(
        torch.tensor([1.0, 3.0]), N, replacement=True, **g).float(), 0.75,
        0.1875),
    # N(0, 1) cut at ±2: variance 1 - 4·phi(2) / (2·Phi(2) - 1)
    'truncated_gaussian_random': (lambda **g: TC.truncated_gaussian_random(
        [N], **g), 0.0, 0.7737413),
}


@pytest.mark.parametrize('name', sorted(RANDOM))
def test_random_op_moments_and_reproducibility(name):
    draw, mean, var = RANDOM[name]
    default = torch.default_generator.get_state()
    kw = {} if name.endswith(('like', 'bernoulli', 'poisson', 'multinomial',
                              'tensor')) else {'device': 'cpu'}
    trng.seed(123)
    a = draw(**kw)
    b = draw(**kw)
    trng.seed(123)
    again = draw(**kw)
    assert torch.equal(a, again) and not torch.equal(a, b)
    gen = torch.Generator().manual_seed(5)
    g1 = draw(generator=gen, **kw)
    g2 = draw(generator=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(g1, g2)
    assert abs(float(a.mean()) - mean) < 5 * (var / N) ** 0.5
    assert abs(float(a.var()) - var) < 0.05 * var + 1e-3
    assert torch.equal(torch.default_generator.get_state(), default)


def test_randperm_shuffle_and_the_uniform_seed_argument():
    trng.seed(0)
    p = TC.randperm(50, device='cpu')
    assert p.dtype == torch.int64 and sorted(p.tolist()) == list(range(50))
    x = torch.arange(20.0).reshape(10, 2)
    s = TC.shuffle(x)
    assert sorted(s[:, 0].tolist()) == x[:, 0].tolist()
    assert torch.equal(s[:, 1] - s[:, 0], torch.ones(10))
    u1 = TC.uniform([5], seed=7, device='cpu')
    u2 = TC.uniform([5], seed=7, device='cpu')
    assert torch.equal(u1, u2)
    state = trng.get_rng_state()
    d1 = TC.randn([4], device='cpu')
    trng.set_rng_state(state)
    assert torch.equal(TC.randn([4], device='cpu'), d1)


# ---------------------------------------------------------------------------
# the reference's rules
# ---------------------------------------------------------------------------
def test_median_is_the_mean_of_the_two_middle_values():
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    assert float(TMa.median(torch.from_numpy(x))) == 2.5
    assert float(np.asarray(JMa.median(Tensor(x)).data)) == 2.5
    assert float(torch.median(torch.from_numpy(x))) == 2.0


def test_mode_breaks_ties_towards_the_smallest_value():
    x = np.array([[3, 1, 1, 3, 2], [5, 5, 4, 4, 9], [7, 0, 7, 0, 0]],
                 np.int32)
    want = np.asarray(JMa.mode(Tensor(x)).data)
    np.testing.assert_array_equal(TMa.mode(torch.from_numpy(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(want, [1, 4, 0])
    np.testing.assert_array_equal(
        TMa.mode(torch.from_numpy(x), axis=0, keepdim=True).numpy(),
        np.asarray(JMa.mode(Tensor(x), axis=0, keepdim=True).data))


def test_a_scalar_takes_the_tensors_dtype():
    x = np.array([1, 2], np.int32)
    got = TMa.add(torch.from_numpy(x), 1.5)
    want = np.asarray(JMa.add(paddle_tpu.to_tensor(x), 1.5).data)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [2, 3])
    assert (torch.from_numpy(x) + 1.5).dtype == torch.float32
    b = torch.ones(3, dtype=torch.bfloat16)
    assert TMa.multiply(b, 1.1).dtype == torch.bfloat16
    assert TMa.subtract(2.0, torch.ones(2)).tolist() == [1.0, 1.0]


def test_scatter_overwrite_false_zeroes_then_adds_duplicates():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([1, 1, 3], np.int32)
    up = np.ones((3, 3), np.float32)
    for ow in (False, True):
        i = idx if not ow else np.array([1, 0, 3], np.int32)
        want = np.asarray(JM.scatter(Tensor(x), Tensor(i), Tensor(up),
                                     overwrite=ow).data)
        got = TM.scatter(torch.from_numpy(x), torch.from_numpy(i),
                         torch.from_numpy(up), overwrite=ow)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[1], [1, 1, 1])


def test_index_outputs_are_int64_and_equal_by_value():
    x = np.random.RandomState(3).permutation(12).reshape(3, 4).astype(
        np.float32)
    got = TMa.argsort(torch.from_numpy(x))
    want = np.asarray(JMa.argsort(Tensor(x)).data)
    assert got.dtype == torch.int64 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# amp.auto_cast reaches the new ops as the reference's hook does
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('op,args', [
    ('matmul', ((4, 3), (3, 2))), ('exp', ((3,),)), ('add', ((3,), (3,))),
    ('sum', ((3,),)), ('sqrt', ((3,),))])
def test_auto_cast_casts_new_ops_as_the_reference(op, args):
    rs = np.random.RandomState(0)
    xs = [rs.rand(*s).astype(np.float32) for s in args]
    for inp_dtype in ('float32', 'bfloat16'):
        with jamp.auto_cast(level='O1', dtype='bfloat16'):
            want = getattr(JMa, op)(*[paddle_tpu.to_tensor(x).astype(
                inp_dtype) for x in xs])
        with tamp.auto_cast(level='O1', dtype='bfloat16'):
            got = getattr(TMa, op)(*[torch.from_numpy(x).to(
                getattr(torch, inp_dtype)) for x in xs])
        assert str(got.dtype).split('.')[-1] == str(want.dtype), \
            (op, inp_dtype)
