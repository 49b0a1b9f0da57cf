"""paddle_tpu_torch.ops.math against paddle_tpu.ops.math: every public
op, forward and (where differentiable) the VJP, on the same seeded numpy
inputs, at rtol 2e-4 / atol 2e-5 (fp32) unless a case says otherwise.

Ops whose reference runs on the host (mode, nonzero, histogram), or
returns indices, are compared forward only, indices by value. Sorting
ops (argsort, sort, topk, argmax, argmin) run on distinct values, where
the order is unique.
"""
import zlib

import numpy as np
import pytest
import torch

from paddle_tpu.ops import math as J
from paddle_tpu_torch.ops import math as T
from torch_surface_util import check_op, rand
from torch_threads import one_intra_op_thread  # noqa: F401

R = np.random.RandomState


def _x(low=None, high=None, shape=(3, 4)):
    return lambda r: [rand(r, *shape, low=low, high=high)]


def _xy(low=None, high=None, shape=(3, 4)):
    return lambda r: [rand(r, *shape, low=low, high=high),
                      rand(r, *shape, low=low, high=high)]


def _distinct(shape=(3, 5)):
    return lambda r: [r.permutation(np.prod(shape)).reshape(shape)
                      .astype(np.float32) / 7.0]


def _ints(low=0, high=9, shape=(3, 4), n=1):
    return lambda r: [r.randint(low, high, shape).astype(np.int32)
                      for _ in range(n)]


POS = dict(low=0.5, high=2.0)
UNIT = dict(low=-0.9, high=0.9)
UNARY = {
    'exp': {}, 'expm1': {}, 'log': POS, 'log2': POS, 'log10': POS,
    'log1p': POS, 'sqrt': POS, 'rsqrt': POS, 'square': {}, 'abs': {},
    'sign': {}, 'floor': {}, 'ceil': {}, 'round': {}, 'trunc': {},
    'reciprocal': POS, 'neg': {}, 'sin': {}, 'cos': {}, 'tan': UNIT,
    'asin': UNIT, 'acos': UNIT, 'atan': {}, 'sinh': {}, 'cosh': {},
    'tanh': {}, 'asinh': {}, 'acosh': dict(low=1.5, high=3.0),
    'atanh': UNIT, 'sigmoid': {}, 'erf': {}, 'lgamma': POS,
    'digamma': POS, 'frac': {}, 'rad2deg': {}, 'deg2rad': {}, 'stanh': {},
    'nan_to_num': {}, 'clip_by_norm': {}, 'assign': {}, 'cumsum_': {},
}
# (inputs, kwargs, differentiated argument indices)
CASES = {f'{n}': (_x(**r), {}, (0,)) for n, r in UNARY.items()}
CASES['clip_by_norm'] = (_x(), dict(max_norm=1.0), (0,))
CASES['cumsum_'] = (_x(), dict(axis=1), (0,))
CASES.update({
    **{n: (_xy(), {}, (0, 1)) for n in (
        'add', 'subtract', 'multiply', 'maximum', 'minimum', 'fmax', 'fmin',
        'atan2', 'hypot', 'multiply_', 'remainder', 'mod', 'floor_mod')},
    'divide': (_xy(**POS), {}, (0, 1)),
    'pow': (_xy(**POS), {}, (0, 1)),
    'floor_divide': (_xy(**POS), {}, ()),
    'heaviside': (_xy(), {}, ()),
    **{n: (_xy(), {}, ()) for n in (
        'equal', 'not_equal', 'less_than', 'less_equal', 'greater_than',
        'greater_equal', 'isclose', 'allclose', 'equal_all')},
    **{n: (lambda r: [r.rand(3, 4) > 0.5, r.rand(3, 4) > 0.5], {}, ())
       for n in ('logical_and', 'logical_or', 'logical_xor')},
    'logical_not': (lambda r: [r.rand(3, 4) > 0.5], {}, ()),
    **{n: (_ints(0, 64, n=2), {}, ()) for n in (
        'bitwise_and', 'bitwise_or', 'bitwise_xor', 'gcd', 'lcm')},
    'bitwise_not': (_ints(0, 64), {}, ()),
    **{n: (_x(), {}, ()) for n in ('isnan', 'isinf', 'isfinite')},
    'scale': (_x(), dict(scale=2.5, bias=0.5), (0,)),
    'scale-bias_first': (_x(), dict(scale=2.5, bias=0.5,
                                    bias_after_scale=False), (0,)),
    'clip': (_x(), dict(min=-0.5, max=0.7), (0,)),
    'increment': (_x(), dict(value=2.0), (0,)),
    'matmul': (lambda r: [rand(r, 2, 3, 4), rand(r, 2, 4, 5)], {}, (0, 1)),
    'matmul-transposed': (lambda r: [rand(r, 4, 3), rand(r, 5, 4)],
                          dict(transpose_x=True, transpose_y=True), (0, 1)),
    'mm': (lambda r: [rand(r, 3, 4), rand(r, 4, 2)], {}, (0, 1)),
    'bmm': (lambda r: [rand(r, 2, 3, 4), rand(r, 2, 4, 5)], {}, (0, 1)),
    'dot': (lambda r: [rand(r, 3, 4), rand(r, 3, 4)], {}, (0, 1)),
    'inner': (lambda r: [rand(r, 3, 4), rand(r, 2, 4)], {}, (0, 1)),
    'outer': (lambda r: [rand(r, 3), rand(r, 4)], {}, (0, 1)),
    'kron': (lambda r: [rand(r, 2, 3), rand(r, 3, 2)], {}, (0, 1)),
    'cross': (lambda r: [rand(r, 4, 3), rand(r, 4, 3)], {}, (0, 1)),
    'mv': (lambda r: [rand(r, 3, 4), rand(r, 4)], {}, (0, 1)),
    'addmm': (lambda r: [rand(r, 3, 2), rand(r, 3, 4), rand(r, 4, 2)],
              dict(beta=0.5, alpha=2.0), (0, 1, 2)),
    'tensordot': (lambda r: [rand(r, 3, 4, 5), rand(r, 4, 5, 2)],
                  dict(axes=2), (0, 1)),
    'lerp': (lambda r: [rand(r, 3, 4), rand(r, 3, 4), 0.3], {}, (0, 1)),
    'trace': (lambda r: [rand(r, 4, 4)], dict(offset=1), (0,)),
    'diag-vector': (lambda r: [rand(r, 4)], dict(offset=1,
                                                 padding_value=2.0), (0,)),
    'diag-matrix': (lambda r: [rand(r, 4, 5)], dict(offset=-1), (0,)),
    'diag_embed': (lambda r: [rand(r, 2, 3)], {}, (0,)),
    'count_nonzero': (lambda r: [np.where(r.rand(3, 4) > 0.5, 1.0, 0.0)
                                 .astype(np.float32)], dict(axis=1), ()),
    'histogram': (_x(), dict(bins=7), ()),
    'histogram-range': (_x(), dict(bins=5, min=-1, max=1), ()),
    'bincount': (_ints(0, 6, shape=(20,)), dict(minlength=8), ()),
    'bincount-weights': (lambda r: [r.randint(0, 6, 20).astype(np.int32),
                                    rand(r, 20)], {}, ()),
    'bucketize': (lambda r: [rand(r, 3, 4), np.sort(rand(r, 6))], {}, ()),
    'bucketize-right': (lambda r: [np.array([0., 1, 2, 5], np.float32),
                                   np.array([0., 1, 2, 3], np.float32)],
                        dict(right=True), ()),
    'searchsorted': (lambda r: [np.sort(rand(r, 6)), rand(r, 3, 4)], {}, ()),
    'take': (lambda r: [rand(r, 3, 4),
                        np.array([[0, 5], [11, 40], [-3, 2]], np.int32)],
             {}, (0,)),
    'renorm': (lambda r: [rand(r, 3, 4)], dict(p=2, axis=0, max_norm=1.0),
               (0,)),
    'diff': (_x(), dict(n=1, axis=1), (0,)),
    'diff-prepend': (_x(), dict(axis=1, prepend=np.full((3, 1), 0.5,
                                                        np.float32)), (0,)),
    'trapezoid': (_x(), {}, (0,)),
    'trapezoid-dx': (_x(), dict(dx=0.5, axis=0), (0,)),
    'vander': (lambda r: [rand(r, 4)], dict(n=3), (0,)),
    'angle': (_x(), {}, ()),
    'conj': (_x(), {}, (0,)),
    'crop': (lambda r: [rand(r, 4, 5)], dict(shape=[2, -1],
                                             offsets=[1, 0]), (0,)),
    'where': (lambda r: [r.rand(3, 4) > 0.5, rand(r, 3, 4), rand(r, 3, 4)],
              {}, (1, 2)),
    'where-index': (lambda r: [r.rand(3, 4) > 0.5], {}, ()),
    'nonzero': (lambda r: [np.where(r.rand(3, 4) > 0.5, 1, 0)
                           .astype(np.int32)], {}, ()),
    'nonzero-tuple': (lambda r: [np.where(r.rand(3, 4) > 0.5, 1, 0)
                                 .astype(np.int32)], dict(as_tuple=True), ()),
    'dist-2': (_xy(), dict(p=2), (0, 1)),
    'dist-1': (_xy(), dict(p=1), (0, 1)),
    'dist-inf': (_xy(), dict(p=float('inf')), (0, 1)),
    'dist-0': (_xy(), dict(p=0), ()),
    'norm-fro': (_x(), {}, (0,)),
    'norm-p1': (_x(), dict(p=1), (0,)),
    'norm-axis': (_x(), dict(p=2, axis=1, keepdim=True), (0,)),
    'norm-matrix': (lambda r: [rand(r, 2, 3, 4)],
                    dict(p='fro', axis=[1, 2]), (0,)),
    'argmax': (_distinct(), dict(axis=1, keepdim=True), ()),
    'argmin': (_distinct(), {}, ()),
    'argsort': (_distinct(), dict(axis=1, descending=True), ()),
    'sort': (_distinct(), dict(axis=0), (0,)),
    'sort-descending': (_distinct(), dict(axis=1, descending=True), (0,)),
    'topk': (_distinct(), dict(k=2), (0,)),
    'topk-smallest': (_distinct(), dict(k=2, axis=0, largest=False), (0,)),
    'median-odd': (_distinct((3, 5)), dict(axis=1), (0,)),
    'median-even': (_distinct((3, 4)), dict(axis=1, keepdim=True), (0,)),
    'median-all': (_distinct((2, 4)), {}, (0,)),
    'quantile': (_distinct((3, 5)), dict(q=0.3, axis=1), (0,)),
    'quantile-list': (_distinct((3, 5)), dict(q=np.array([0.25, 0.5]), axis=0),
                      (0,)),
    'quantile-all': (_distinct((3, 5)), dict(q=0.9, keepdim=True), (0,)),
    'mode': (lambda r: [r.randint(0, 4, (3, 7)).astype(np.float32)],
             dict(axis=1), ()),
    'std': (_x(), dict(axis=1), (0,)),
    'std-biased': (_x(), dict(unbiased=False, keepdim=True), (0,)),
    'var': (_x(), dict(axis=[0, 1]), (0,)),
    'cumsum': (_x(), dict(axis=1), (0,)),
    'cumsum-flat': (_x(), {}, (0,)),
    'cumprod': (_x(), dict(dim=0), (0,)),
    'logcumsumexp': (_x(), dict(axis=1), (0,)),
    'all': (lambda r: [r.rand(3, 4) > 0.2], dict(axis=1), ()),
    'any': (lambda r: [r.rand(3, 4) > 0.8], dict(axis=[0, 1]), ()),
    'multiplex': (lambda r: [[rand(r, 3, 4), rand(r, 3, 4)],
                             np.array([[1], [0], [1]], np.int32)], {}, ()),
})
for _red in ('sum', 'mean', 'max', 'min', 'prod', 'amax', 'amin', 'nansum',
             'nanmean', 'logsumexp'):
    CASES[_red] = (_distinct(), {}, (0,))
    CASES[f'{_red}-axis'] = (_distinct(), dict(axis=1, keepdim=True), (0,))
    CASES[f'{_red}-axes'] = (_distinct((2, 3, 4)), dict(axis=[0, 2]), (0,))


def _run(name, jfn, tfn):
    build, kw, diff = CASES[name]
    arrays = build(R(zlib.crc32(name.encode())))
    if name == 'multiplex':     # a list of tensors as one argument
        import paddle_tpu.core.tensor as JT
        want = jfn([JT.Tensor(a) for a in arrays[0]], JT.Tensor(arrays[1]))
        got = tfn([torch.from_numpy(a) for a in arrays[0]],
                  torch.from_numpy(arrays[1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want.data))
        return
    check_op(jfn, tfn, arrays, kw, diff, what=name,
             out_index=0 if name.startswith('topk') else None)


def _raw_cumsum(a, axis):
    """The reference's `cumsum_` is a lambda over jnp arrays."""
    from paddle_tpu.core.tensor import Tensor
    return Tensor(J.cumsum_(a.data, axis))


@pytest.mark.parametrize('name', sorted(CASES))
def test_math_op_matches_jax(name):
    op = name.split('-')[0]
    _run(name, _raw_cumsum if op == 'cumsum_' else getattr(J, op),
         getattr(T, op))


def test_reductions_of_ints_keep_values():
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    for op in ('sum', 'prod', 'max', 'min', 'cumsum'):
        want = np.asarray(getattr(J, op)(
            __import__('paddle_tpu').to_tensor(x), axis=1).data)
        got = getattr(T, op)(torch.from_numpy(x), axis=1).numpy()
        np.testing.assert_array_equal(got, want, err_msg=op)
    assert T.mean(torch.from_numpy(x)).dtype == torch.float32
