"""paddle_tpu_torch.ops.manip, .linalg and .fft against paddle_tpu's:
every public op, forward and (where differentiable) the VJP, on the same
seeded numpy inputs, at rtol 2e-4 / atol 2e-5 (fp32) unless a case says
otherwise.

Decompositions are held by reconstruction, not by their factors (whose
signs and order the two libraries pick differently): QR and SVD rebuild
x, eigh rebuilds x from its eigenvectors, eig's eigenvalues are compared
sorted. FFTs are compared forward, and their VJPs through the real part
of the result (a real function of a real input, whose gradient the two
frameworks define alike).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import fft as JF
from paddle_tpu.ops import linalg as JL
from paddle_tpu.ops import manip as J
from paddle_tpu_torch.ops import fft as TF
from paddle_tpu_torch.ops import linalg as TL
from paddle_tpu_torch.ops import manip as T
from torch_surface_util import FP32, check_op, rand

R = np.random.RandomState


def _x(*shape):
    return lambda r: [rand(r, *shape)]


def _idx(*shape, high=4):
    return lambda r: [rand(r, 5, 3), r.randint(0, high, shape)
                      .astype(np.int32)]


MANIP = {
    'cast': (_x(3, 4), dict(dtype='float64'), (0,)),
    'cast-int': (_x(3, 4), dict(dtype='int32'), ()),
    'reshape': (_x(2, 3, 4), dict(shape=[0, -1]), (0,)),
    'transpose': (_x(2, 3, 4), dict(perm=[2, 0, 1]), (0,)),
    'transpose_': (_x(2, 3), dict(perm=[1, 0]), (0,)),
    'moveaxis': (_x(2, 3, 4), dict(source=0, destination=2), (0,)),
    'swapaxes': (_x(2, 3, 4), dict(axis0=0, axis1=2), (0,)),
    'squeeze': (_x(2, 1, 3, 1), dict(axis=[1, 2]), (0,)),
    'squeeze-all': (_x(2, 1, 3, 1), {}, (0,)),
    'unsqueeze': (_x(2, 3), dict(axis=[0, 2]), (0,)),
    'flatten': (_x(2, 3, 4), dict(start_axis=1), (0,)),
    'split': (_x(6, 4), dict(num_or_sections=3), ()),
    'split-sections': (_x(6, 4), dict(num_or_sections=[2, -1, 1], axis=0),
                       ()),
    'chunk': (_x(6, 4), dict(chunks=2, axis=1), ()),
    'unstack': (_x(3, 4), dict(axis=1), ()),
    'unbind': (_x(3, 4), {}, ()),
    'tile': (_x(2, 3), dict(repeat_times=[2, 1, 2]), (0,)),
    'expand': (_x(3, 1), dict(shape=[2, -1, 4]), (0,)),
    'expand_as': (lambda r: [rand(r, 3, 1), rand(r, 2, 3, 4)], {}, (0,)),
    'broadcast_to': (_x(1, 4), dict(shape=[3, 4]), (0,)),
    'flip': (_x(3, 4), dict(axis=[0, 1]), (0,)),
    'roll': (_x(3, 4), dict(shifts=2, axis=1), (0,)),
    'roll-flat': (_x(3, 4), dict(shifts=5), (0,)),
    'rot90': (_x(3, 4), dict(k=1, axes=[0, 1]), (0,)),
    'gather': (_idx(2, 2), {}, (0,)),
    'gather-axis': (lambda r: [rand(r, 3, 5), np.array([4, 0, 2], np.int32)],
                    dict(axis=1), (0,)),
    'gather_nd': (lambda r: [rand(r, 4, 3, 2),
                             np.array([[0, 1], [3, 2], [1, 0]], np.int32)],
                  {}, (0,)),
    'take_along_axis': (lambda r: [rand(r, 3, 4), r.randint(0, 4, (3, 2))
                                   .astype(np.int32)], dict(axis=1), (0,)),
    'index_select': (_idx(4), dict(axis=0), (0,)),
    'index_sample': (lambda r: [rand(r, 3, 5), r.randint(0, 5, (3, 2))
                                .astype(np.int32)], {}, (0,)),
    'masked_select': (lambda r: [rand(r, 3, 4), r.rand(3, 4) > 0.5], {}, ()),
    'masked_fill': (lambda r: [rand(r, 3, 4), r.rand(3, 4) > 0.5],
                    dict(value=2.5), (0,)),
    'slice': (_x(4, 5), dict(axes=[0, 1], starts=[1, -3], ends=[10, -1]),
              (0,)),
    'strided_slice': (_x(6, 5), dict(axes=[0, 1], starts=[0, 4],
                                     ends=[6, 0], strides=[2, -1]), (0,)),
    'tril': (_x(4, 4), dict(diagonal=-1), (0,)),
    'triu': (_x(3, 4), dict(diagonal=1), (0,)),
    'diagonal': (_x(3, 4), dict(offset=1), (0,)),
    'unique': (lambda r: [r.randint(0, 5, 12).astype(np.int32)],
               dict(return_index=True, return_inverse=True,
                    return_counts=True), ()),
    'unique-axis': (lambda r: [r.randint(0, 2, (6, 2)).astype(np.float32)],
                    dict(return_counts=True, axis=0), ()),
    'unique_consecutive': (lambda r: [np.array([1, 1, 2, 2, 2, 3, 1, 1],
                                               np.int32)],
                           dict(return_inverse=True, return_counts=True), ()),
    'pad': (_x(2, 3, 4), dict(pad=[1, 2]), (0,)),
    'pad-all': (_x(2, 3), dict(pad=[1, 0, 2, 1], value=1.5), (0,)),
    'pad-reflect': (_x(1, 2, 5), dict(pad=[2, 1], mode='reflect'), (0,)),
    'one_hot': (lambda r: [r.randint(0, 5, (3, 2)).astype(np.int32)],
                dict(num_classes=5), ()),
    'shard_index': (lambda r: [r.randint(0, 20, (6, 1)).astype(np.int32)],
                    dict(index_num=20, nshards=2, shard_id=1), ()),
    'repeat_interleave': (_x(3, 2), dict(repeats=2, axis=0), (0,)),
    'as_real': (lambda r: [(rand(r, 3) + 1j * rand(r, 3))
                           .astype(np.complex64)], {}, ()),
    'as_complex': (_x(3, 2), {}, ()),
    'real': (lambda r: [(rand(r, 3) + 1j * rand(r, 3))
                        .astype(np.complex64)], {}, ()),
    'imag': (lambda r: [(rand(r, 3) + 1j * rand(r, 3))
                        .astype(np.complex64)], {}, ()),
    'numel': (_x(3, 4), {}, ()),
    'shape': (_x(3, 4), {}, ()),
    'space_to_depth': (_x(2, 3, 4, 6), dict(blocksize=2), (0,)),
    'pixel_shuffle': (_x(2, 8, 3, 3), dict(upscale_factor=2), (0,)),
    'put_along_axis': (lambda r: [rand(r, 3, 4), np.array([[1], [3], [0]],
                                                          np.int32),
                                  rand(r, 3, 1)], dict(axis=1), (0,)),
    'put_along_axis-add': (lambda r: [rand(r, 3, 4),
                                      np.array([[1, 1], [3, 0], [0, 2]],
                                               np.int32), rand(r, 3, 2)],
                           dict(axis=1, reduce='add'), (0,)),
    'scatter': (lambda r: [rand(r, 5, 3), np.array([3, 0, 4], np.int32),
                           rand(r, 3, 3)], {}, (0, 2)),
    'scatter-add_dups': (lambda r: [rand(r, 5, 3),
                                    np.array([3, 0, 3, 1], np.int32),
                                    rand(r, 4, 3)],
                         dict(overwrite=False), (0, 2)),
    'scatter_nd_add': (lambda r: [rand(r, 4, 3, 2),
                                  np.array([[0, 1], [3, 2], [0, 1]],
                                           np.int32), rand(r, 3, 2)],
                       {}, (0, 2)),
    'scatter_nd': (lambda r: [np.array([[1], [3], [1]], np.int32),
                              rand(r, 3, 2)], dict(shape=[5, 2]), (1,)),
}

_SPD = lambda r: [(lambda a: (a @ a.T + 4 * np.eye(4)).astype(np.float32))(
    rand(r, 4, 4))]
LINALG = {
    'cholesky': (_SPD, {}, (0,)),
    'cholesky-upper': (_SPD, dict(upper=True), (0,)),
    'inverse': (_SPD, {}, (0,)),
    'inv': (_SPD, {}, (0,)),
    'matrix_power': (_x(3, 3), dict(n=3), (0,)),
    'matrix_rank': (lambda r: [(rand(r, 5, 2) @ rand(r, 2, 4))], {}, ()),
    'det': (_x(3, 4, 4), {}, (0,)),
    'slogdet': (_x(4, 4), {}, ()),
    'pinv': (_x(5, 3), {}, (0,)),
    'solve': (lambda r: [_SPD(r)[0], rand(r, 4, 2)], {}, (0, 1)),
    'triangular_solve': (lambda r: [np.triu(_SPD(r)[0]), rand(r, 4, 2)],
                         {}, (0, 1)),
    'triangular_solve-lower_t': (lambda r: [np.tril(_SPD(r)[0]),
                                            rand(r, 4, 2)],
                                 dict(upper=False, transpose=True), (0, 1)),
    'cholesky_solve': (lambda r: [rand(r, 4, 2),
                                  np.linalg.cholesky(_SPD(r)[0])
                                  .astype(np.float32)], {}, (0,)),
    'lu': (_x(4, 4), {}, ()),
    'lstsq': (lambda r: [rand(r, 6, 3), rand(r, 6, 2)], {}, ()),
    'cond': (_SPD, {}, ()),
    'cov': (_x(3, 6), {}, ()),
    'corrcoef': (_x(3, 6), dict(rowvar=False), ()),
    'eigvalsh': (_SPD, {}, (0,)),
    'bilinear_tensor_product': (lambda r: [rand(r, 3, 4), rand(r, 3, 5),
                                           rand(r, 2, 4, 5), rand(r, 2)],
                                {}, (0, 1, 2, 3)),
}

FFT = {n: (_x(4, 6), {}, ()) for n in (
    'fft', 'ifft', 'rfft', 'ihfft', 'fftn', 'ifftn', 'rfftn', 'fftshift',
    'ifftshift')}
# the reference's 2-D transforms raise without `axes` (jnp's fft2 takes
# no None); the port's default to the last two
FFT.update({n: (_x(4, 6), dict(axes=(-2, -1)), ()) for n in (
    'fft2', 'ifft2', 'rfft2')})
FFT.update({
    'fft-n': (_x(4, 6), dict(n=8, axis=0, norm='ortho'), ()),
    'rfftn-axes': (_x(2, 4, 6), dict(axes=[0, 2], norm='forward'), ()),
    'hfft': (lambda r: [(rand(r, 4, 5) + 1j * rand(r, 4, 5))
                        .astype(np.complex64)], {}, ()),
    'irfft': (lambda r: [(rand(r, 4, 5) + 1j * rand(r, 4, 5))
                         .astype(np.complex64)], dict(n=8), ()),
    'irfft2': (lambda r: [(rand(r, 4, 5) + 1j * rand(r, 4, 5))
                          .astype(np.complex64)], dict(axes=(-2, -1)), ()),
    'irfftn': (lambda r: [(rand(r, 4, 5) + 1j * rand(r, 4, 5))
                          .astype(np.complex64)], {}, ()),
    'fftshift-axes': (_x(4, 6), dict(axes=[1]), ()),
})


def _rng(name):
    return R(zlib.crc32(name.encode()))


@pytest.mark.parametrize('name', sorted(MANIP))
def test_manip_op_matches_jax(name):
    build, kw, diff = MANIP[name]
    op = name.split('-')[0]
    check_op(getattr(J, op), getattr(T, op), build(_rng(name)), kw, diff,
             what=name)


@pytest.mark.parametrize('name', sorted(LINALG))
def test_linalg_op_matches_jax(name):
    build, kw, diff = LINALG[name]
    op = name.split('-')[0]
    bar = dict(rtol=1e-3, atol=1e-4) if op in ('pinv', 'cond', 'lstsq') \
        else FP32
    check_op(getattr(JL, op), getattr(TL, op), build(_rng(name)), kw, diff,
             bar=bar, what=name)


@pytest.mark.parametrize('name', sorted(FFT))
def test_fft_op_matches_jax(name):
    build, kw, diff = FFT[name]
    op = name.split('-')[0]
    check_op(getattr(JF, op), getattr(TF, op), build(_rng(name)), kw, diff,
             what=name)


@pytest.mark.parametrize('op', ['fft', 'rfft', 'fft2', 'rfftn', 'ihfft'])
def test_fft_vjp_through_the_real_part_matches_jax(op):
    x = rand(_rng(op), 4, 6)
    kw = dict(axes=(-2, -1)) if op == 'fft2' else {}
    check_op(lambda a: Tensor(jnp.real(getattr(JF, op)(a, **kw).data)),
             lambda a: torch.real(getattr(TF, op)(a, **kw)), [x], diff=(0,),
             what=op)


def test_fft2_defaults_to_the_last_two_axes():
    x = rand(_rng('fft2'), 3, 4, 6)
    want = np.fft.fft2(x)
    np.testing.assert_allclose(TF.fft2(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError):       # the reference's fault
        JF.fft2(Tensor(x))


def test_fftfreq_and_rfftfreq_match_jax():
    for op in ('fftfreq', 'rfftfreq'):
        want = np.asarray(getattr(JF, op)(8, 0.5).data)
        np.testing.assert_allclose(getattr(TF, op)(8, 0.5, device='cpu')
                                   .numpy(), want, **FP32)


def test_decompositions_rebuild_their_input():
    r = _rng('decomp')
    x = rand(r, 5, 3)
    t = torch.from_numpy(x)
    q, rr = TL.qr(t)
    np.testing.assert_allclose((q @ rr).numpy(), x, **FP32)
    jq, jr = JL.qr(Tensor(x))
    np.testing.assert_allclose(np.asarray(jq.data) @ np.asarray(jr.data), x,
                               **FP32)
    u, s, v = TL.svd(t)
    np.testing.assert_allclose((u * s) @ v.T, x, **FP32)
    np.testing.assert_allclose(s.numpy(), np.asarray(JL.svd(Tensor(x))[1]
                                                      .data), **FP32)
    a = _SPD(r)[0]
    w, vec = TL.eigh(torch.from_numpy(a))
    np.testing.assert_allclose(((vec * w) @ vec.T).numpy(), a, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(JL.eigh(Tensor(a))[0]
                                                     .data), **FP32)
    g = rand(r, 4, 4)
    tw, tv = TL.eig(torch.from_numpy(g))
    np.testing.assert_allclose((tv @ torch.diag_embed(tw) @
                                torch.linalg.inv(tv)).real.numpy(), g,
                               rtol=1e-3, atol=1e-4)
    jw = np.asarray(JL.eigvals(Tensor(g)).data)
    np.testing.assert_allclose(np.sort_complex(TL.eigvals(
        torch.from_numpy(g)).numpy()), np.sort_complex(jw), rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(np.sort_complex(tw.numpy()),
                               np.sort_complex(jw), rtol=1e-4, atol=1e-4)


def test_einsum_matches_jax():
    r = _rng('einsum')
    a, b = rand(r, 2, 3, 4), rand(r, 2, 4, 5)
    check_op(lambda x, y: JL.einsum('bij,bjk->bik', x, y),
             lambda x, y: TL.einsum('bij,bjk->bik', x, y), [a, b],
             diff=(0, 1), what='einsum')


def test_list_ops_match_jax():
    """The ops over a list of tensors: concat, stack, broadcast_tensors,
    meshgrid."""
    r = _rng('lists')
    xs = [rand(r, 2, 3), rand(r, 2, 3)]
    for op, kw in (('concat', dict(axis=1)), ('stack', dict(axis=0)),
                   ('broadcast_tensors', {}), ('meshgrid', {})):
        args = xs if op != 'meshgrid' else [rand(r, 3), rand(r, 4)]
        want = getattr(J, op)([Tensor(a) for a in args], **kw)
        got = getattr(T, op)([torch.from_numpy(a) for a in args], **kw)
        want = want if isinstance(want, list) else [want]
        got = got if isinstance(got, list) else [got]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w.data),
                                       err_msg=op)


def test_getitem_matches_jax():
    x = rand(_rng('getitem'), 4, 5)
    for idx in ((slice(1, 3), 2), (Ellipsis, slice(None, None, 2))):
        np.testing.assert_allclose(T.getitem(torch.from_numpy(x), idx)
                                   .numpy(),
                                   np.asarray(J.getitem(Tensor(x), idx).data))
