"""The port's transposed convolutions, channels-last layouts and
convolution layers against paddle_tpu's, forward and the VJP, on the
same seeded numpy inputs, at rtol 2e-4 / atol 2e-5 (fp32).

The transposes without groups are held against the reference's
`conv{1,2,3}d_transpose`; where the port follows PaddlePaddle rather
than the reference, against an oracle built from the reference's
correct parts, each beside a check that shows the reference's fault:
- a channels-last (NLC, NHWC, NDHWC) convolution or 2-D pool equals the
  reference's channels-first op on the transposed input, transposed
  back, with PaddlePaddle's [O, I/g, k...] weight in both layouts (the
  reference asks for HWIO in NHWC, refuses NLC, reads NDHWC as NCDHW,
  and pools NHWC over W and C);
- a grouped `conv2d_transpose` equals the concatenation of the
  reference's per-group transposes with groups=1 (the reference's
  grouped transpose raises).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import nn_ops as J
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import nn_ops as T
from torch_surface_util import FP32, check_op, rand
from torch_threads import one_intra_op_thread  # noqa: F401

R = np.random.RandomState


# ---------------------------------------------------------------------------
# transposed convolutions against the reference
# ---------------------------------------------------------------------------
TRANSPOSE = {
    '2d': (J.conv2d_transpose, T.conv2d_transpose, (2, 4, 5, 6),
           (4, 3, 3, 3), dict(stride=2, padding=1)),
    '2d-opad': (J.conv2d_transpose, T.conv2d_transpose, (2, 4, 5, 6),
                (4, 3, 3, 2), dict(stride=2, padding=[1, 0],
                                   output_padding=1)),
    '2d-dilation': (J.conv2d_transpose, T.conv2d_transpose, (1, 4, 5, 5),
                    (4, 2, 3, 3), dict(stride=1, padding=2, dilation=2)),
    '2d-asymmetric': (J.conv2d_transpose, T.conv2d_transpose, (1, 4, 5, 5),
                      (4, 2, 3, 3), dict(stride=2, padding=[1, 0, 0, 2])),
    '3d': (J.conv3d_transpose, T.conv3d_transpose, (1, 4, 3, 4, 5),
           (4, 2, 3, 3, 2), dict(stride=2, padding=1)),
    '3d-groups': (J.conv3d_transpose, T.conv3d_transpose, (1, 4, 3, 4, 5),
                  (4, 3, 3, 2, 3), dict(stride=[1, 2, 1], padding=0,
                                        groups=2, output_padding=0)),
    '3d-output_size': (J.conv3d_transpose, T.conv3d_transpose,
                       (1, 2, 3, 3, 3), (2, 2, 2, 2, 2),
                       dict(stride=2, output_size=7)),
    '1d': (J.conv1d_transpose, T.conv1d_transpose, (2, 4, 7), (4, 3, 3),
           dict(stride=2, padding=1, output_padding=1)),
    '1d-output_size': (J.conv1d_transpose, T.conv1d_transpose, (2, 4, 7),
                       (4, 3, 3), dict(stride=3, output_size=21)),
}


@pytest.mark.parametrize('name', sorted(TRANSPOSE))
def test_conv_transpose_matches_jax(name):
    jfn, tfn, xs, ws, kw = TRANSPOSE[name]
    r = R(len(name))
    arrays = [rand(r, *xs), rand(r, *ws), rand(r, ws[1] * kw.get('groups', 1))]
    check_op(lambda *a: jfn(*a, **kw), lambda *a: tfn(*a, **kw), arrays,
             diff=(0, 1, 2), what=name)


def test_grouped_conv2d_transpose_is_the_concatenation_of_its_groups():
    r = R(3)
    x, w, b = rand(r, 2, 6, 4, 5), rand(r, 6, 2, 3, 3), rand(r, 6)
    kw = dict(stride=2, padding=1, output_padding=1)
    parts = [np.asarray(J.conv2d_transpose(
        Tensor(x[:, 2 * g:2 * g + 2]), Tensor(w[2 * g:2 * g + 2]),
        Tensor(b[2 * g:2 * g + 2]), **kw).data) for g in range(3)]
    want = np.concatenate(parts, axis=1)
    got = T.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), groups=3, **kw)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    with pytest.raises(Exception):      # the reference's fault
        J.conv2d_transpose(Tensor(x), Tensor(w), Tensor(b), groups=3, **kw)


def test_conv2d_transpose_output_size_picks_the_output_padding():
    r = R(4)
    x, w, b = rand(r, 2, 4, 5, 6), rand(r, 4, 3, 3, 3), rand(r, 3)
    kw = dict(stride=2, padding=1)
    want = J.conv2d_transpose(Tensor(x), Tensor(w), Tensor(b),
                              output_padding=1, **kw)
    got = T.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), output_size=[10, 12], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data), **FP32)
    # the reference's 2-D transpose drops output_size
    ref = J.conv2d_transpose(Tensor(x), Tensor(w), Tensor(b),
                             output_size=[10, 12], **kw)
    assert tuple(ref.shape) == (2, 3, 9, 11)


# ---------------------------------------------------------------------------
# channels-last layouts against the channels-first reference
# ---------------------------------------------------------------------------
def _last(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


def _ref_conv1d(x, w, b=None, stride=1, padding=0, groups=1):
    """The reference's conv1d through its 2-D form (its own conv1d
    raises on any int padding: it nests the (low, high) pairs twice)."""
    out = J.conv2d(Tensor(x.data[..., None]), Tensor(w.data[..., None]), b,
                   stride=(stride, 1), padding=[padding, padding, 0, 0],
                   groups=groups)
    return Tensor(out.data[..., 0])


LAYOUTS = {
    'conv2d-NHWC': (J.conv2d, T.conv2d, (2, 3, 7, 6), (4, 3, 3, 3),
                    dict(stride=2, padding=1), 'NHWC'),
    'conv2d-NHWC-groups': (J.conv2d, T.conv2d, (1, 4, 6, 6), (6, 2, 3, 3),
                           dict(padding='SAME', groups=2), 'NHWC'),
    'conv1d-NLC': (_ref_conv1d, T.conv1d, (2, 3, 9), (4, 3, 3),
                   dict(stride=2, padding=1), 'NLC'),
    'conv3d-NDHWC': (J.conv3d, T.conv3d, (1, 4, 4, 5, 6), (4, 2, 3, 3, 3),
                     dict(padding=1, groups=2), 'NDHWC'),
    'conv2d_transpose-NHWC': (J.conv2d_transpose, T.conv2d_transpose,
                              (2, 4, 5, 6), (4, 3, 3, 3),
                              dict(stride=2, padding=1), 'NHWC'),
    'conv1d_transpose-NLC': (J.conv1d_transpose, T.conv1d_transpose,
                             (2, 4, 7), (4, 3, 3), dict(stride=2), 'NLC'),
}


@pytest.mark.parametrize('name', sorted(LAYOUTS))
def test_channels_last_conv_is_the_channels_first_reference(name):
    jfn, tfn, xs, ws, kw, fmt = LAYOUTS[name]
    r = R(len(name))
    bias_n = ws[1] * kw.get('groups', 1) if 'transpose' in name else ws[0]
    x, w, b = rand(r, *xs), rand(r, *ws), rand(r, bias_n)

    def oracle(xl, wt, bt):
        out = jfn(Tensor(jnp.moveaxis(xl.data, -1, 1)), wt, bt, **kw)
        return Tensor(jnp.moveaxis(out.data, 1, -1))
    check_op(oracle, lambda *a: tfn(*a, data_format=fmt, **kw),
             [_last(x), w, b], diff=(0, 1, 2), what=name)


def test_the_references_channels_last_faults():
    r = R(9)
    x, w = rand(r, 2, 3, 6, 6), rand(r, 4, 3, 2, 2)
    with pytest.raises(ValueError):
        J.conv2d(Tensor(_last(x)), Tensor(w), data_format='NHWC')
    with pytest.raises(Exception):
        J.conv1d(Tensor(_last(rand(r, 2, 3, 8))), Tensor(rand(r, 4, 3, 3)),
                 data_format='NLC')
    with pytest.raises(Exception):      # any padding of its 2-D form
        J.conv1d(Tensor(rand(r, 2, 3, 8)), Tensor(rand(r, 4, 3, 3)),
                 padding=1)
    pooled = J.max_pool2d(Tensor(rand(r, 2, 6, 6, 4)), 2, data_format='NHWC')
    assert tuple(pooled.shape) == (2, 6, 3, 2)
    assert tuple(T.max_pool2d(torch.from_numpy(rand(r, 2, 6, 6, 4)), 2,
                              data_format='NHWC').shape) == (2, 3, 3, 4)
    x3, w3 = rand(r, 1, 4, 5, 6, 2), rand(r, 3, 2, 1, 1, 1)
    with pytest.raises(Exception):      # reads NDHWC as NCDHW
        J.conv3d(Tensor(x3), Tensor(w3), data_format='NDHWC')


POOLS = {
    'max_pool2d': (J.max_pool2d, T.max_pool2d,
                   dict(kernel_size=3, stride=2, padding=1)),
    'max_pool2d-mask': (J.max_pool2d, T.max_pool2d,
                        dict(kernel_size=2, return_mask=True)),
    'avg_pool2d': (J.avg_pool2d, T.avg_pool2d,
                   dict(kernel_size=3, stride=2, padding=1)),
    'avg_pool2d-inclusive': (J.avg_pool2d, T.avg_pool2d,
                             dict(kernel_size=2, exclusive=False)),
    'adaptive_avg_pool2d': (J.adaptive_avg_pool2d, T.adaptive_avg_pool2d,
                            dict(output_size=3)),
}


@pytest.mark.parametrize('name', sorted(POOLS))
def test_nhwc_pool_is_the_nchw_reference(name):
    jfn, tfn, kw = POOLS[name]
    x = rand(R(len(name)), 2, 3, 6, 6)

    def oracle(xl):
        out = jfn(Tensor(jnp.moveaxis(xl.data, -1, 1)), **kw)
        outs = out if isinstance(out, (tuple, list)) else [out]
        res = [Tensor(jnp.moveaxis(o.data, 1, -1)) for o in outs]
        return tuple(res) if len(res) > 1 else res[0]
    check_op(oracle, lambda a: tfn(a, data_format='NHWC', **kw), [_last(x)],
             diff=() if 'mask' in name else (0,), what=name)


def test_nhwc_takes_the_channels_last_memory_format_without_a_copy():
    x = torch.randn(2, 5, 6, 3)
    cf = T._channels_first(x, True)
    assert cf.data_ptr() == x.data_ptr()
    assert cf.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
LAYERS = {
    'Conv3D': (dict(in_channels=2, out_channels=4, kernel_size=3,
                    padding=1), (1, 2, 4, 5, 5)),
    'Conv2DTranspose': (dict(in_channels=4, out_channels=3, kernel_size=3,
                             stride=2, padding=1), (2, 4, 5, 5)),
    'Conv3DTranspose': (dict(in_channels=2, out_channels=3, kernel_size=2,
                             stride=2), (1, 2, 3, 3, 3)),
}


@pytest.mark.parametrize('name', sorted(LAYERS))
def test_conv_layer_matches_jax_on_bridged_weights(name):
    kw, xs = LAYERS[name]
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw,
                                                          device='cpu')
    assert tuple(tl.weight.shape) == tuple(jl.weight.shape)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight.data)))
        tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias.data)))
    x = rand(R(1), *xs)
    check_op(lambda a: jl(a), lambda a: tl(a), [x], diff=(0,), what=name)


def test_conv1d_layer_matches_the_references_2d_form():
    layer = tnn.Conv1D(4, 6, 3, stride=2, padding=1, groups=2,
                       data_format='NLC', device='cpu')
    assert tuple(layer.weight.shape) == (6, 2, 3)
    w = np.asarray(layer.weight.detach())
    b = np.asarray(layer.bias.detach())
    x = rand(R(2), 2, 4, 9)
    check_op(lambda a: Tensor(jnp.moveaxis(_ref_conv1d(
        Tensor(jnp.moveaxis(a.data, -1, 1)), Tensor(w), Tensor(b), 2, 1,
        2).data, 1, -1)), lambda a: layer(a), [_last(x)], diff=(0,))
    with pytest.raises(Exception):      # the reference's own layer
        jnn.Conv1D(4, 6, 3, padding=1, groups=2)(Tensor(x))


def test_conv1d_transpose_layer_and_output_size():
    layer = tnn.Conv1DTranspose(4, 6, 3, stride=2, groups=2, device='cpu')
    assert tuple(layer.weight.shape) == (4, 3, 3)
    x = torch.randn(2, 4, 7)
    assert layer(x).shape == (2, 6, 15)
    assert layer(x, output_size=16).shape == (2, 6, 16)
    t2 = tnn.Conv2DTranspose(4, 6, 3, stride=2, data_format='NHWC',
                             device='cpu')
    assert t2(torch.randn(1, 5, 5, 4), output_size=[12, 11]).shape == \
        (1, 12, 11, 6)
    with pytest.raises(ValueError, match='unreachable'):
        t2(torch.randn(1, 5, 5, 4), output_size=[14, 14])


def test_conv_layers_default_init_is_the_references_xavier():
    g = torch.Generator().manual_seed(0)
    layer = tnn.Conv3DTranspose(8, 4, 3, groups=2, generator=g)
    assert tuple(layer.weight.shape) == (8, 2, 3, 3, 3)
    fan_in, fan_out = 4 * 27, 8 * 27
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    w = layer.weight.detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.9 * limit
    assert tnn.Conv1D(3, 4, 3, bias_attr=False).bias is None
