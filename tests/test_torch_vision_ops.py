"""paddle_tpu_torch's convolution, pooling, batch norm and activations
against `paddle_tpu.ops.nn_ops` on the same seeded numpy inputs.

Each case runs the reference op eagerly on JAX arrays and its gradients
through `jax.vjp` of the same op, and the port's op on CPU tensors and
its gradients through autograd, with the same cotangent.

Tolerances: the round's fp32 bars, rtol 2e-4 / atol 2e-5 (summation
order), except bf16 batch norm. There the reference normalises in bf16
with its fp32 statistics rounded to bf16 (nn_ops.py:313) and the port in
fp32 with one rounding at the end (ATen's batch norm), so outputs are
held at 2^-6 relative to the largest |output| (a few bf16 roundings of
values of size ~3) and the running statistics, fp32 on both sides, at
the fp32 bars.

The 2-D pools' `ceil_mode` follows PaddlePaddle, not the reference's 2-D
pools (which ignore it): it is held against the reference's 3-D pools
over a depth-1 volume with a (1, k, k) window, which run `_pool_nd`'s
high-side padding rule; non-divisible adaptive max pooling (which the
reference's 2-D op refuses) against its 3-D adaptive max pool the same
way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import nn_ops as J
from paddle_tpu_torch.distributed.fleet.utils import recompute as tremat
from paddle_tpu_torch.ops import nn_ops as T
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-4, atol=2e-5)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _jax_vjp(fn, arrays, cot=None, seed=7):
    """(output, gradients of sum(output * cot)) of the reference op
    `fn(*Tensors)`; cot is drawn from `seed` when not given."""
    def f(*xs):
        with no_grad():
            return fn(*[Tensor(x) for x in xs]).data
    out, vjp = jax.vjp(f, *[jnp.asarray(a) for a in arrays])
    if cot is None:
        cot = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))], cot


def _torch_vjp(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check_vjp(jfn, tfn, arrays):
    jo, jg, cot = _jax_vjp(jfn, arrays)
    to, tg = _torch_vjp(tfn, arrays, cot)
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, **FP32)
    for i, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(a, b, err_msg=f'grad {i}', **FP32)


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------
CONV_CASES = {
    'pad0': dict(k=3),
    'pad1_stride2': dict(k=3, stride=2, padding=1),
    'per_dim': dict(k=3, padding=[1, 2]),
    'low_high': dict(k=3, padding=[1, 0, 2, 1]),
    'same_stride1': dict(k=3, padding='SAME'),
    'same_stride2': dict(k=3, stride=2, padding='same'),
    'same_stride2_even_k': dict(k=4, stride=2, padding='SAME'),
    'valid_stride2': dict(k=3, stride=2, padding='VALID'),
    'dilation2': dict(k=3, padding=2, dilation=2),
    'dilation_same': dict(k=3, stride=2, padding='SAME', dilation=2),
    'groups2': dict(k=3, padding=1, groups=2),
    'depthwise': dict(k=3, stride=2, padding=1, groups=4, cout=4),
    'bias_1x1': dict(k=1, bias=True),
    'bias_7x7_stride2': dict(k=7, stride=2, padding=3, bias=True),
}


@pytest.mark.parametrize('case', sorted(CONV_CASES))
def test_conv2d_forward_and_grads_match_jax(case):
    c = CONV_CASES[case]
    rng = np.random.RandomState(len(case))
    g, cout, k = c.get('groups', 1), c.get('cout', 6), c['k']
    x = _rand(rng, 2, 4, 9, 10)
    w = _rand(rng, cout, 4 // g, k, k) * 0.3
    kw = dict(stride=c.get('stride', 1), padding=c.get('padding', 0),
              dilation=c.get('dilation', 1), groups=g)
    arrays = [x, w] + ([_rand(rng, cout)] if c.get('bias') else [])
    _check_vjp(lambda *a: J.conv2d(*a, **kw), lambda *a: T.conv2d(*a, **kw),
               arrays)


@pytest.mark.parametrize('padding', [1, 'SAME', [2]])
def test_conv1d_matches_jax_through_its_2d_form(padding):
    rng = np.random.RandomState(3)
    x, w, b = _rand(rng, 2, 4, 11), _rand(rng, 5, 4, 3), _rand(rng, 5)
    want = np.asarray(J.conv2d(
        Tensor(jnp.asarray(x[..., None])), Tensor(jnp.asarray(w[..., None])),
        Tensor(jnp.asarray(b)), stride=(2, 1),
        padding=padding if isinstance(padding, str) else
        [int(np.ravel(padding)[0])] * 2 + [0, 0]).data)[..., 0]
    got = T.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), stride=2, padding=padding)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize('padding', [1, 'SAME', [0, 1, 1, 1, 2, 0]])
def test_conv3d_matches_jax(padding):
    rng = np.random.RandomState(4)
    x, w, b = _rand(rng, 2, 4, 5, 6, 7), _rand(rng, 4, 2, 3, 3, 3), \
        _rand(rng, 4)
    kw = dict(stride=2, padding=padding, groups=2)
    _check_vjp(lambda *a: J.conv3d(*a, **kw), lambda *a: T.conv3d(*a, **kw),
               [x, w, b])


def test_conv2d_refuses_channels_last():
    """NHWC takes PaddlePaddle's [O, C, kh, kw] weight and equals the
    reference's NCHW convolution on the transposed input (the
    reference's own NHWC asks for an HWIO weight)."""
    rng = np.random.RandomState(6)
    x, w, b = _rand(rng, 2, 3, 6, 5), _rand(rng, 4, 3, 3, 3), _rand(rng, 4)
    kw = dict(stride=2, padding=1)
    want = np.asarray(J.conv2d(Tensor(x), Tensor(w), Tensor(b), **kw).data)
    got = T.conv2d(torch.from_numpy(np.ascontiguousarray(x.transpose(
        0, 2, 3, 1))), torch.from_numpy(w), torch.from_numpy(b),
        data_format='NHWC', **kw)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 3, 1),
                               **FP32)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
MAX_CASES = {
    'resnet_stem': dict(k=3, s=2, p=1),
    'lenet': dict(k=2, s=2, p=0),
    'stride_default': dict(k=2, s=None, p=0),
    'wide_pad': dict(k=3, s=1, p=[2, 2]),
    'low_high': dict(k=3, s=2, p=[0, 1, 1, 0]),
    'rect': dict(k=(2, 3), s=(1, 2), p=[1, 1]),
}


@pytest.mark.parametrize('case', sorted(MAX_CASES))
def test_max_pool2d_and_its_mask_match_jax(case):
    c = MAX_CASES[case]
    rng = np.random.RandomState(11)
    x = _rand(rng, 2, 3, 9, 10)
    kw = dict(kernel_size=c['k'], stride=c['s'], padding=c['p'])
    _check_vjp(lambda a: J.max_pool2d(a, **kw),
               lambda a: T.max_pool2d(a, **kw), [x])
    to, tidx = T.max_pool2d(torch.from_numpy(x), return_mask=True, **kw)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(
        to.numpy(), T.max_pool2d(torch.from_numpy(x), **kw).numpy())
    # each index points at its window's maximum in the unpadded H·W map
    flat = torch.from_numpy(x).flatten(2)
    np.testing.assert_array_equal(
        flat.gather(2, tidx.flatten(2).long()).numpy(),
        to.flatten(2).numpy())
    # the reference's masked route takes its patches with a product, so
    # a window that touches the -inf padding gives NaN there (a fault
    # the port does not copy, ROADMAP Queue 3); elsewhere it must agree
    jo, jidx = J.max_pool2d(Tensor(jnp.asarray(x)), return_mask=True, **kw)
    jo, jidx = np.asarray(jo.data), np.asarray(jidx.data)
    real = ~np.isnan(jo)
    assert real.all() == (c['p'] == 0)
    np.testing.assert_array_equal(to.numpy()[real], jo[real])
    np.testing.assert_array_equal(tidx.numpy()[real], jidx[real])


def test_max_pool2d_same_padding_matches_jax_and_refuses_a_mask():
    x = _rand(np.random.RandomState(12), 2, 3, 9, 10)
    want = J.max_pool2d(Tensor(jnp.asarray(x)), 3, 2, 'SAME')
    got = T.max_pool2d(torch.from_numpy(x), 3, 2, 'SAME')
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))
    with pytest.raises(NotImplementedError, match='explicit padding'):
        T.max_pool2d(torch.from_numpy(x), 3, 2, 'SAME', return_mask=True)


AVG_CASES = {
    'pad1_exclusive': dict(k=3, s=2, p=1, exclusive=True),
    'pad1_inclusive': dict(k=3, s=2, p=1, exclusive=False),
    'no_pad': dict(k=2, s=2, p=0, exclusive=True),
    'low_high_exclusive': dict(k=3, s=2, p=[0, 1, 2, 1], exclusive=True),
    'low_high_inclusive': dict(k=3, s=2, p=[0, 1, 2, 1], exclusive=False),
    'wide_pad_exclusive': dict(k=3, s=1, p=2, exclusive=True),
    'same': dict(k=3, s=2, p='SAME', exclusive=True),
    'divisor': dict(k=3, s=2, p=1, exclusive=True, divisor_override=4),
    'divisor_low_high': dict(k=3, s=2, p=[1, 0, 0, 2], divisor_override=5),
}


@pytest.mark.parametrize('case', sorted(AVG_CASES))
def test_avg_pool2d_matches_jax(case):
    c = dict(AVG_CASES[case])
    kw = dict(kernel_size=c.pop('k'), stride=c.pop('s'), padding=c.pop('p'),
              **c)
    x = _rand(np.random.RandomState(13), 2, 3, 9, 10)
    _check_vjp(lambda a: J.avg_pool2d(a, **kw),
               lambda a: T.avg_pool2d(a, **kw), [x])


@pytest.mark.parametrize('hw,out', [((8, 12), (4, 3)), ((10, 7), (3, 5)),
                                    ((7, 7), 1), ((9, 6), (None, 4))])
def test_adaptive_avg_pool2d_matches_jax(hw, out):
    x = _rand(np.random.RandomState(14), 2, 3, *hw)
    _check_vjp(lambda a: J.adaptive_avg_pool2d(a, out),
               lambda a: T.adaptive_avg_pool2d(a, out), [x])


def test_adaptive_max_pool2d_divisible_matches_jax_with_its_mask():
    x = _rand(np.random.RandomState(15), 2, 3, 8, 12)
    jo, jidx = J.adaptive_max_pool2d(Tensor(jnp.asarray(x)), (4, 3),
                                     return_mask=True)
    to, tidx = T.adaptive_max_pool2d(torch.from_numpy(x), (4, 3),
                                     return_mask=True)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo.data))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx.data))


@pytest.mark.parametrize('hw,out', [((10, 7), (3, 5)), ((9, 9), (4, 4))])
def test_adaptive_max_pool2d_non_divisible_follows_the_3d_reference(hw, out):
    x = _rand(np.random.RandomState(16), 2, 3, *hw)
    with pytest.raises(NotImplementedError):
        J.adaptive_max_pool2d(Tensor(jnp.asarray(x)), out)
    _check_vjp(lambda a: J.adaptive_max_pool3d(
                   J.as_tensor(a.data[:, :, None]), (1,) + out),
               lambda a: T.adaptive_max_pool2d(a, out)[:, :, None], [x])


# (H, k, s, p), each one where ceil_mode adds a window along H; in the
# last, that window lies wholly in the high-side padding
CEIL_CASES = [(7, 2, 2, 0), (8, 3, 2, 1), (10, 3, 3, 0), (6, 4, 3, 1),
              (9, 2, 3, 0)]


@pytest.mark.parametrize('kind', ['max', 'avg_exclusive', 'avg_inclusive'])
@pytest.mark.parametrize('hw,k,s,p', CEIL_CASES)
def test_ceil_mode_follows_pool_nd_through_the_3d_reference(kind, hw, k, s,
                                                            p):
    x = _rand(np.random.RandomState(hw + k), 2, 3, hw, hw + 1)
    kw3 = dict(kernel_size=(1, k, k), stride=(1, s, s), padding=(0, p, p),
               ceil_mode=True)
    kw2 = dict(kernel_size=k, stride=s, padding=p, ceil_mode=True)
    if kind == 'max':
        jfn = lambda a: J.max_pool3d(J.as_tensor(a.data[:, :, None]), **kw3)
        tfn = lambda a: T.max_pool2d(a, **kw2)[:, :, None]
    else:
        ex = kind == 'avg_exclusive'
        jfn = lambda a: J.avg_pool3d(J.as_tensor(a.data[:, :, None]),
                                     exclusive=ex, **kw3)
        tfn = lambda a: T.avg_pool2d(a, exclusive=ex, **kw2)[:, :, None]
    _check_vjp(jfn, tfn, [x])
    plain = T.max_pool2d(torch.from_numpy(x), k, s, p)
    assert tfn(torch.from_numpy(x)).shape[3] == plain.shape[2] + 1


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------
def _bn_inputs(rng, shape, c):
    x = _rand(rng, *shape) * 2.0 + 0.5
    return (x, rng.rand(c).astype(np.float32) + 0.5, _rand(rng, c),
            _rand(rng, c) * 0.1, rng.rand(c).astype(np.float32) + 0.5)


BN_CASES = {
    'nchw': dict(shape=(4, 3, 5, 6), fmt='NCHW'),
    'nc': dict(shape=(8, 5), fmt='NCHW'),
    'ncl': dict(shape=(4, 3, 7), fmt='NCL'),
    'nhwc': dict(shape=(4, 5, 6, 3), fmt='NHWC'),
    'ncdhw': dict(shape=(2, 3, 2, 3, 4), fmt='NCDHW'),
}


@pytest.mark.parametrize('case', sorted(BN_CASES))
def test_batch_norm_training_and_running_update_match_jax(case):
    c = BN_CASES[case]
    ch = c['shape'][-1] if c['fmt'] == 'NHWC' else c['shape'][1]
    x, w, b, rm, rv = _bn_inputs(np.random.RandomState(21), c['shape'], ch)
    kw = dict(training=True, momentum=0.8, epsilon=1e-5,
              data_format=c['fmt'])

    def jfn(a, wt, bs):
        return J.batch_norm(a, Tensor(jnp.asarray(rm)),
                            Tensor(jnp.asarray(rv)), wt, bs, **kw)

    def tfn(a, wt, bs):
        return T.batch_norm(a, torch.from_numpy(rm.copy()),
                            torch.from_numpy(rv.copy()), wt, bs, **kw)
    _check_vjp(jfn, tfn, [x, w, b])
    # one call's running statistics (eager on both sides)
    jm, jv = Tensor(jnp.asarray(rm)), Tensor(jnp.asarray(rv))
    J.batch_norm(Tensor(jnp.asarray(x)), jm, jv, Tensor(jnp.asarray(w)),
                 Tensor(jnp.asarray(b)), **kw)
    tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    T.batch_norm(torch.from_numpy(x), tm, tv, torch.from_numpy(w),
                 torch.from_numpy(b), **kw)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm.data), **FP32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv.data), **FP32)
    # the share kept is 0.8, and the batch variance is the biased one
    per_ch = np.moveaxis(x, -1 if c['fmt'] == 'NHWC' else 1, 0)
    per_ch = per_ch.reshape(ch, -1).astype(np.float64)
    np.testing.assert_allclose(tv.numpy(), 0.8 * rv + 0.2 * per_ch.var(1),
                               **FP32)
    np.testing.assert_allclose(tm.numpy(), 0.8 * rm + 0.2 * per_ch.mean(1),
                               **FP32)


@pytest.mark.parametrize('mode', ['eval', 'use_global_stats'])
def test_batch_norm_on_running_statistics_matches_jax(mode):
    x, w, b, rm, rv = _bn_inputs(np.random.RandomState(22), (4, 3, 5, 6), 3)
    kw = dict(training=mode != 'eval', use_global_stats=mode != 'eval' or None)
    tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    _check_vjp(lambda a, wt, bs: J.batch_norm(
                   a, Tensor(jnp.asarray(rm)), Tensor(jnp.asarray(rv)), wt,
                   bs, **kw),
               lambda a, wt, bs: T.batch_norm(a, tm, tv, wt, bs, **kw),
               [x, w, b])
    np.testing.assert_array_equal(tm.numpy(), rm)     # never updated
    np.testing.assert_array_equal(tv.numpy(), rv)


def test_batch_norm_without_affine_matches_jax():
    x, _w, _b, rm, rv = _bn_inputs(np.random.RandomState(23), (4, 3, 5), 3)
    _check_vjp(lambda a: J.batch_norm(a, Tensor(jnp.asarray(rm)),
                                      Tensor(jnp.asarray(rv)), training=True),
               lambda a: T.batch_norm(a, torch.from_numpy(rm.copy()),
                                      torch.from_numpy(rv.copy()),
                                      training=True), [x])


def test_bf16_batch_norm_is_held_at_its_stated_bar():
    x, w, b, rm, rv = _bn_inputs(np.random.RandomState(24), (8, 4, 6, 6), 4)
    bf = jnp.bfloat16
    jm, jv = Tensor(jnp.asarray(rm)), Tensor(jnp.asarray(rv))
    jo = J.batch_norm(Tensor(jnp.asarray(x, bf)), jm, jv,
                      Tensor(jnp.asarray(w, bf)), Tensor(jnp.asarray(b, bf)),
                      training=True)
    tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    to = T.batch_norm(torch.from_numpy(x).bfloat16(), tm, tv,
                      torch.from_numpy(w).bfloat16(),
                      torch.from_numpy(b).bfloat16(), training=True)
    assert to.dtype == torch.bfloat16 and tm.dtype == torch.float32
    want = np.asarray(jo.data, np.float32)
    err = np.abs(to.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2.0 ** -6, err
    # the statistics come from the same bf16 x, in fp32, on both sides
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm.data), **FP32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv.data), **FP32)


def test_batch_norm_recompute_leaves_the_running_statistics():
    x = torch.randn(4, 3, 5, 5, requires_grad=True)
    rm, rv = torch.zeros(3), torch.ones(3)

    def f(a):
        # an op after the norm: the recompute runs past the update (a
        # checkpoint stops once the backward's tensors are recomputed)
        return torch.relu(T.batch_norm(a, rm, rv, training=True))
    out = torch.utils.checkpoint.checkpoint(
        f, x, use_reentrant=False,
        context_fn=lambda: tremat._contexts(None))
    after_forward = (rm.clone(), rv.clone())
    assert not torch.equal(after_forward[0], torch.zeros(3))
    out.square().sum().backward()
    assert not tremat.in_recompute()
    assert torch.equal(rm, after_forward[0])
    assert torch.equal(rv, after_forward[1])


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
ACTS = {
    'relu6': ({}, {}), 'elu': ({'alpha': 0.7}, {'alpha': 0.7}),
    'selu': ({}, {}), 'celu': ({'alpha': 1.3}, {'alpha': 1.3}),
    'silu': ({}, {}), 'swish': ({}, {}), 'mish': ({}, {}),
    'leaky_relu': ({'negative_slope': 0.1}, {'negative_slope': 0.1}),
    'softplus': ({'beta': 2.0, 'threshold': 3.0},
                 {'beta': 2.0, 'threshold': 3.0}),
    'softsign': ({}, {}), 'hardsigmoid': ({}, {}), 'hardswish': ({}, {}),
    'hardtanh': ({'min': -0.5, 'max': 2.0}, {'min': -0.5, 'max': 2.0}),
    'hardshrink': ({'threshold': 0.4}, {'threshold': 0.4}),
    'softshrink': ({'threshold': 0.4}, {'threshold': 0.4}),
    'tanhshrink': ({}, {}),
    'thresholded_relu': ({'threshold': 0.3}, {'threshold': 0.3}),
    'log_sigmoid': ({}, {}), 'maxout': ({'groups': 2}, {'groups': 2}),
    'log_softmax': ({'axis': 1}, {'axis': 1}),
}


@pytest.mark.parametrize('name', sorted(ACTS))
def test_activation_matches_jax(name):
    jkw, tkw = ACTS[name]
    x = _rand(np.random.RandomState(31), 3, 4, 5) * 3.0
    _check_vjp(lambda a: getattr(J, name)(a, **jkw),
               lambda a: getattr(T, name)(a, **tkw), [x])


@pytest.mark.parametrize('n', [1, 4])
def test_prelu_matches_jax(n):
    rng = np.random.RandomState(32)
    x, w = _rand(rng, 2, 4, 3, 3), rng.rand(n).astype(np.float32)
    _check_vjp(J.prelu, T.prelu, [x, w])
