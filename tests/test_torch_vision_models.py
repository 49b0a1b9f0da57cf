"""paddle_tpu_torch's vision models and layers against
`paddle_tpu.vision.models` on bridged weights and buffers
(`load_jax_params(model, params, buffers)`), the same numpy images on
both sides.

Each model runs a train-mode forward (batch statistics; the running
statistics move on both sides and are compared after it) and an
eval-mode forward (the running statistics normalise). Dropout in train
mode (VGG's classifier, MobileNetV2's) runs on the same replayed numpy
masks on both sides.

Sizes: 64 x 64 images, B = 4 (B = 2 for ResNet-50, which appears in one
test only), so the last stage's batch norm still averages over several
values: at 32 x 32 and B = 2 it normalises pairs of values, which
amplifies the rounding of their difference past any fixed bar. VGG runs
at 32 x 32, where its last stage is 1 x 1 after the pool (no batch norm
there).

The JAX models are built with numpy draws in place of `jax.random`'s
(which compiles anew for every parameter shape, 12 s for MobileNetV2)
and run jitted through `bind_arrays`, as the reference's engines run
them; the values are bridged, so both sides hold the same ones.

Tolerances: the round's fp32 bars, rtol 2e-4 / atol 2e-5, on logits and
running statistics, except the train-mode forwards of the deep models
(ResNet-50, MobileNet V1/V2). Their batch norms renormalise each stage's
rounding over few values (2 x 2 at the last stage), and both frameworks
land 4.5e-5 to 9.2e-5 relative L2 from the same model run in float64
(measured). So the port is held there at 2e-4 relative L2 of JAX's
logits, and its own distance from the float64 run at no more than twice
JAX's.
"""
import collections
import contextlib
import copy
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import bind_arrays
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.vision import models as tvm
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-4, atol=2e-5)


def _named(jm):
    return ({n: np.asarray(p.data) for n, p in jm.named_parameters()},
            {n: np.asarray(b.data) for n, b in jm.named_buffers()})


@contextlib.contextmanager
def numpy_draws(seed):
    """jax.random.uniform and .normal drawn by numpy (seeded), so a
    reference model builds without compiling a sampler a shape."""
    rng = np.random.RandomState(seed)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)
    with mock.patch.object(jax.random, 'uniform', uniform), \
            mock.patch.object(jax.random, 'normal', normal):
        yield


@functools.lru_cache(maxsize=None)
def _jax_model(name, items, seed=0):
    """(the JAX model, its parameters, its buffers), built once."""
    with numpy_draws(seed):
        jm = getattr(jvm, name)(**dict(items))
    return (jm,) + _named(jm)


def _pair(name, **kw):
    jm, params, buffers = _jax_model(name, tuple(sorted(kw.items())))
    tm = getattr(tvm, name)(**kw)
    load_jax_params(tm, params, buffers)
    return jm, tm


def jax_forward(jm, x, train):
    """(logits, the buffers after the forward): the model's forward
    jitted over its bridged arrays, as `paddle_tpu.jit` runs it."""
    jm.train() if train else jm.eval()
    params, buffers = _named(jm)

    def f(ps, bs, a):
        with bind_arrays(jm, ps, bs) as out, no_grad():
            logits = jm(Tensor(a)).data
        return logits, dict(out)
    logits, new = jax.jit(f)(params, buffers, jnp.asarray(x))
    return np.asarray(logits), {n: np.asarray(v) for n, v in new.items()}


class _Masks:
    """One numpy keep mask a dropout call, in call order, on both sides."""

    def __init__(self, seed=5):
        self.rng = np.random.RandomState(seed)
        self.masks, self.t = [], 0

    def jax_bernoulli(self, key, p, shape):
        m = self.rng.rand(*shape) < p
        self.masks.append((p, m))
        return jnp.asarray(m)

    def torch_keep(self, shape, keep_prob, device):
        p, m = self.masks[self.t % len(self.masks)]
        self.t += 1
        assert abs(p - keep_prob) < 1e-12 and m.shape == tuple(shape)
        return torch.from_numpy(m)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_model(jm, tm, x, train, monkeypatch, deep=False):
    tm.train(train)
    f64 = copy.deepcopy(tm).double() if deep and train else None
    if train:
        masks = _Masks()
        monkeypatch.setattr(jax.random, 'bernoulli', masks.jax_bernoulli)
        monkeypatch.setattr(trng, 'keep_mask', masks.torch_keep)
    jo, jb = jax_forward(jm, x, train)
    with torch.no_grad():
        to = tm(torch.from_numpy(x)).numpy()
    assert to.shape == jo.shape and np.isfinite(to).all()
    if f64 is None:
        np.testing.assert_allclose(to, jo, **FP32)
    else:
        with torch.no_grad():
            exact = f64(torch.from_numpy(x).double()).numpy()
        assert _rel(to, jo) <= 2e-4, _rel(to, jo)
        assert _rel(to, exact) <= 2 * _rel(jo, exact), \
            (_rel(to, exact), _rel(jo, exact))
    tb = {n: b.numpy() for n, b in tm.named_buffers()}
    assert set(tb) == set(jb)
    for n in tb:
        np.testing.assert_allclose(tb[n], jb[n], err_msg=n, **FP32)
    if train and jb:
        assert any(not np.allclose(v, 0.0) for n, v in jb.items()
                   if n.endswith('_mean'))


def _images(B, C=3, hw=64, seed=1):
    return np.random.RandomState(seed).randn(B, C, hw, hw).astype(np.float32)


MODELS = {
    'lenet': ('LeNet', dict(num_classes=10), (4, 1, 28), False),
    'resnet18': ('resnet18', dict(num_classes=10), (4, 3, 64), False),
    'vgg11': ('vgg11', dict(num_classes=10), (2, 3, 32), False),
    'vgg11_bn': ('vgg11', dict(num_classes=10, batch_norm=True), (4, 3, 32),
                 False),
    'mobilenet_v1': ('mobilenet_v1', dict(scale=0.25, num_classes=10),
                     (4, 3, 64), True),
    'mobilenet_v2': ('mobilenet_v2', dict(scale=0.25, num_classes=10),
                     (4, 3, 64), True),
}


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('model', sorted(MODELS))
def test_model_forward_matches_jax(model, train, monkeypatch):
    name, kw, (B, C, hw), deep = MODELS[model]
    jm, tm = _pair(name, **kw)
    _check_model(jm, tm, _images(B, C, hw), train, monkeypatch, deep=deep)


def test_resnet50_train_and_eval_forward_match_jax(monkeypatch):
    jm, tm = _pair('resnet50', num_classes=10)
    assert 'layer1.0.bn1._mean' in dict(tm.named_buffers())
    x = _images(2)
    _check_model(jm, tm, x, False, monkeypatch)
    _check_model(jm, tm, x, True, monkeypatch, deep=True)


def test_parameter_and_buffer_names_equal_the_jax_models():
    for name, kw in (('LeNet', dict(num_classes=10)),
                     ('resnet18', dict(num_classes=10)),
                     ('mobilenet_v2', dict(scale=0.25, num_classes=10)),
                     ('vgg11', dict(batch_norm=True, num_classes=10))):
        _jm, jp, jb = _jax_model(name, tuple(sorted(kw.items())))
        tm = getattr(tvm, name)(**kw)
        assert [n for n, _ in tm.named_parameters()] == list(jp), name
        assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
            {n: a.shape for n, a in jp.items()}
        assert [n for n, _ in tm.named_buffers()] == list(jb), name
    assert 'features.0.weight' in jp


# ---------------------------------------------------------------------------
# the weight bridge with buffers
# ---------------------------------------------------------------------------
def test_bridge_with_buffers_keeps_fp32_statistics_under_bf16_params():
    _jm, params, buffers = _jax_model('resnet18', (('num_classes', 10),))
    params = {n: np.asarray(jnp.asarray(a, jnp.bfloat16))
              for n, a in params.items()}
    buffers = {n: a + 0.25 for n, a in buffers.items()}  # not 0 / 1
    tm = tvm.resnet18(num_classes=10, dtype=torch.bfloat16)
    load_jax_params(tm, params, buffers)
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, n
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      params[n].astype(np.float32))
    for n, b in tm.named_buffers():
        assert b.dtype == torch.float32, n
        np.testing.assert_array_equal(b.numpy(), buffers[n])


@pytest.mark.parametrize('fault', ['missing', 'extra', 'shape'])
def test_bridge_refuses_a_bad_buffer_before_copying_anything(fault):
    _jm, params, buffers = _jax_model('resnet18', (('num_classes', 10),))
    buffers = dict(buffers)
    tm = tvm.resnet18(num_classes=10)
    if fault == 'missing':
        del buffers['layer2.1.bn2._variance']
    elif fault == 'extra':
        buffers['layer2.1.bn3._mean'] = np.zeros(128, np.float32)
    else:
        buffers['bn1._mean'] = np.zeros(65, np.float32)
    before = {n: t.clone() for n, t in tm.state_dict().items()}
    with pytest.raises(KeyError if fault != 'shape' else ValueError,
                       match='bn'):
        load_jax_params(tm, params, buffers)
    for n, t in tm.state_dict().items():
        assert torch.equal(t, before[n]), n


def test_bridge_without_buffers_copies_parameters_only():
    _jm, params, _buffers = _jax_model('LeNet', (('num_classes', 10),))
    tm = tvm.LeNet()
    load_jax_params(tm, params)
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[n])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_conv2d_default_init_is_paddles_xavier_with_the_layers_fan_in():
    g = torch.Generator().manual_seed(0)
    conv = tnn.Conv2D(16, 64, 3, groups=2, generator=g)
    assert conv.weight.shape == (64, 8, 3, 3)
    limit = np.sqrt(6.0 / (8 * 9 + 64 * 9))
    w = conv.weight.detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit
    assert abs(w.std() - limit / np.sqrt(3)) < 0.05 * limit
    np.testing.assert_array_equal(conv.bias.detach().numpy(), np.zeros(64))
    again = tnn.Conv2D(16, 64, 3, groups=2,
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, conv.weight)
    assert tnn.Conv2D(3, 4, 1, bias_attr=False).bias is None


def test_layers_refuse_a_param_attr_and_other_padding_modes():
    """A ParamAttr is taken as the reference takes it (the same
    initializer gives the same values, and its learning rate rides on
    the parameter); a padding_mode other than 'zeros' stays refused,
    since the reference pads with zeros whatever it says."""
    conv = tnn.Conv2D(3, 4, 3, weight_attr=tnn.ParamAttr(
        initializer=tnn.initializer.Constant(0.3), learning_rate=2.0))
    jconv = jnn.Conv2D(3, 4, 3, weight_attr=jnn.initializer.Constant(0.3))
    np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                  np.asarray(jconv.weight.data))
    assert conv.weight.optimize_attr == {'learning_rate': 2.0}
    bn = tnn.BatchNorm2D(4, bias_attr=tnn.ParamAttr(
        initializer=tnn.initializer.Constant(0.2)))
    jbn = jnn.BatchNorm2D(4, bias_attr=jnn.initializer.Constant(0.2))
    np.testing.assert_array_equal(bn.bias.detach().numpy(),
                                  np.asarray(jbn.bias.data))
    with pytest.raises(NotImplementedError, match='pads with zeros'):
        tnn.Conv2D(3, 4, 3, padding_mode='reflect')
    with pytest.raises(NotImplementedError, match='pretrained'):
        tvm.resnet50(pretrained=True)


def test_batch_norm_layers_buffers_and_affine_switches():
    bn = tnn.BatchNorm2D(6, dtype=torch.bfloat16)
    assert [n for n, _ in bn.named_buffers()] == ['_mean', '_variance']
    assert bn._mean.dtype == torch.float32 and bn.weight.dtype == \
        torch.bfloat16
    bare = tnn.BatchNorm1D(6, weight_attr=False, bias_attr=False)
    assert bare.weight is None and bare.bias is None
    x = torch.randn(8, 6)
    out = bare(x)
    np.testing.assert_allclose(out.mean(0).numpy(), 0.0, atol=1e-6)
    bn3 = tnn.BatchNorm3D(2)
    bn3(torch.randn(2, 2, 3, 3, 3))
    assert not torch.equal(bn3._mean, torch.zeros(2))


@pytest.mark.parametrize('act', [None, 'relu', 'relu6'])
def test_fluid_batch_norm_and_sync_batch_norm_match_jax(act):
    rng = np.random.RandomState(8)
    x = rng.randn(4, 3, 5, 5).astype(np.float32)
    for jcls, tcls in ((jnn.BatchNorm, tnn.BatchNorm),
                       (jnn.SyncBatchNorm, tnn.SyncBatchNorm)):
        kw = dict(act=act) if jcls is jnn.BatchNorm else {}
        jl, tl = jcls(3, **kw), tcls(3, **kw)
        load_jax_params(tl, *_named(jl))
        jo = np.asarray(jl(Tensor(jnp.asarray(x))).data)
        to = tl(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(to, jo, **FP32)
        np.testing.assert_allclose(tl._variance.numpy(),
                                   np.asarray(jl._variance.data), **FP32)


def test_sequential_names_match_the_reference():
    lin = tnn.Linear(2, 2)
    assert [n for n, _ in tnn.Sequential(lin, tnn.ReLU()).named_children()] \
        == ['0', '1']
    named = tnn.Sequential(collections.OrderedDict(a=lin, b=tnn.ReLU()))
    assert [n for n, _ in named.named_children()] == ['a', 'b']
    mixed = tnn.Sequential(('fc', lin), tnn.ReLU())
    assert [n for n, _ in mixed.named_children()] == ['fc', '1']
    assert isinstance(named[0:1], tnn.Sequential) and len(named[0:1]) == 1


def test_flatten_identity_and_pool_layers_match_jax():
    x = np.random.RandomState(9).randn(2, 3, 7, 9).astype(np.float32)
    jx, tx = Tensor(jnp.asarray(x)), torch.from_numpy(x)
    pairs = [(jnn.Flatten(), tnn.Flatten()),
             (jnn.Flatten(2, 3), tnn.Flatten(2, 3)),
             (jnn.Identity(4, a=1), tnn.Identity(4, a=1)),
             (jnn.MaxPool2D(3, 2, 1), tnn.MaxPool2D(3, 2, 1)),
             (jnn.AvgPool2D(3, 2, 1, exclusive=False),
              tnn.AvgPool2D(3, 2, 1, exclusive=False)),
             (jnn.AdaptiveAvgPool2D((3, 4)), tnn.AdaptiveAvgPool2D((3, 4))),
             (jnn.AdaptiveMaxPool2D(1), tnn.AdaptiveMaxPool2D(1))]
    for jl, tl in pairs:
        np.testing.assert_allclose(tl(tx).numpy(), np.asarray(jl(jx).data),
                                   err_msg=type(tl).__name__, **FP32)


ACT_LAYERS = ['ReLU', 'ReLU6', 'Sigmoid', 'Tanh', 'GELU', 'ELU', 'SELU',
              'CELU', 'Silu', 'Swish', 'Mish', 'Hardswish', 'Hardsigmoid',
              'Hardshrink', 'Hardtanh', 'Softshrink', 'Softplus', 'Softsign',
              'Tanhshrink', 'ThresholdedReLU', 'LogSigmoid', 'LeakyReLU',
              'PReLU', 'Softmax', 'LogSoftmax']


@pytest.mark.parametrize('name', ACT_LAYERS)
def test_activation_layer_matches_jax(name):
    x = np.random.RandomState(10).randn(2, 4, 3).astype(np.float32) * 3
    jl, tl = getattr(jnn, name)(), getattr(tnn, name)()
    if name == 'PReLU':
        load_jax_params(tl, _named(jl)[0])
    got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jl(Tensor(jnp.asarray(x))).data),
                               **FP32)
    assert tnn.Maxout(groups=2)(torch.from_numpy(x)).shape == (2, 2, 3)
