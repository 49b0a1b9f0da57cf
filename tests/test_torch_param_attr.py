"""`ParamAttr` in the port's layers and the eager optimizer step, against
paddle_tpu's.

- Every field of a ParamAttr (name, initializer, learning_rate,
  regularizer, trainable, need_clip) and `_to_attr`'s forms (None, an
  initializer, a name, False) on Linear, Conv2D, BatchNorm2D and
  MultiHeadAttention.
- Two eager steps of a model whose parameters carry learning-rate
  multipliers (two groups), a regularizer, a frozen parameter and one
  left out of the global-norm clip, against the reference's eager steps
  on the same (bridged) weights, at rtol 2e-4 / atol 2e-5 (fp32).
- The update kernel's launches (row 15) a step: one a multiplier group,
  and one for a step without multipliers, counted with
  `_build.routes_snapshot()` with the kernel's host path run on the CPU
  (tests/test_torch_multi_update.py's `_emulated_kernel`).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import regularizer as jreg
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_optimizer as TFO
from test_torch_multi_update import _emulated_kernel

FP32 = dict(rtol=2e-4, atol=2e-5)


def test_every_field_on_linear():
    attr = tnn.ParamAttr(name='fc_w', initializer=TI.Constant(0.5),
                         learning_rate=3.0, regularizer=treg.L2Decay(0.1),
                         need_clip=False)
    layer = tnn.Linear(4, 3, weight_attr=attr, bias_attr=False,
                       device='cpu')
    w = layer.weight
    assert layer.bias is None and w.param_name == 'fc_w'
    assert torch.equal(w, torch.full((4, 3), 0.5))
    assert w.optimize_attr == {'learning_rate': 3.0}
    assert w.regularizer is attr.regularizer and w.need_clip is False
    assert w.requires_grad and w.trainable
    frozen = tnn.Linear(4, 3, weight_attr=tnn.ParamAttr(trainable=False),
                        device='cpu')
    assert not frozen.weight.requires_grad and frozen.bias.requires_grad
    assert frozen.bias.optimize_attr == {'learning_rate': 1.0}
    with pytest.raises(TypeError):
        tnn.Linear(2, 2, weight_attr=object(), device='cpu')


def test_layers_build_on_the_meta_device_without_a_generator():
    """A model built under `torch.device('meta')` (then `to_empty` and a
    state dict, as chip_smoke.py builds its CPU twins) draws nothing."""
    default = torch.default_generator.get_state()
    with torch.device('meta'):
        layer = tnn.Linear(4, 3, weight_attr=tnn.ParamAttr(
            initializer=TI.Normal(0.0, 0.1)))
        conv = tnn.Conv2D(3, 4, 3)
    assert layer.weight.is_meta and conv.weight.is_meta
    assert torch.equal(torch.default_generator.get_state(), default)


def test_attr_forms_on_conv_norm_and_attention():
    g = torch.Generator().manual_seed(0)
    conv = tnn.Conv2D(3, 8, 3, weight_attr=TI.Normal(0.0, 0.01),
                      bias_attr='conv_b', generator=g)
    assert abs(float(conv.weight.std()) - 0.01) < 0.003
    assert conv.bias.param_name == 'conv_b' and not conv.bias.abs().sum()
    bn = tnn.BatchNorm2D(4, weight_attr=tnn.ParamAttr(
        initializer=TI.Constant(2.0), learning_rate=0.5), bias_attr=False)
    assert bn.bias is None and torch.equal(bn.weight, torch.full((4,), 2.0))
    assert bn.weight.optimize_attr['learning_rate'] == 0.5
    mha = tnn.MultiHeadAttention(8, 2, weight_attr=tnn.ParamAttr(
        initializer=TI.Constant(0.1), need_clip=False), bias_attr=False)
    for proj in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj):
        assert proj.bias is None and not proj.weight.need_clip
        assert torch.equal(proj.weight, torch.full((8, 8), 0.1))
    # the same attr on the JAX layer gives the same values
    jmha = jnn.MultiHeadAttention(8, 2, weight_attr=jnn.initializer.Constant(
        0.1), bias_attr=False)
    np.testing.assert_array_equal(np.asarray(jmha.q_proj.weight.data),
                                  mha.q_proj.weight.detach().numpy())


def _models():
    """(reference model, port model): fc1 with multiplier 10 on its
    weight (own L2 decay) and 0.5 on its bias (left out of the clip),
    fc2 with a frozen bias; the port's weights bridged from the
    reference's."""
    j1 = jnn.Linear(4, 6, weight_attr=paddle.ParamAttr(
        learning_rate=10.0, regularizer=jreg.L2Decay(0.01)),
        bias_attr=paddle.ParamAttr(learning_rate=0.5, need_clip=False))
    j2 = jnn.Linear(6, 2, bias_attr=paddle.ParamAttr(trainable=False))
    t1 = tnn.Linear(4, 6, weight_attr=tnn.ParamAttr(
        learning_rate=10.0, regularizer=treg.L2Decay(0.01)),
        bias_attr=tnn.ParamAttr(learning_rate=0.5, need_clip=False),
        device='cpu')
    t2 = tnn.Linear(6, 2, bias_attr=tnn.ParamAttr(trainable=False),
                    device='cpu')
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for jl, tl in ((j1, t1), (j2, t2)):
            for n in ('weight', 'bias'):
                a = rs.randn(*getattr(tl, n).shape).astype(np.float32)
                getattr(jl, n).data = paddle.to_tensor(a).data
                getattr(tl, n).copy_(torch.from_numpy(a))
    return (j1, j2), (t1, t2)


def _params(layers):
    return [p for layer in layers for p in (layer.weight, layer.bias)]


@pytest.mark.parametrize('rule', ['momentum', 'adam'])
def test_eager_steps_with_multipliers_match_the_reference(rule):
    (j1, j2), (t1, t2) = _models()
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    y = np.random.RandomState(2).randn(5, 2).astype(np.float32)
    kw = dict(learning_rate=0.05)
    jcls, tcls = ((paddle.optimizer.Momentum, topt.Momentum)
                  if rule == 'momentum' else
                  (paddle.optimizer.Adam, topt.Adam))
    jopt = jcls(parameters=_params((j1, j2)),
                grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5), **kw)
    topt_ = tcls(parameters=_params((t1, t2)),
                 grad_clip=tnn.ClipGradByGlobalNorm(0.5), **kw)
    frozen = t2.bias.detach().clone()
    for _ in range(2):
        jx = paddle.to_tensor(x)
        jloss = ((j2(paddle.nn.functional.relu(j1(jx)))
                  - paddle.to_tensor(y)) ** 2).sum()
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = ((t2(torch.relu(t1(torch.from_numpy(x))))
                  - torch.from_numpy(y)) ** 2).sum()
        tloss.backward()
        topt_.step()
        topt_.clear_grad()
        np.testing.assert_allclose(float(tloss), float(jloss), **FP32)
    for jp, tp in zip(_params((j1, j2)), _params((t1, t2))):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp.data),
                                   **FP32)
    assert torch.equal(t2.bias, frozen)


def test_need_clip_false_leaves_the_gradient_out_of_the_global_norm():
    (_, _), (t1, t2) = _models()
    params = _params((t1, t2))
    grads = {id(p): torch.full(p.shape, 3.0) for p in params}
    opt = topt.SGD(learning_rate=1.0, parameters=params,
                   grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    live = {id(p): p for p in params if p.requires_grad}
    clipped = opt._clip({k: grads[k] for k in live}, skip={id(t1.bias)})
    assert torch.equal(clipped[id(t1.bias)], grads[id(t1.bias)])
    norm = float(torch.sqrt(sum((grads[k] ** 2).sum() for k in live
                                if k != id(t1.bias))))
    np.testing.assert_allclose(clipped[id(t1.weight)].numpy(),
                               3.0 / norm, rtol=1e-6)


@pytest.fixture
def kernel_route(monkeypatch):
    """The update kernel's route on CPU tensors: the host table and
    launch path run, the launch itself is `_emulated_kernel`."""
    monkeypatch.setattr(TFO, '_check_layout', lambda: None)
    monkeypatch.setattr(TFO._build, 'on_cpu', lambda *t: False)

    def arm(opt):
        monkeypatch.setattr(_build, 'launch', _emulated_kernel(opt, []))
    _build.reset_launches()
    yield arm
    _build.reset_launches()


@pytest.mark.parametrize('with_multipliers', [True, False])
def test_one_update_launch_per_multiplier_group(kernel_route,
                                                with_multipliers):
    (_, _), (t1, t2) = _models()
    if not with_multipliers:
        for p in _params((t1, t2)):
            p.optimize_attr = {'learning_rate': 1.0}
    params = _params((t1, t2))
    opt = topt.Momentum(learning_rate=0.1, parameters=params)
    kernel_route(opt)
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        t2(torch.relu(t1(x))).square().sum().backward()
        opt.step()
        opt.clear_grad()
    groups = 3 if with_multipliers else 1
    assert _build.routes_snapshot()[TFO.STEP] == 2 * groups
