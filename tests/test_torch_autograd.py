"""The port's `autograd` (`PyLayer`, `backward`) and `paddle.grad`
(`framework.grad`) on the reference's cases (tests/test_autograd.py:
82-200): a PyLayer's forward and backward with `save_for_backward` /
`saved_tensor()`, keyword arguments and a non-tensor argument; grad of a
non-leaf; double, mixed and triple grad with `create_graph`;
`allow_unused` raising and returning None; a hooked intermediate that
is also a grad target fires once; `backward` with grad tensors
accumulates."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.autograd import PyLayer, backward


def _t(v):
    return torch.tensor(v, dtype=torch.float32, requires_grad=True)


def test_pylayer():
    class Double(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            return grad * 2

    x = _t([3.0])
    y = Double.apply(x)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0])
    np.testing.assert_allclose(y.detach().numpy(), [6.0])


def test_pylayer_saved_tensors_kwargs_and_constants():
    class ScaledTanh(PyLayer):
        @staticmethod
        def forward(ctx, x, k, w, shift=0.0):
            y = torch.tanh(x * k) * w + shift
            ctx.save_for_backward(x, w)
            ctx.k = k
            return y

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensor()
            d = 1 - torch.tanh(x * ctx.k) ** 2
            return g * w * d * ctx.k, g * torch.tanh(x * ctx.k)

    x, w = _t([0.3, -1.2]), _t([2.0, 0.5])
    ScaledTanh.apply(x, 1.5, w, shift=1.0).sum().backward()
    x2, w2 = _t([0.3, -1.2]), _t([2.0, 0.5])
    (torch.tanh(x2 * 1.5) * w2 + 1.0).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(), rtol=1e-6)


def test_grad_of_a_non_leaf():
    x = _t([2.0])
    y = x * x
    z = (y * y).sum()
    np.testing.assert_allclose(paddle.grad(z, y)[0].numpy(), [8.0])
    assert x.grad is None


def test_double_grad_create_graph():
    x = _t([3.0])
    (g1,) = paddle.grad(x * x, x, create_graph=True)
    assert g1.requires_grad
    (g2,) = paddle.grad(g1, x)
    np.testing.assert_allclose(g1.detach().numpy(), [6.0])
    np.testing.assert_allclose(g2.numpy(), [2.0])


def test_double_grad_mixed_expression():
    x = _t([2.0])
    (g1,) = paddle.grad(x * x * x, x, create_graph=True)
    (g1 * g1).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [36.0 * 8.0], rtol=1e-6)


def test_triple_grad():
    x = _t([1.5])
    (g1,) = paddle.grad(x * x * x * x, x, create_graph=True)
    (g2,) = paddle.grad(g1, x, create_graph=True)
    (g3,) = paddle.grad(g2, x)
    np.testing.assert_allclose(g3.numpy(), [24.0 * 1.5], rtol=1e-6)


def test_grad_allow_unused():
    x, z = _t([1.0]), _t([1.0])
    with pytest.raises(RuntimeError, match='unreachable'):
        paddle.grad((x * 2).sum(), [x, z])
    gx, gz = paddle.grad((x * 2).sum(), [x, z], allow_unused=True)
    np.testing.assert_allclose(gx.numpy(), [2.0])
    assert gz is None


def test_hook_fires_once_for_captured_intermediate():
    calls = []
    x = _t([2.0])
    y = x * x
    y.register_hook(lambda g: calls.append(float(g[0])) or None)
    (gy,) = paddle.grad((y * y).sum(), y)
    assert len(calls) == 1, calls
    np.testing.assert_allclose(gy.numpy(), [8.0])


def test_backward_accumulates_with_grad_tensors():
    x = _t([1.0, 2.0])
    backward([(x * 2)], [torch.tensor([1.0, 3.0])], retain_graph=True)
    backward(x * 3, torch.ones(2))
    np.testing.assert_allclose(x.grad.numpy(), [5.0, 9.0])
    with pytest.raises(NotImplementedError, match='no_grad_vars'):
        paddle.grad((x * 2).sum(), x, no_grad_vars=[x])
