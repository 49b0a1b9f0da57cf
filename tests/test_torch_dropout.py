"""paddle_tpu_torch's dropout and dropout+residual vs the JAX package.

The two frameworks' random streams cannot agree (threefry against
Philox), so each test draws one numpy keep mask and hands it to both:
to the port's `DropoutAddFunction` directly, or through its mask draw
(`core.rng.keep_mask`, replaced here), and to the JAX package's
`dropout_add` Pallas body (`_fe.dropout_add` in interpret mode), its
jnp reference (`dropout_add_reference`) and its `jax.random.bernoulli`
draw (replaced here).

Tolerances: the port's plain versions round where the JAX package's
jnp route rounds (the quotient x / (1-p) in x's dtype, with 1-p itself
in x's dtype, then the residual add), so fp32 agrees to 1e-6 relative
(the reference's own bar between its Pallas body and its jnp route:
XLA may contract the divide and add differently) and bf16 to one bf16
ulp; the drop pattern is identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu.ops.pallas import fused_elementwise as jfe
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.ops import nn_ops as tnn_ops
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_elementwise as tfe

TDT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _np(x):
    x = x.data if isinstance(x, Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got == 0, want == 0)
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert (np.abs(got - want) <= ulp).all()


def _case(shape, dtype, p, seed=0):
    rng = np.random.RandomState(seed)
    x, r, dy = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    keep = rng.rand(*shape) < 1.0 - p
    jx, jr, jdy = (jnp.asarray(a, dtype) for a in (x, r, dy))
    tx, tr, tdy = (torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])
                   for a in (jx, jr, jdy))
    return (jx, jr, jdy), (tx, tr, tdy), keep


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,p', [((13, 29), 0.1), ((2, 5, 64), 0.3)])
def test_dropout_add_function_matches_pallas_body_and_reference(
        shape, p, dtype):
    (jx, jr, jdy), (tx, tr, tdy), keep = _case(shape, dtype, p)
    jkeep = jnp.asarray(keep, jnp.float32)
    tkeep = torch.from_numpy(keep)
    leaves = [t.clone().requires_grad_() for t in (tx, tr)]
    _build.reset_launches()
    y = tfe.dropout_add(*leaves, tkeep, p)
    assert y.grad_fn is not None and y.dtype == TDT[dtype]
    y.backward(tdy)
    # the CPU route is the plain version: no kernel launched
    assert _build.routes_snapshot()['dropout_add'] == 0
    assert torch.equal(y.detach(), tfe.dropout_add_plain(tx, tr, tkeep, p))
    pal = jfe.dropout_add(jx, jr, jkeep, p)
    ref = jfe.dropout_add_reference(jx, jr, jkeep, p)
    for want in (pal, ref):
        _close(y, want, dtype)
    _, vjp = jax.vjp(lambda a, b: jfe.dropout_add(a, b, jkeep, p), jx, jr)
    jdx, jdr = vjp(jdy)
    assert leaves[0].grad.dtype == TDT[dtype]
    _close(leaves[0].grad, jdx, dtype)
    assert torch.equal(leaves[1].grad, tdy)
    np.testing.assert_array_equal(_np(jdr), _np(tdy))
    assert torch.equal(tfe.dropout_add_bwd_plain(tkeep, tdy, p),
                       leaves[0].grad)


def test_bf16_divisor_is_keep_prob_rounded_to_bf16():
    """jnp divides a bf16 x by 1 - p in bf16: 0.9 becomes 0.8984375."""
    x = torch.full((4,), 1.0, dtype=torch.bfloat16)
    keep = torch.ones(4, dtype=torch.bool)
    y = tfe.dropout_add_plain(x, torch.zeros_like(x), keep, 0.1)
    assert float(tfe.keep_scale(x, 0.1)) == 0.8984375
    assert float(y[0]) == float(torch.tensor(1 / 0.8984375).bfloat16())
    j = jfe.dropout_add_reference(jnp.ones(4, jnp.bfloat16),
                                  jnp.zeros(4, jnp.bfloat16),
                                  jnp.ones(4, jnp.float32), 0.1)
    assert float(y[0]) == float(j[0])


class _Masks:
    """Replays numpy masks in call order, on both sides."""

    def __init__(self, masks):
        self.masks = masks
        self.j = self.t = 0

    def jax_bernoulli(self, key, p, shape):
        m = self.masks[self.j % len(self.masks)]
        self.j += 1
        assert tuple(shape) == m.shape
        return jnp.asarray(m)

    def torch_keep(self, shape, keep_prob, device):
        m = self.masks[self.t % len(self.masks)]
        self.t += 1
        assert tuple(shape) == m.shape
        return torch.from_numpy(m).to(device)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', ['upscale_in_train', 'downscale_in_infer'])
@pytest.mark.parametrize('axis', [None, 1, [0, 2]])
def test_dropout_matches_the_reference(monkeypatch, axis, mode, dtype):
    shape, p = (3, 5, 16), 0.25
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32)
    mshape = shape if axis is None else tuple(
        d if i in ([axis] if isinstance(axis, int) else axis) else 1
        for i, d in enumerate(shape))
    masks = _Masks([rng.rand(*mshape) < 1 - p])
    monkeypatch.setattr(jax.random, 'bernoulli', masks.jax_bernoulli)
    monkeypatch.setattr(trng, 'keep_mask', masks.torch_keep)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(TDT[dtype])
    want = jnn_ops.dropout(Tensor(jx), p=p, axis=axis, training=True,
                           mode=mode)
    got = tnn_ops.dropout(tx, p=p, axis=axis, training=True, mode=mode)
    assert got.dtype == TDT[dtype] and masks.j == masks.t == 1
    _close(got, want, dtype)
    # eval: identity, or the 1 - p scale in x's dtype
    want = jnn_ops.dropout(Tensor(jx), p=p, training=False, mode=mode)
    got = tnn_ops.dropout(tx, p=p, training=False, mode=mode)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_nn_ops_dropout_add_draws_once_and_matches(monkeypatch, dtype):
    (jx, jr, _), (tx, tr, _), keep = _case((6, 21), dtype, 0.3, seed=2)
    masks = _Masks([keep])
    monkeypatch.setattr(jax.random, 'bernoulli', masks.jax_bernoulli)
    monkeypatch.setattr(trng, 'keep_mask', masks.torch_keep)
    want = jnn_ops.dropout_add(Tensor(jx), Tensor(jr), p=0.3, training=True)
    got = tnn_ops.dropout_add(tx, tr, p=0.3, training=True)
    assert masks.j == masks.t == 1
    _close(got, want, dtype)
    assert got.grad_fn is None            # no input needs a gradient
    want = jnn_ops.dropout_add(Tensor(jx), Tensor(jr), p=0.3,
                               training=True, mode='downscale_in_infer')
    got = tnn_ops.dropout_add(tx, tr, p=0.3, training=True,
                              mode='downscale_in_infer')
    _close(got, want, dtype)


def test_dropout_in_training_draws_from_the_bound_generator():
    x = torch.randn(64, 32)
    with pytest.raises(RuntimeError, match='bound generator'):
        tnn_ops.dropout(x, p=0.5, training=True)
    with pytest.raises(RuntimeError, match='bound generator'):
        tnn_ops.dropout_add(x, x, p=0.5, training=True)
    outs = []
    for _ in range(2):
        with trng.rng_guard(torch.Generator().manual_seed(5)):
            outs.append(tnn_ops.dropout_add(x, torch.zeros_like(x), p=0.5,
                                            training=True))
    assert torch.equal(outs[0], outs[1])
    kept = outs[0] != 0
    assert 0.4 < float(kept.float().mean()) < 0.6
    torch.testing.assert_close(outs[0][kept], x[kept] / 0.5)
    default_before = torch.random.get_rng_state()
    with trng.rng_guard(torch.Generator().manual_seed(5)):
        layer = tnn.Dropout(p=0.5)
        layer(x)
    assert torch.equal(torch.random.get_rng_state(), default_before)
    layer.eval()
    assert layer(x) is x
