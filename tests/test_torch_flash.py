"""paddle_tpu_torch's packed flash attention vs the JAX package's.

The port's plain forward (o and lse) and its autograd Function's
gradients on the CPU — the same Function and backward formulas the card
runs, with the plain versions in place of the kernels — against the
Pallas packed bodies under interpret mode (`_flash_forward_packed`,
`flash_attention_packed`'s custom VJP) and against the jnp oracle
`_reference_attention`, on the same seeded numpy inputs.

Tolerances: forward at the fp32 bars, rtol 2e-4 / atol 2e-5 (the online
softmax sums keys in blocks, the plain version in one pass). Gradients
at rtol 5e-4 / atol 5e-5, the bar tests/test_flash_attention.py holds
the Pallas backward to against its own oracle: the backward sums over
every key and every query in two passes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

FP32 = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=5e-5)
B, H, D = 2, 2, 32


def _inputs(L, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H * D).astype(np.float32) for _ in range(3))
    bias = None
    if with_bias:
        # a key-padding bias, as BERT's masks give it
        bias = np.where(rng.rand(B, L) > 0.25, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bhld(a):
    """[B, L, H*D] -> [B*H, L, D], the layout of _reference_attention."""
    L = a.shape[1]
    return a.reshape(B, L, H, D).transpose(0, 2, 1, 3).reshape(B * H, L, D)


@pytest.mark.parametrize('L', [256, 384])
@pytest.mark.parametrize('with_bias', [False, True], ids=['nobias', 'bias'])
@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
def test_plain_forward_matches_pallas_and_reference(causal, with_bias, L):
    q, k, v, bias = _inputs(L, with_bias)
    o, lse = tfa.flash_attention_packed_plain(
        _t(q), _t(k), _t(v), H, D, bias=_t(bias), causal=causal)
    jo, jlse = jfa._flash_forward_packed(
        _j(q), _j(k), _j(v), bias=_j(bias), num_heads=H, head_dim=D,
        causal=causal, with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FP32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FP32)
    ref = jfa._reference_attention(_j(_bhld(q)), _j(_bhld(k)),
                                   _j(_bhld(v)), bias=_j(bias), num_heads=H,
                                   causal=causal)
    np.testing.assert_allclose(_bhld(o.numpy()), np.asarray(ref), **FP32)


@pytest.mark.parametrize('L,with_bias,causal', [
    (256, False, True), (256, True, False), (256, True, True),
    (384, False, True)])
def test_function_gradients_match_jax_grad(L, with_bias, causal):
    q, k, v, bias = _inputs(L, with_bias, seed=3)

    def loss_j(qa, ka, va):
        return jnp.sum(jfa.flash_attention_packed(
            qa, ka, va, H, D, bias=_j(bias), causal=causal) ** 2)

    jl, jg = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        _j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tb = None if bias is None else _t(bias).requires_grad_()
    out = tfa.flash_attention_packed(tq, tk, tv, H, D, bias=tb,
                                     causal=causal)
    loss = (out ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD)
    if tb is not None:          # the key bias gets zeros (:815)
        assert not tb.grad.any()


def test_plain_backward_matches_pallas_backward():
    q, k, v, bias = _inputs(256, True, seed=5)
    do = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    o, lse = tfa.flash_attention_packed_plain(_t(q), _t(k), _t(v), H, D,
                                              bias=_t(bias), causal=True)
    got = tfa.flash_attention_packed_bwd_plain(
        _t(q), _t(k), _t(v), o, lse, _t(do), H, D, bias=_t(bias),
        causal=True)
    jo, jlse = jfa._flash_forward_packed(_j(q), _j(k), _j(v), bias=_j(bias),
                                         num_heads=H, head_dim=D, causal=True,
                                         with_lse=True)
    want = jfa._flash_backward_packed(_j(q), _j(k), _j(v), jo, jlse, _j(do),
                                      bias=_j(bias), num_heads=H, head_dim=D,
                                      causal=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


def test_causal_attention_unpacks_megatron_qkv_like_jax():
    rng = np.random.RandomState(8)
    L = 256
    qkv = rng.randn(B, L, H * 3 * D).astype(np.float32)
    got = tfa.causal_attention(torch.from_numpy(qkv), H, D)
    x = qkv.reshape(B, L, H, 3, D)
    q, k, v = (x[:, :, :, i].reshape(B, L, H * D) for i in range(3))
    want = jfa._flash_forward_packed(_j(q), _j(k), _j(v), num_heads=H,
                                     head_dim=D, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    with pytest.raises(NotImplementedError, match='dropout'):
        tfa.causal_attention(torch.from_numpy(qkv), H, D, dropout=0.1)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    # checked before any launch, so the CPU can exercise the checks
    q = torch.zeros(1, 64, 2 * 48)
    with pytest.raises(ValueError, match='head_dim 48'):
        tfa._check(q, q, q, None, 2, 48, tfa.FWD_KERNEL)
    q = torch.zeros(1, 64, 2 * 64)
    with pytest.raises(ValueError, match='share one'):
        tfa._check(q, q[:, :32], q, None, 2, 64, tfa.FWD_KERNEL)
    with pytest.raises(ValueError, match='bias'):
        tfa._check(q, q, q, torch.zeros(1, 63), 2, 64, tfa.FWD_KERNEL)
    with pytest.raises(TypeError, match='no kernel for dtype'):
        tfa._check(q.half(), q.half(), q.half(), None, 2, 64,
                   tfa.FWD_KERNEL)
