"""paddle_tpu_torch's flash attention vs the JAX package's, on both
layouts.

Packed [B, L, H*D]: the port's plain forward (o and lse) and its
autograd Function's gradients on the CPU — the same Function and
backward formulas the card runs, with the plain versions in place of
the kernels — against the Pallas packed bodies under interpret mode
(`_flash_forward_packed`, `flash_attention_packed`'s custom VJP) and
against the jnp oracle `_reference_attention`, on the same seeded numpy
inputs.

BHLD [B*H, L, D]: the port's `_flash_forward`/`_flash_backward` (their
plain versions here) against the Pallas `_flash_forward`/
`_flash_backward` bodies in interpret mode, causal, causal with a keep
mask, full with a key bias, and causal with both; the autograd
Function's gradients against the custom VJPs `flash_attention_bhld`,
`_flash_attn_dropout` and `_flash_attn_biased`; and the entries
`causal_attention(dropout)`, `flash_attention` and `mha_flash_attention`
against the reference's, the keep masks replayed from numpy on both
sides.

Tolerances: forward at the fp32 bars, rtol 2e-4 / atol 2e-5 (the online
softmax sums keys in blocks, the plain version in one pass); the BHLD
backward at the same bars. The packed gradients at rtol 5e-4 / atol
5e-5, the bar tests/test_flash_attention.py holds the Pallas backward to
against its own oracle: the backward sums over every key and every query
in two passes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from torch_threads import one_intra_op_thread  # noqa: F401

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
    # attention dropout draws its mask from the bound generator
    with pytest.raises(RuntimeError, match='bound generator'):
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


# ---------------------------------------------------------------------------
# BHLD [B*H, L, D]
# ---------------------------------------------------------------------------
RATE = 0.1
BHLD_CASES = {'causal': (True, False, False),
              'causal_mask': (True, False, True),
              'full_bias': (False, True, False),
              'causal_bias_mask': (True, True, True)}   # causal, bias, mask


def _bhld_case(name, L, D, seed):
    causal, with_bias, with_mask = BHLD_CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B * H, L, D).astype(np.float32)
                   for _ in range(4))
    bias = mask = None
    if with_bias:
        bias = np.where(rng.rand(B, L) > 0.25, 0.0, -1e9).astype(np.float32)
    if with_mask:
        mask = (rng.rand(B * H, L, L) >= RATE).astype(np.int8)
    kw = dict(causal=causal, num_heads=H)
    return (q, k, v, do, bias, mask), kw, (RATE if with_mask else 0.0)


@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('L', [128, 512])
@pytest.mark.parametrize('case', list(BHLD_CASES))
def test_bhld_forward_and_backward_match_pallas(case, L, D):
    (q, k, v, do, bias, mask), kw, rate = _bhld_case(case, L, D, seed=L + D)
    o, lse = tfa._flash_forward(_t(q), _t(k), _t(v), bias=_t(bias),
                                dropout_mask=_t(mask), dropout=rate, **kw)
    jo, jlse = jfa._flash_forward(_j(q), _j(k), _j(v), bias=_j(bias),
                                  dropout_mask=_j(mask), dropout=rate,
                                  with_lse=True, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FP32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **FP32)
    got = tfa._flash_backward(_t(q), _t(k), _t(v), o, lse, _t(do),
                              bias=_t(bias), dropout_mask=_t(mask),
                              dropout=rate, **kw)
    want = jfa._flash_backward(_j(q), _j(k), _j(v), jo, jlse, _j(do),
                               bias=_j(bias), dropout_mask=_j(mask),
                               dropout=rate, **kw)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **FP32)


@pytest.mark.parametrize('case', ['causal', 'causal_mask', 'full_bias'])
def test_bhld_function_gradients_match_custom_vjps(case):
    """The port's autograd Function under each entry against jax.grad
    through the reference's custom VJP of the same case (no custom VJP
    takes both a bias and a mask; the test above holds the bodies on
    that case)."""
    (q, k, v, _do, bias, mask), kw, rate = _bhld_case(case, 128, 32, seed=4)
    causal = kw['causal']

    def entry(mod, qa, ka, va, bias_a, mask_a):
        if mask_a is not None:
            return mod._flash_attn_dropout(rate, qa, ka, va, mask_a)
        if bias_a is not None:
            return mod._flash_attn_biased(causal, H, qa, ka, va, bias_a)
        return mod.flash_attention_bhld(qa, ka, va)

    jl, jg = jax.value_and_grad(
        lambda qa, ka, va: jnp.sum(entry(jfa, qa, ka, va, _j(bias),
                                         _j(mask)) ** 2),
        argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else _t(bias).requires_grad_()
    loss = (entry(tfa, *leaves, tb, _t(mask)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    for got, want in zip(leaves, jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **FP32)
    if tb is not None:                      # the key bias gets zeros (:788)
        assert tb.grad is not None and not tb.grad.any()


def test_causal_attention_with_dropout_matches_jax_on_one_mask(monkeypatch):
    L = 128
    rng = np.random.RandomState(9)
    qkv = rng.randn(B, L, H * 3 * D).astype(np.float32)
    keep = rng.rand(B, H, L, L) >= RATE
    drawn = []

    def jax_bernoulli(key, p, shape):
        assert tuple(shape) == keep.shape and abs(p - (1 - RATE)) < 1e-12
        return jnp.asarray(keep)

    def torch_keep(shape, keep_prob, device):
        drawn.append(tuple(shape))
        assert abs(keep_prob - (1 - RATE)) < 1e-12
        return torch.from_numpy(keep).to(device)

    monkeypatch.setattr(jax.random, 'bernoulli', jax_bernoulli)
    monkeypatch.setattr(trng, 'keep_mask', torch_keep)
    want = jfa.causal_attention(Tensor(jnp.asarray(qkv)), H, D,
                                dropout=RATE, dropout_key=jax.random.key(0))
    tq = torch.from_numpy(qkv).requires_grad_()
    got = tfa.causal_attention(tq, H, D, dropout=RATE)
    assert drawn == [(B, H, L, L)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.data),
                               **FP32)
    assert got.grad_fn is not None
    got.square().sum().backward()
    assert tq.grad is not None and bool(tq.grad.abs().sum() > 0)


def test_causal_attention_dropout_errors_match_the_reference():
    qkv = np.zeros((1, 64, H * 3 * D), np.float32)
    tq, jq = torch.from_numpy(qkv), Tensor(jnp.asarray(qkv))
    for rate in (1.5, -0.1, 1.0):
        with pytest.raises(ValueError, match='rate'):
            tfa.causal_attention(tq, H, D, dropout=rate)
        with pytest.raises(ValueError, match='rate'):
            jfa.causal_attention(jq, H, D, dropout=rate,
                                 dropout_key=jax.random.key(0))
    # no bound generator: the counterpart of the reference's missing key
    with pytest.raises(RuntimeError, match='bound generator'):
        tfa.causal_attention(tq, H, D, dropout=0.1)
    with pytest.raises(ValueError, match='dropout_key'):
        jfa.causal_attention(jq, H, D, dropout=0.1)
    with trng.rng_guard(torch.Generator().manual_seed(0)):
        out = tfa.causal_attention(tq, H, D, dropout=0.1)
    assert out.shape == (1, 64, H * D)


@pytest.mark.parametrize('with_bias,causal', [(False, True), (False, False),
                                              (True, False), (True, True)],
                         ids=['causal', 'full', 'full_bias', 'causal_bias'])
def test_flash_attention_matches_the_reference(with_bias, causal):
    L = 128
    (q, k, v, _do, bias, _m), _kw, _r = _bhld_case(
        'full_bias' if with_bias else 'causal', L, 64, seed=6)

    def loss_j(qa, ka, va):
        return jnp.sum(jfa.flash_attention(qa, ka, va, bias=_j(bias),
                                           num_heads=H, causal=causal) ** 2)

    jl, jg = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        _j(q), _j(k), _j(v))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, bias=_t(bias), num_heads=H,
                              causal=causal)
    loss = (out ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    for got, want in zip(leaves, jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize('with_bias,causal', [(True, False), (False, True)],
                         ids=['full_bias', 'causal'])
def test_mha_flash_attention_matches_the_reference(with_bias, causal):
    L = 128
    rng = np.random.RandomState(12)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    bias = np.where(rng.rand(B, L) > 0.3, 0.0, -1e9).astype(np.float32) \
        if with_bias else None
    want = jfa.mha_flash_attention(*(Tensor(jnp.asarray(a))
                                     for a in (q, k, v)),
                                   key_bias=bias, causal=causal)
    got = tfa.mha_flash_attention(_t(q), _t(k), _t(v), key_bias=_t(bias),
                                  causal=causal)
    assert got.shape == (B, H, L, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data), **FP32)


def test_bhld_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(4, 64, 64)
    with pytest.raises(ValueError, match='head_dim 48'):
        tfa._check_bhld(q[..., :48], q[..., :48], q[..., :48], None, None, 2,
                        tfa.BHLD_FWD_KERNEL)
    with pytest.raises(ValueError, match='multiple of 3 heads'):
        tfa._check_bhld(q, q, q, None, None, 3, tfa.BHLD_FWD_KERNEL)
    with pytest.raises(ValueError, match='bias'):
        tfa._check_bhld(q, q, q, torch.zeros(4, 64), None, 2,
                        tfa.BHLD_FWD_KERNEL)
    with pytest.raises(ValueError, match='keep mask'):
        tfa._check_bhld(q, q, q, None, torch.ones(4, 64, 64), 2,
                        tfa.BHLD_FWD_KERNEL)
    for dt in tfa.MASK_DTYPES:
        tfa._check_bhld(q, q, q, torch.zeros(2, 64),
                        torch.ones(4, 64, 64, dtype=dt), 2,
                        tfa.BHLD_FWD_KERNEL)


# ---------------------------------------------------------------------------
# the bf16 backward's rounding on the tensor cores, grounded on the CPU
# ---------------------------------------------------------------------------
# chip_smoke.py's `flash_bf16_tc` (and tests/test_torch_cuda.py's
# FLASH_BF16_TC): per element |got - want| <= ATOL_X_RMS * RMS(want) +
# RTOL * |want|, and relative L2 error <= REL_L2. The CPU emulation below
# must hold it with a margin of TC_MARGIN (ATOL_X_RMS and REL_L2 divided
# by it; RTOL covers the output's own bf16 rounding and stays), since the
# card's gradients are larger samples of the same rounding. Why the atol
# is 2^-3 of the RMS, not flash_bf16's 2^-6: each row of dS sums to zero
# (sum_j p (dP - delta) = 0), so dQ, dK and dV are sums with cancellation,
# and each term's bf16 rounding (2^-9 of the term) can be a few percent of
# the RMS where the sum is small beside its terms (measured here up to
# 0.041 of the RMS at L=256, 0.055 at L=2048; relative L2 2.4e-3 to
# 2.7e-3 everywhere).
TC_BAR = dict(atol_x_rms=2.0 ** -3, rtol=2.0 ** -7, rel_l2=1e-2)
TC_MARGIN = 2.0


def _tc_backward(q, k, v, o, lse, do, bias=None, num_heads=1, causal=True,
                 dropout_mask=None, dropout=0.0):
    """The bf16 tensor-core backward's arithmetic in PyTorch on BHLD
    [B*H, L, D] tensors: the plain backward (fp32 products of the bf16
    inputs), with P keep and dS rounded to bf16 before the P·dO, dS·K and
    dS·Q products, and the results rounded to q's dtype."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = tfa._masked(torch.matmul(qf, kf.transpose(-1, -2)) * scale, bias,
                    num_heads, causal)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    pk = p
    if dropout_mask is not None:
        keep = tfa._keep_factor(dropout_mask, dropout)
        dp, pk = dp * keep, p * keep
    ds = p * (dp - tfa.bhld_delta(o, do)[..., None])
    ds, pk = (x.to(torch.bfloat16).float() for x in (ds, pk))
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(pk.transpose(-1, -2), dof)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def _assert_tc_bar(got, want, name, bar=TC_BAR):
    """`bar` with the margin: ATOL_X_RMS and REL_L2 over TC_MARGIN."""
    g, w = got.float(), torch.from_numpy(np.array(want, np.float32))
    err = (g - w).abs()
    norm = float(w.norm())
    rel = float(err.norm()) / norm
    assert rel <= bar['rel_l2'] / TC_MARGIN, f'{name}: rel L2 {rel:.3g}'
    atol = bar['atol_x_rms'] / TC_MARGIN * norm / w.numel() ** 0.5
    bad = err > atol + bar['rtol'] * w.abs()
    assert not bool(bad.any()), (
        f'{name}: {int(bad.sum())} elements outside; max |diff| '
        f'{float(err.max()):.3g}')


def _bf16(a):
    """The same seeded numpy values rounded to bf16 on both sides."""
    return (torch.from_numpy(a).to(torch.bfloat16),
            jnp.asarray(a, dtype=jnp.bfloat16))


@pytest.mark.parametrize('D', [32, 64])
def test_tc_rounding_holds_its_bar_against_the_pallas_packed_backward(D):
    L = 256
    rng = np.random.RandomState(40 + D)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (
        _bf16(rng.randn(B, L, H * D).astype(np.float32)) for _ in range(4))
    jo, jlse = jfa._flash_forward_packed(jq, jk, jv, num_heads=H,
                                         head_dim=D, causal=True,
                                         with_lse=True)
    want = jfa._flash_backward_packed(jq, jk, jv, jo, jlse, jdo,
                                      num_heads=H, head_dim=D, causal=True)
    o = torch.from_numpy(np.array(jo.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.array(jlse))            # [B, L, H] fp32

    def bhld(t):
        return t.reshape(B, L, H, D).transpose(1, 2).reshape(B * H, L, D)

    got = _tc_backward(bhld(tq), bhld(tk), bhld(tv), bhld(o),
                       lse.transpose(1, 2).reshape(B * H, L), bhld(tdo))
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        w = np.asarray(w.astype(jnp.float32))
        w = w.reshape(B, L, H, D).transpose(0, 2, 1, 3).reshape(B * H, L, D)
        _assert_tc_bar(g, w, name)


@pytest.mark.parametrize('case', ['causal_mask', 'full_bias',
                                  'causal_bias_mask'])
def test_tc_rounding_holds_its_bar_against_the_pallas_bhld_backward(case):
    L, D = 256, 64
    (q, k, v, do, bias, mask), kw, rate = _bhld_case(case, L, D, seed=50)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (_bf16(a)
                                                for a in (q, k, v, do))
    jo, jlse = jfa._flash_forward(jq, jk, jv, bias=_j(bias),
                                  dropout_mask=_j(mask), dropout=rate,
                                  with_lse=True, **kw)
    want = jfa._flash_backward(jq, jk, jv, jo, jlse, jdo, bias=_j(bias),
                               dropout_mask=_j(mask), dropout=rate, **kw)
    o = torch.from_numpy(np.array(jo.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.array(jlse))[..., 0]
    got = _tc_backward(tq, tk, tv, o, lse, tdo, bias=_t(bias),
                       dropout_mask=_t(mask), dropout=rate, **kw)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        _assert_tc_bar(g, np.asarray(w.astype(jnp.float32)), name)


# ---------------------------------------------------------------------------
# the bf16 forward's rounding on the tensor cores, grounded on the CPU
# ---------------------------------------------------------------------------
# The tensor-core forward takes P keep as two bf16 terms, hi = P keep
# rounded and lo = the rest rounded, and adds hi·V + lo·V (16 significant
# bits); everything else is fp32. Its o is held at chip_smoke.py's
# `flash_bf16` (atol 2^-6 of the RMS, rtol 2^-7, relative L2 1e-2) and its
# lse at `flash_fp32` (atol 1e-3 of the RMS, rtol 1e-3, relative L2 1e-4),
# the bars of the CUDA-core forward; the emulation below must hold both
# against the Pallas forward bodies with the margin TC_MARGIN. (P keep
# rounded once to bf16, 2^-9 of each term, would not: o is a weighted mean
# of V rows of magnitude ~1 whose RMS falls to 0.08-0.3 as they cancel,
# and the rounding reached 0.019 of o's RMS beyond rtol here, at L=512
# with a keep mask.)
FWD_BAR = dict(atol_x_rms=2.0 ** -6, rtol=2.0 ** -7, rel_l2=1e-2)
LSE_BAR = dict(atol_x_rms=1e-3, rtol=1e-3, rel_l2=1e-4)
TC_TILE = 64            # the kernel's key tile (csrc/flash_attention.cu)


def _tc_forward(q, k, v, bias=None, num_heads=1, causal=True,
                dropout_mask=None, dropout=0.0):
    """The bf16 tensor-core forward's arithmetic in PyTorch on BHLD
    [B*H, L, D] tensors: S = (q k^T) * scale in fp32 from the bf16
    inputs (the scale after the dot), the key bias, the causal mask, an
    online softmax over tiles of TC_TILE keys whose fp32 normalizer sums
    the undropped p, P keep split into two bf16 terms before P·V; o in
    q's dtype, lse fp32."""
    scale = np.float32(1.0 / np.sqrt(q.shape[-1]))
    s = tfa._masked(torch.matmul(q.float(), k.float().transpose(-1, -2))
                    * scale, bias, num_heads, causal)
    keep = (None if dropout_mask is None
            else tfa._keep_factor(dropout_mask, dropout))
    BH, L, D = q.shape
    m = torch.full((BH, L, 1), tfa.NEG_INF)
    l = torch.zeros(BH, L, 1)
    acc = torch.zeros(BH, L, D)
    for k0 in range(0, L, TC_TILE):
        blk = s[..., k0:k0 + TC_TILE]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        p = torch.exp(blk - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        if keep is not None:
            p = p * keep[..., k0:k0 + TC_TILE]
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        vt = v[:, k0:k0 + TC_TILE].float()
        acc = alpha * acc + (torch.matmul(lo, vt) + torch.matmul(hi, vt))
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return (acc / l_safe).to(q.dtype), (m + torch.log(l_safe))[..., 0]


@pytest.mark.parametrize('L', [129, 200, 512])
@pytest.mark.parametrize('D', [64, 128])
@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
def test_tc_forward_rounding_holds_its_bar_against_the_pallas_packed_forward(
        causal, D, L):
    rng = np.random.RandomState(60 + D + L)
    (tq, jq), (tk, jk), (tv, jv) = (
        _bf16(rng.randn(B, L, H * D).astype(np.float32)) for _ in range(3))
    jo, jlse = jfa._flash_forward_packed(jq, jk, jv, num_heads=H,
                                         head_dim=D, causal=causal,
                                         with_lse=True)

    def bhld(t):
        return t.reshape(B, L, H, D).transpose(1, 2).reshape(B * H, L, D)

    o, lse = _tc_forward(bhld(tq), bhld(tk), bhld(tv), causal=causal)
    want_o = bhld(torch.from_numpy(np.array(jo.astype(jnp.float32))))
    want_lse = np.array(jlse).transpose(0, 2, 1).reshape(B * H, L)
    _assert_tc_bar(o, want_o.numpy(), 'o', FWD_BAR)
    _assert_tc_bar(lse, want_lse, 'lse', LSE_BAR)


@pytest.mark.parametrize('L', [129, 200, 512])
@pytest.mark.parametrize('D', [64, 128])
@pytest.mark.parametrize('case', ['causal_mask', 'full_bias',
                                  'causal_bias_mask'])
def test_tc_forward_rounding_holds_its_bar_against_the_pallas_bhld_forward(
        case, D, L):
    (q, k, v, _do, bias, mask), kw, rate = _bhld_case(case, L, D,
                                                      seed=70 + D + L)
    (tq, jq), (tk, jk), (tv, jv) = (_bf16(a) for a in (q, k, v))
    jo, jlse = jfa._flash_forward(jq, jk, jv, bias=_j(bias),
                                  dropout_mask=_j(mask), dropout=rate,
                                  with_lse=True, **kw)
    o, lse = _tc_forward(tq, tk, tv, bias=_t(bias), dropout_mask=_t(mask),
                         dropout=rate, **kw)
    _assert_tc_bar(o, np.asarray(jo.astype(jnp.float32)), 'o', FWD_BAR)
    _assert_tc_bar(lse, np.asarray(jlse)[..., 0], 'lse', LSE_BAR)
