"""paddle_tpu_torch kernels' plain versions vs the JAX package.

Each kernel module of the port (ops/kernels/{fused_norm,
fused_elementwise,paged_attention,flash_attention}.py) keeps a plain
PyTorch version that CPU tensors route to (the flash kernels are held
in tests/test_torch_flash.py). Here the same numpy inputs (seeded) go
through that version and through the JAX package's two routes: the jnp
reference and the Pallas kernel body under interpret mode (the JAX
package's own CPU coverage of its kernels). Tolerances: fp32 at rtol
2e-4 / atol 2e-5 (float summation order), bf16 at 5e-2 (the routes
round at different points).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against the plain versions there, and chip_smoke.py does the
same at the serving path's shapes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import flags
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops.pallas import fused_elementwise as jfe
from paddle_tpu.ops.pallas import fused_norm as jfn
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_elementwise as tfe
from paddle_tpu_torch.ops.kernels import fused_norm as tfn
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
DTYPES = {'float32': (np.float32, jnp.float32, torch.float32, FP32),
          'bfloat16': (np.float32, jnp.bfloat16, torch.bfloat16, BF16)}


def _j(a, jdt):
    return jnp.asarray(a, jdt)


def _t(a, tdt):
    return torch.from_numpy(np.array(a)).to(tdt)


def _np(x):
    x = x.data if isinstance(x, Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_layer_norm_plain_matches_jax_routes(dtype):
    _ndt, jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32) * 2 + 0.5
    w = 1 + 0.1 * rng.randn(64).astype(np.float32)
    b = 0.1 * rng.randn(64).astype(np.float32)
    got = _np(tfn.layer_norm_plain(_t(x, tdt), _t(w, tdt), _t(b, tdt),
                                   1e-5))
    ref = jnn.layer_norm(Tensor(_j(x, jdt)), 64, Tensor(_j(w, jdt)),
                         Tensor(_j(b, jdt)), 1e-5)
    np.testing.assert_allclose(got, _np(ref), **tol)
    pallas = jfn.fused_layer_norm(_j(x, jdt), _j(w, jdt), _j(b, jdt), 1e-5)
    np.testing.assert_allclose(got, _np(pallas), **tol)


def test_layer_norm_gate_promotes_mixed_dtypes_like_jnp():
    # nn_ops.py:243-246: bf16 x with fp32 weight/bias skips the fused
    # route; the unfused path promotes to fp32 exactly as jnp does
    rng = np.random.RandomState(1)
    x = rng.randn(4, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    got = tnn.layer_norm(_t(x, torch.bfloat16), 32, _t(w, torch.float32),
                         _t(b, torch.float32))
    assert got.dtype == torch.float32
    ref = jnn.layer_norm(Tensor(_j(x, jnp.bfloat16)), 32,
                         Tensor(_j(w, jnp.float32)), Tensor(_j(b, jnp.float32)))
    assert ref.data.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(ref), **FP32)


def test_layer_norm_multi_axis_unfused_path():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 4, 8).astype(np.float32)
    w = rng.randn(4, 8).astype(np.float32)
    b = rng.randn(4, 8).astype(np.float32)
    got = tnn.layer_norm(_t(x, torch.float32), [4, 8], _t(w, torch.float32),
                         _t(b, torch.float32))
    ref = jnn.layer_norm(Tensor(jnp.asarray(x)), [4, 8],
                         Tensor(jnp.asarray(w)), Tensor(jnp.asarray(b)))
    np.testing.assert_allclose(_np(got), _np(ref), **FP32)


# ---------------------------------------------------------------------------
# bias + GELU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('approximate', [True, False], ids=['tanh', 'erf'])
@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_bias_gelu_plain_matches_jax_routes(dtype, approximate):
    _ndt, jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(3)
    x = 2 * rng.randn(3, 7, 48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    got = _np(tfe.bias_gelu_plain(_t(x, tdt), _t(b, torch.float32),
                                  approximate))
    ref = jfe.bias_gelu_reference(_j(x, jdt), _j(b, jnp.float32),
                                  approximate)
    np.testing.assert_allclose(got, _np(ref), **tol)
    pallas = jfe.bias_gelu(_j(x, jdt), _j(b, jnp.float32), approximate)
    np.testing.assert_allclose(got, _np(pallas), **tol)


@pytest.mark.parametrize('approximate', [True, False], ids=['tanh', 'erf'])
def test_gelu_and_bias_none_match_jax(approximate):
    rng = np.random.RandomState(4)
    x = 3 * rng.randn(5, 16).astype(np.float32)
    got = tnn.bias_gelu(_t(x, torch.float32), None, approximate=approximate)
    ref = jnn.gelu(Tensor(jnp.asarray(x)), approximate=approximate)
    np.testing.assert_allclose(_np(got), _np(ref), **FP32)


# the forward kernel's grid (csrc/fused_elementwise.cu bias_gelu_fwd_kernel):
# CTA (tile, chunk), thread t owns vector tile * FWD_TILE_VECS + t of every
# row of its chunk. The gpt_1p3b shapes (decode, prefill, the train step),
# ragged widths and row counts, and more rows than one grid row holds chunks.
FWD_GRID_SHAPES = [(8, 8192), (1024, 8192), (16384, 8192), (16384, 2048),
                   (1, 1), (2, 37), (7, 2056), (2049, 8200), (300, 40000),
                   (100_003, 64), (300_001, 64)]


def _fwd_coverage(rows, n, dtype, sms):
    """How many threads of the kernel visit each row and each 16-byte
    vector of a row under `bias_gelu_fwd_grid`: (row counts, vector
    counts, the grid)."""
    vectors = -(-n // (16 // dtype.itemsize))
    tiles, chunks, per = tfe.bias_gelu_fwd_grid(rows, n, dtype, sms)
    assert 1 <= chunks <= tfe.MAX_GRID_Y and per >= 1
    row_count = np.zeros(rows, np.int64)
    for chunk in range(chunks):          # chunk i: rows [i per, (i+1) per)
        row_count[chunk * per:(chunk + 1) * per] += 1
    # thread t of tile i owns vector i * FWD_TILE_VECS + t; threads past
    # the row's last vector return at once
    owned = np.arange(tiles * tfe.FWD_TILE_VECS)
    vec_count = np.bincount(owned[owned < vectors], minlength=vectors)
    assert owned.size - vectors < tfe.FWD_TILE_VECS
    return row_count, vec_count, (tiles, chunks, per)


@pytest.mark.parametrize('sms', [1, 8, 132])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,n', FWD_GRID_SHAPES)
def test_bias_gelu_fwd_grid_covers_every_vector_once(rows, n, dtype, sms):
    row_count, vec_count, (tiles, chunks, per) = _fwd_coverage(rows, n,
                                                               dtype, sms)
    assert (row_count == 1).all() and (vec_count == 1).all()
    assert (chunks - 1) * per < rows           # no chunk is empty
    if rows * tiles <= tfe.FWD_CTAS_PER_SM * sms:
        # a decode step: a row a chunk, one vector a thread, no row loop
        assert per == 1 and chunks == rows
    else:
        # one trip of FWD_LOADS rows a CTA, unless the grid's 65535 rows
        # of chunks cannot hold them so
        assert per == max(tfe.FWD_LOADS, -(-rows // tfe.MAX_GRID_Y))


def test_bias_gelu_fwd_grid_at_gpt_1p3b_shapes():
    # decode: 8 rows of ffn 8192 bf16 -> 4 tiles x 8 chunks of one row;
    # a 128-token prefill of 8 rows and the train step: chunks of 4 rows
    assert tfe.bias_gelu_fwd_grid(8, 8192, torch.bfloat16, 132) == (4, 8, 1)
    assert tfe.bias_gelu_fwd_grid(1024, 8192, torch.bfloat16, 132) == (
        4, 256, 4)
    assert tfe.bias_gelu_fwd_grid(16384, 8192, torch.bfloat16, 132) == (
        4, 4096, 4)
    # past 65535 chunks of 4 rows, chunks lengthen (the kernel's row loop)
    assert tfe.bias_gelu_fwd_grid(300_000, 64, torch.float32, 132) == (
        1, 60000, 5)


def _kernel_gelu_tanh(x, b):
    """csrc/fused_elementwise.cu's tanh form, emulated: u = x + b in x's
    dtype, then in fp32 w = u * fma(K a, u * u, K) (K = -2 log2(e)
    sqrt(2/pi), a = 0.044715; the fma rounds once), 2^w (ex2.approx, taken
    here as the correctly rounded 2^w), y = u / (1 + 2^w), rounded once to
    x's dtype."""
    u = (x + b.to(x.dtype)).float()
    k = np.float32(-2 * math.log2(math.e) * math.sqrt(2 / math.pi))
    ka = np.float32(float(k) * 0.044715)
    uu = u * u
    f = (float(ka) * uu.double() + float(k)).float()
    w = u * f
    y = u / (1.0 + torch.exp2(w.double()).float())
    return y.to(x.dtype)


# tests/test_torch_cuda.py's bar for the bf16 elementwise kernels
BF16_ELEMENTWISE = dict(rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('shape', [(8, 8192), (64, 2048), (2, 37)])
def test_kernel_tanh_form_matches_pallas_body_and_plain(shape, dtype):
    """The forward kernel computes gelu(u) = u * 0.5 (1 + tanh z) as
    u / (1 + e^(-2z)); emulated in fp32, it matches the Pallas
    `_bg_fwd_kernel` (interpret mode) and the plain version."""
    _ndt, jdt, tdt, _tol = DTYPES[dtype]
    tol = FP32 if dtype == 'float32' else BF16_ELEMENTWISE
    rng = np.random.RandomState(23)
    x = 3 * rng.randn(*shape).astype(np.float32)
    b = 0.5 * rng.randn(shape[-1]).astype(np.float32)
    got = _np(_kernel_gelu_tanh(_t(x, tdt), _t(b, torch.float32)))
    pallas = jfe.bias_gelu(_j(x, jdt), _j(b, jnp.float32), True)
    np.testing.assert_allclose(got, _np(pallas), **tol)
    plain = tfe.bias_gelu_plain(_t(x, tdt), _t(b, torch.float32), True)
    np.testing.assert_allclose(got, _np(plain), **tol)


# ---------------------------------------------------------------------------
# the backward kernels' plain versions and the autograd Functions
# ---------------------------------------------------------------------------
def _jax_vjp(fn, primals, cot):
    """(out, grads) of fn at `primals` (arrays) with cotangent `cot`; fn
    runs the JAX package's Tensor ops under its no_grad, as a jitted
    train step does."""
    def f(*arrays):
        with no_grad():
            return fn(*[Tensor(a) for a in arrays]).data
    out, vjp = jax.vjp(f, *primals)
    return out, vjp(cot)


def _torch_vjp(fn, primals, cot):
    leaves = [p.clone().requires_grad_() for p in primals]
    out = fn(*leaves)
    out.backward(cot)
    return out, [p.grad for p in leaves]


@pytest.fixture
def fused_flags():
    """Forces the JAX package's fused (Pallas, interpret-mode) routes on,
    as tests/test_fused_primitives.py does, and restores auto after."""
    def force(on):
        flags.set_flags({'FLAGS_fused_layer_norm': on,
                         'FLAGS_fused_elementwise': on})
    yield force
    force(None)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_layer_norm_bwd_plain_matches_pallas_body(dtype):
    _ndt, jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(11)
    x = rng.randn(150, 64).astype(np.float32) * 2 + 0.5
    w = 1 + 0.1 * rng.randn(64).astype(np.float32)
    b = 0.1 * rng.randn(64).astype(np.float32)
    dy = rng.randn(150, 64).astype(np.float32)
    _y, mean, rstd = tfn.layer_norm_fwd_plain(_t(x, tdt), _t(w, tdt),
                                              _t(b, tdt), 1e-5)
    got = tfn.layer_norm_bwd_plain(_t(x, tdt), _t(w, tdt), _t(dy, tdt),
                                   mean, rstd)
    _o, jmean, jrstd = jfn._fwd_pallas(_j(x, jdt), _j(w, jdt), _j(b, jdt),
                                       1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:150, 0],
                               **FP32)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:150, 0],
                               **FP32)
    want = jfn._bwd_pallas(_j(x, jdt), _j(w, jdt), _j(dy, jdt), jmean, jrstd)
    for g, e in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(e), **tol)


@pytest.mark.parametrize('fused', [True, False], ids=['pallas', 'jnp'])
@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_layer_norm_function_grads_match_jax_grad(dtype, fused,
                                                  fused_flags):
    """The port's LayerNormFunction (autograd, plain CPU route) against
    jax.vjp of nn_ops.layer_norm on the fused custom-VJP route (Pallas
    bodies) and on the jnp route."""
    _ndt, jdt, tdt, tol = DTYPES[dtype]
    fused_flags(fused)
    rng = np.random.RandomState(12)
    x = rng.randn(3, 50, 64).astype(np.float32)
    w = 1 + 0.1 * rng.randn(64).astype(np.float32)
    b = 0.1 * rng.randn(64).astype(np.float32)
    cot = rng.randn(3, 50, 64).astype(np.float32)
    jout, jg = _jax_vjp(lambda a, c, d: jnn.layer_norm(a, 64, c, d, 1e-5),
                        [_j(a, jdt) for a in (x, w, b)], _j(cot, jdt))
    tout, tg = _torch_vjp(lambda a, c, d: tnn.layer_norm(a, 64, c, d, 1e-5),
                          [_t(a, tdt) for a in (x, w, b)], _t(cot, tdt))
    assert tout.grad_fn is not None
    np.testing.assert_allclose(_np(tout.detach()), _np(jout), **tol)
    for g, e in zip(tg, jg):
        assert g.dtype == tdt
        if dtype == 'bfloat16' and not fused:
            # XLA's autodiff of the jnp route sums dw and db over the 150
            # rows in bf16, ~sqrt(150) * 2^-8 relative noise; the port
            # (like the Pallas route above) sums in fp32. Bar: 4 % of the
            # largest entry.
            tol = dict(rtol=5e-2, atol=4e-2 * float(np.abs(_np(e)).max()))
        np.testing.assert_allclose(_np(g), _np(e), **tol)


@pytest.mark.parametrize('approximate', [True, False], ids=['tanh', 'erf'])
@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_bias_gelu_bwd_plain_matches_pallas_body(dtype, approximate):
    _ndt, jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(13)
    x = 2 * rng.randn(150, 48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    dy = rng.randn(150, 48).astype(np.float32)
    dx, db = tfe.bias_gelu_bwd_plain(_t(x, tdt), _t(b, tdt), _t(dy, tdt),
                                     approximate)
    jdx, jdb = jfe._bg_bwd(approximate, (_j(x, jdt), _j(b, jdt)),
                           _j(dy, jdt))
    np.testing.assert_allclose(_np(dx), _np(jdx), **tol)
    np.testing.assert_allclose(_np(db), _np(jdb), **tol)
    u = torch.linspace(-6, 6, 241)
    np.testing.assert_allclose(
        tfe.gelu_grad_f32(u, approximate).numpy(),
        np.asarray(jfe._gelu_grad(jnp.asarray(u.numpy()), approximate)),
        **FP32)


@pytest.mark.parametrize('fused', [True, False], ids=['pallas', 'jnp'])
@pytest.mark.parametrize('approximate', [True, False], ids=['tanh', 'erf'])
@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_bias_gelu_function_grads_match_jax_grad(dtype, approximate, fused,
                                                 fused_flags):
    _ndt, jdt, tdt, tol = DTYPES[dtype]
    fused_flags(fused)
    rng = np.random.RandomState(14)
    x = 2 * rng.randn(3, 20, 48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    cot = rng.randn(3, 20, 48).astype(np.float32)
    jout, jg = _jax_vjp(
        lambda a, c: jnn.bias_gelu(a, c, approximate=approximate),
        [_j(x, jdt), _j(b, jdt)], _j(cot, jdt))
    tout, tg = _torch_vjp(
        lambda a, c: tnn.bias_gelu(a, c, approximate=approximate),
        [_t(x, tdt), _t(b, tdt)], _t(cot, tdt))
    assert tout.grad_fn is not None
    np.testing.assert_allclose(_np(tout.detach()), _np(jout), **tol)
    for g, e in zip(tg, jg):
        assert g.dtype == tdt
        np.testing.assert_allclose(_np(g), _np(e), **tol)


def test_dropout_add_eval_is_plain_add_and_training_raises():
    """At eval or p=0 a plain add; in training it needs a bound
    generator (tests/test_torch_dropout.py holds the training route)."""
    a, r = torch.randn(2, 3), torch.randn(2, 3)
    assert torch.equal(tnn.dropout_add(a, r, p=0.1, training=False), a + r)
    assert torch.equal(tnn.dropout_add(a, r, p=0.0, training=True), a + r)
    with pytest.raises(RuntimeError, match='bound generator'):
        tnn.dropout_add(a, r, p=0.1, training=True)


# ---------------------------------------------------------------------------
# ragged paged attention
# ---------------------------------------------------------------------------
def _mixed_case_with_idle_row(seed=0):
    """tests/test_serving.py::_mixed_case — a decode row, a pure-prefill
    row and a long multi-page row with padding, page tables shuffled so
    page order != pool order — plus the engine's idle decode slot
    (seq_len 1, q_len 0, page row of zeros: engine.py:1735-1741)."""
    rng = np.random.RandomState(seed)
    B, T, H, D, ps, P = 3, 4, 2, 8, 8, 4
    HD = H * D
    num_pages = B * P + 3
    q = rng.randn(B + 1, T, HD).astype(np.float32)
    k_pages = rng.randn(num_pages, ps, HD).astype(np.float32)
    v_pages = rng.randn(num_pages, ps, HD).astype(np.float32)
    page_tables = rng.permutation(num_pages)[:B * P] \
        .reshape(B, P).astype(np.int32)
    page_tables = np.concatenate([page_tables, np.zeros((1, P), np.int32)])
    lens = np.asarray([[13, 1], [4, 4], [29, 2], [1, 0]], np.int32)
    return (q, k_pages, v_pages, page_tables, lens[:, 0], lens[:, 1], H, D)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_ragged_paged_attention_plain_matches_jax_routes(dtype):
    _ndt, jdt, tdt, tol = DTYPES[dtype]
    q, kp, vp, pt, sl, ql, H, D = _mixed_case_with_idle_row()
    got = _np(tpa.ragged_paged_attention_plain(
        _t(q, tdt), _t(kp, tdt), _t(vp, tdt), torch.from_numpy(pt),
        torch.from_numpy(sl), torch.from_numpy(ql), num_heads=H,
        head_dim=D))
    jargs = (_j(q, jdt), _j(kp, jdt), _j(vp, jdt), jnp.asarray(pt),
             jnp.asarray(sl), jnp.asarray(ql))
    # the Pallas body computes exactly what the plain version does, on
    # every row, padding included
    pallas = _np(jpa.ragged_paged_attention_pallas(*jargs, num_heads=H,
                                                   head_dim=D))
    np.testing.assert_allclose(got, pallas, **tol)
    # the dense route differs only on queries with no visible key;
    # compare the valid queries, as tests/test_serving.py:270-273 does
    dense = _np(jpa.ragged_paged_attention_dense(*jargs, num_heads=H,
                                                 head_dim=D))
    for b in range(q.shape[0]):
        np.testing.assert_allclose(got[b, :ql[b]], dense[b, :ql[b]], **tol)
    # the idle slot sees key 0 of page 0 only
    np.testing.assert_allclose(got[3], np.tile(_np(_t(vp, tdt))[0, 0], (4, 1)),
                               **tol)


def test_ragged_paged_attention_no_visible_key_semantics():
    # a seq_len-0 row visits no page: the max(l, 1e-30) normaliser
    # writes zeros (paged_attention.py:148); a query before every key
    # (q_len > seq_len) averages the visited page's V like the Pallas
    # loop's exp(-1e30 - -1e30) = 1 weights
    rng = np.random.RandomState(5)
    H, D, ps, P, N, T = 1, 4, 4, 2, 3, 3
    q = rng.randn(2, T, H * D).astype(np.float32)
    kp = rng.randn(N, ps, H * D).astype(np.float32)
    vp = rng.randn(N, ps, H * D).astype(np.float32)
    pt = np.asarray([[1, 2], [2, 1]], np.int32)
    sl = np.asarray([0, 2], np.int32)
    ql = np.asarray([1, 3], np.int32)
    got = _np(tpa.ragged_paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(sl), torch.from_numpy(ql),
        num_heads=H, head_dim=D))
    pallas = _np(jpa.ragged_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(sl), jnp.asarray(ql), num_heads=H, head_dim=D))
    np.testing.assert_allclose(got, pallas, **FP32)
    assert not got[0].any()
    np.testing.assert_allclose(got[1, 0], vp[2].mean(0), **FP32)


def test_flat_slots_match_jax():
    _q, _kp, _vp, pt, sl, ql, _H, _D = _mixed_case_with_idle_row(seed=2)
    T, N, ps = 4, 15, 8
    got = tpa._flat_slots(torch.from_numpy(pt), torch.from_numpy(sl),
                          torch.from_numpy(ql), T, N, ps).numpy()
    ref = np.asarray(jpa._flat_slots(jnp.asarray(pt), jnp.asarray(sl),
                                     jnp.asarray(ql), T, N, ps))
    np.testing.assert_array_equal(got, ref)


def test_write_kv_pages_drops_padding_and_spares_page_0():
    # the port's pages end in the sink page (index N), where padding
    # lands; the N pages a table maps are the JAX scatter's, which drops
    # padding through an out-of-range index
    ps, HD, N = 4, 6, 5
    k_new = np.arange(3 * 3 * HD, dtype=np.float32).reshape(3, 3, HD) + 1.0
    # row 0: 2 valid tokens at positions 5, 6 (page_table[1] slots 1, 2);
    # row 1: q_len=0 on pages 2; row 2: the engine's idle slot — q_len 0
    # with a page row of zeros: nothing may reach page 0
    pt = np.asarray([[3, 1, 0, 0], [2, 2, 2, 2], [0, 0, 0, 0]], np.int32)
    sl = np.asarray([7, 1, 1], np.int32)
    ql = np.asarray([2, 0, 0], np.int32)
    kp = torch.zeros(N + 1, ps, HD)
    vp = torch.zeros(N + 1, ps, HD)
    out = tpa.write_kv_pages(kp, vp, torch.from_numpy(k_new),
                             torch.from_numpy(2 * k_new),
                             torch.from_numpy(pt), torch.from_numpy(sl),
                             torch.from_numpy(ql))
    assert out[0] is kp and out[1] is vp            # updated in place
    np.testing.assert_array_equal(kp[1, 1].numpy(), k_new[0, 0])
    np.testing.assert_array_equal(kp[1, 2].numpy(), k_new[0, 1])
    assert int((kp[:N].abs().sum(-1) > 0).sum()) == 2
    assert not kp[0].any() and not vp[0].any()
    assert kp[N, 0].any() and not kp[N, 1:].any()   # the sink's slot 0
    np.testing.assert_array_equal(vp[1, 1].numpy(), 2 * k_new[0, 0])
    jk, jv = jpa.write_kv_pages(jnp.zeros((N, ps, HD)), jnp.zeros((N, ps, HD)),
                                jnp.asarray(k_new), jnp.asarray(2 * k_new),
                                jnp.asarray(pt), jnp.asarray(sl),
                                jnp.asarray(ql))
    np.testing.assert_array_equal(kp[:N].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp[:N].numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# int8 pages: the quantized branch of the Pallas body
# ---------------------------------------------------------------------------
def _int8_pages(N, ps, H, D, seed=0):
    """int8 K/V pages and fp32 scales [N, ps, H] as the pool holds them:
    rows quantized by the JAX package's own quantize_kv_rows from
    values of spread magnitudes, and page 0 left as a fresh pool leaves
    it (codes 0, scales 0)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        x = rng.randn(1, N * ps, H * D) * np.exp(rng.randn(1, N * ps, 1))
        codes, sc = jpa.quantize_kv_rows(jnp.asarray(x, jnp.float32), H)
        codes = np.array(codes).reshape(N, ps, H * D)
        sc = np.array(sc).reshape(N, ps, H)
        codes[0], sc[0] = 0, 0.0
        out += [codes, sc]
    return out[0], out[2], out[1], out[3]


def _int8_case(head_dim, seed=0):
    """Ragged rows over int8 pages: a decode row crossing into its second
    page, a pure-prefill row, a prefill window that crosses a page
    boundary (positions 6..9, page_size 8), a long multi-page row with
    padding, and the engine's idle slot (seq_len 1, q_len 0, page row of
    zeros); page tables shuffled."""
    rng = np.random.RandomState(seed)
    H, T, ps, P = 2, 4, 8, 4
    B = 4
    N = B * P + 2
    q = rng.randn(B + 1, T, H * head_dim).astype(np.float32)
    kp, vp, ks, vs = _int8_pages(N, ps, H, head_dim, seed)
    pt = (rng.permutation(N - 1)[:B * P] + 1).reshape(B, P)
    pt = np.concatenate([pt, np.zeros((1, P), np.int64)]).astype(np.int32)
    lens = np.asarray([[9, 1], [4, 4], [10, 4], [29, 2], [1, 0]], np.int32)
    return q, kp, vp, ks, vs, pt, lens[:, 0], lens[:, 1], H


@pytest.mark.parametrize('head_dim', [8, 32, 128])
@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_int8_paged_attention_plain_matches_jax_routes(dtype, head_dim):
    _ndt, jdt, tdt, tol = DTYPES[dtype]
    q, kp, vp, ks, vs, pt, sl, ql, H = _int8_case(head_dim, seed=head_dim)
    got = _np(tpa.ragged_paged_attention_plain(
        _t(q, tdt), *(torch.from_numpy(a) for a in (kp, vp, pt, sl, ql)),
        num_heads=H, head_dim=head_dim, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs)))
    jargs = (_j(q, jdt), *(jnp.asarray(a) for a in (kp, vp, pt, sl, ql)))
    kw = dict(num_heads=H, head_dim=head_dim, k_scales=jnp.asarray(ks),
              v_scales=jnp.asarray(vs))
    # the quantized Pallas body, every row and query, padding included
    pallas = _np(jpa.ragged_paged_attention_pallas(*jargs, interpret=True,
                                                   **kw))
    np.testing.assert_allclose(got, pallas, **tol)
    dense = _np(jpa.ragged_paged_attention_dense(*jargs, **kw))
    for b in range(q.shape[0]):
        np.testing.assert_allclose(got[b, :ql[b]], dense[b, :ql[b]], **tol)
    # the idle slot sees key 0 of page 0, never written: zeros
    assert not got[4].any()


def test_int8_paged_attention_no_visible_key_semantics():
    # on int8 pages as on dense ones: a seq_len-0 row writes zeros, a
    # query before every key averages the visited page's dequantized V
    H, D, ps, N, T = 1, 4, 4, 3, 3
    rng = np.random.RandomState(8)
    q = rng.randn(2, T, H * D).astype(np.float32)
    kp, vp, ks, vs = _int8_pages(N, ps, H, D, seed=8)
    pt = np.asarray([[1, 2], [2, 1]], np.int32)
    sl = np.asarray([0, 2], np.int32)
    ql = np.asarray([1, 3], np.int32)
    got = _np(tpa.ragged_paged_attention_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt, sl, ql)),
        num_heads=H, head_dim=D, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs)))
    pallas = _np(jpa.ragged_paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, sl, ql)), num_heads=H,
        head_dim=D, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        interpret=True))
    np.testing.assert_allclose(got, pallas, **FP32)
    assert not got[0].any()
    np.testing.assert_allclose(
        got[1, 0], (vp[2].astype(np.float32) * vs[2]).mean(0), **FP32)


def test_quantize_kv_rows_bit_equal_to_jax():
    # spread magnitudes, an all-zero row (scale 1e-30/127, codes 0),
    # values on the +-127 clip edge and exact half-code ties (x / scale
    # = n + 0.5 rounds half to even on both sides)
    rng = np.random.RandomState(9)
    H, D = 4, 32
    x = (rng.randn(3, 6, H * D) * np.exp(2 * rng.randn(3, 6, 1)))
    x = x.astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, :D] = np.linspace(-127, 127, D) / 127 * 3.0
    x[2, 2, :D] = (np.arange(D) - 16 + 0.5) * 2.0
    x[2, 2, 0] = 127 * 2.0        # amax: scale 2.0, so k + 0.5 are ties
    codes, sc = tpa.quantize_kv_rows(torch.from_numpy(x), H)
    jcodes, jsc = jpa.quantize_kv_rows(jnp.asarray(x), H)
    off = int((codes.numpy().astype(np.int32)
               != np.asarray(jcodes).astype(np.int32)).sum())
    assert off == 0, f'{off} codes differ from the JAX function'
    assert codes.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert codes.abs().max() == 127


def test_write_kv_pages_quantized_matches_jax_scatter():
    # tests/test_serving.py:844 on the port: row 0 writes positions 5, 6
    # (page_table[1] slots 1, 2), row 1 is idle and the JAX scatter drops
    # it; here its writes land in the sink page (index N) and every
    # mapped slot is the JAX scatter's
    ps, H, D, N = 4, 2, 3, 5
    HD = H * D
    k_new = np.arange(2 * 3 * HD, dtype=np.float32).reshape(2, 3, HD) + 1.0
    pt = np.asarray([[3, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    sl = np.asarray([7, 1], np.int32)
    ql = np.asarray([2, 0], np.int32)
    kp = torch.zeros(N + 1, ps, HD, dtype=torch.int8)
    vp = torch.zeros(N + 1, ps, HD, dtype=torch.int8)
    ks = torch.zeros(N + 1, ps, H)
    vs = torch.zeros(N + 1, ps, H)
    meta = [torch.from_numpy(a) for a in (pt, sl, ql)]
    out = tpa.write_kv_pages_quantized(
        kp, vp, ks, vs, torch.from_numpy(k_new), torch.from_numpy(2 * k_new),
        *meta, num_heads=H)
    assert all(a is b for a, b in zip(out, (kp, vp, ks, vs)))   # in place
    want = jpa.write_kv_pages_quantized(
        jnp.zeros((N, ps, HD), jnp.int8), jnp.zeros((N, ps, HD), jnp.int8),
        jnp.zeros((N, ps, H)), jnp.zeros((N, ps, H)), jnp.asarray(k_new),
        jnp.asarray(2 * k_new), *(jnp.asarray(a) for a in (pt, sl, ql)),
        num_heads=H)
    for got, w in zip((kp, vp, ks, vs), want):
        np.testing.assert_array_equal(got[:N].numpy(), np.asarray(w))
    assert int((kp[:N].abs().sum(-1) > 0).sum()) == 2
    assert int((ks[:N] > 0).sum()) == 2 * H
    assert not kp[0].any() and not ks[0].any()
    assert kp[N].any() and ks[N].any()


def test_kv_write_index_sends_padding_to_sink_page():
    # every row of the flattened new K/V gets a slot (no filtering, so
    # no host sync): a valid token its JAX flat slot, padding the first
    # slot of the sink page, the last of the N + 1 pages
    _q, _kp, _vp, pt, sl, ql, _H, _D = _mixed_case_with_idle_row(seed=2)
    T, N, ps = 4, 15, 8
    meta = [torch.from_numpy(a) for a in (pt, sl, ql)]
    dst = tpa.kv_write_index(*meta, T, N + 1, ps)
    ref = np.asarray(jpa._flat_slots(*(jnp.asarray(a) for a in (pt, sl, ql)),
                                     T, N, ps))
    assert dst.shape == (pt.shape[0] * T,)
    pad = ref == N * ps                     # the JAX scatter's dropped rows
    assert pad.any() and not pad.all()
    np.testing.assert_array_equal(dst.numpy(), ref)   # sink = N * ps


# ---------------------------------------------------------------------------
# the kernel's split-and-merge order, grounded on the CPU
# ---------------------------------------------------------------------------
# chip_smoke.py's `paged_attention` bar: |got - want| <= atol + rtol |want|
PAGED_BAR = dict(atol=1e-2, rtol=2e-2)


def _block_keys(seq_len, qpos0, nq, ps, P):
    """The keys a block of queries visits (csrc/paged_attention.cu
    block_keys): the pages whose start is below seq_len, trimmed to the
    block's last position when every query of the block sees key 0."""
    npages = min(-(-seq_len // ps), P) if seq_len > 0 else 0
    nkeys = npages * ps
    return min(nkeys, qpos0 + nq) if qpos0 >= 0 else nkeys


def _split_merge(q, kp, vp, pt, sl, ql, H, D, qb, splits, tiles_per_split,
                 k_scales=None, v_scales=None, tile_keys=tpa.TILE_KEYS):
    """The new kernel's order in fp32 PyTorch: per (row, block of qb
    queries, head), the visited keys cut into `splits` splits of
    tiles_per_split tiles of tile_keys keys; in each split two warps take
    the two halves of each tile, each with its own online softmax (a
    masked key -1e30, a key past the split -inf, the K scale on the
    dot's sum, the V scale on the probability); the warps' states merge,
    a block with one split writes its output, else the splits' (m, l,
    acc) merge in split order with exp(m_s - M) weights; the normaliser
    is max(l, 1e-30)."""
    B, T, HD = q.shape
    N, ps = kp.shape[:2]
    P = pt.shape[1]
    quant = k_scales is not None
    KS = tiles_per_split * tile_keys
    half = tile_keys // 2
    qf = q.float().reshape(B, T, H, D) * np.float32(1.0 / np.sqrt(D))
    out = torch.zeros(B, T, H, D)

    def merged(states):
        mx = torch.stack([st[0] for st in states]).amax(0)
        f = [torch.exp(st[0] - mx) for st in states]
        return (mx, sum(fi * st[1] for fi, st in zip(f, states)),
                sum(fi[:, None] * st[2] for fi, st in zip(f, states)))

    for b in range(B):
        seq, qlen = int(sl[b]), int(ql[b])
        for t0 in range(0, T, qb):
            nq = min(qb, T - t0)
            qpos0 = seq - qlen + t0
            nkeys = _block_keys(seq, qpos0, nq, ps, P)
            ns = -(-nkeys // KS)
            pos = qpos0 + torch.arange(nq)
            for h in range(H):
                parts = []
                for s in range(ns):
                    kbeg, kend = s * KS, min((s + 1) * KS, nkeys)
                    warps = [[torch.full((nq,), -1e30), torch.zeros(nq),
                              torch.zeros(nq, D)] for _ in range(2)]
                    for k0 in range(kbeg, kend, tile_keys):
                        for w, st in enumerate(warps):
                            keys = torch.arange(k0 + w * half,
                                                k0 + (w + 1) * half)
                            inside = keys < kend
                            kk = keys.clamp(max=kend - 1)
                            slot = (pt[b, kk // ps].long().clamp(0, N - 1)
                                    * ps + kk % ps)
                            kr = kp.reshape(N * ps, H, D)[slot, h].float()
                            vr = vp.reshape(N * ps, H, D)[slot, h].float()
                            sc = qf[b, t0:t0 + nq, h] @ kr.T   # [nq, half]
                            vsc = torch.ones(half)
                            if quant:
                                sc = sc * k_scales.reshape(N * ps, H)[
                                    slot, h]
                                vsc = v_scales.reshape(N * ps, H)[slot, h]
                            vis = (keys[None] < seq) & \
                                (keys[None] <= pos[:, None])
                            sc = torch.where(vis, sc, torch.tensor(-1e30))
                            sc = torch.where(inside[None], sc,
                                             torch.tensor(-np.inf))
                            m_new = torch.maximum(st[0], sc.amax(1))
                            p = torch.exp(sc - m_new[:, None])
                            alpha = torch.exp(st[0] - m_new)
                            st[1] = alpha * st[1] + p.sum(1)
                            st[2] = alpha[:, None] * st[2] + \
                                (p * vsc[None]) @ vr
                            st[0] = m_new
                    parts.append(merged(warps))
                if parts:
                    _m, l, acc = merged(parts)
                    out[b, t0:t0 + nq, h] = acc / l.clamp_min(1e-30)[:, None]
    return out.reshape(B, T, HD).to(q.dtype)


def _split_case(seed=0):
    """Rows over a pool of page_size 8: a decode row whose 100 keys cross
    split boundaries, a prefill window crossing them, a query with no
    visible key (q_len > seq_len), a seq_len-0 row, the engine's idle
    slot, and a table with repeated entries and entries out of range
    (clamped to [0, N - 1])."""
    rng = np.random.RandomState(seed)
    H, D, ps, P, T = 2, 8, 8, 16, 5
    N = 40
    lens = np.asarray([[100, 1], [70, 5], [2, 4], [0, 1], [1, 0], [37, 3]],
                      np.int32)
    B = len(lens)
    q = rng.randn(B, T, H * D).astype(np.float32)
    kp = rng.randn(N, ps, H * D).astype(np.float32)
    vp = rng.randn(N, ps, H * D).astype(np.float32)
    pt = np.stack([rng.permutation(N)[:P] for _ in range(B)]).astype(np.int32)
    pt[4] = 0                                # the idle slot's row of zeros
    pt[5, :6] = [3, 3, 7, -2, N + 5, 3]      # repeated and clamped
    return q, kp, vp, pt, lens[:, 0], lens[:, 1], H, D


@pytest.mark.parametrize('pages', ['dense', 'int8'])
@pytest.mark.parametrize('tile_keys,tiles_per_split',
                         [(64, 1), (8, 1), (8, 3), (4, 2)])
@pytest.mark.parametrize('qb', [1, 8])
def test_split_merge_order_matches_the_pallas_body(qb, tile_keys,
                                                   tiles_per_split, pages):
    q, kp, vp, pt, sl, ql, H, D = _split_case()
    N, ps = kp.shape[:2]
    kw = {}
    if pages == 'int8':
        kp, vp, ks, vs = _int8_pages(N, ps, H, D, seed=3)
        kw = dict(k_scales=ks, v_scales=vs)
    splits = -(-pt.shape[1] * ps // (tiles_per_split * tile_keys))
    got = _split_merge(*(torch.from_numpy(a) for a in (q, kp, vp, pt, sl,
                                                       ql)), H, D, qb,
                       splits, tiles_per_split,
                       **{k: torch.from_numpy(v) for k, v in kw.items()},
                       tile_keys=tile_keys).numpy()
    pallas = _np(jpa.ragged_paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, sl, ql)), num_heads=H,
        head_dim=D, interpret=True,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    np.testing.assert_allclose(got, pallas, **PAGED_BAR)
    np.testing.assert_allclose(got, pallas, **FP32)
    assert not got[3].any()                  # seq_len 0 writes zeros
    # the query before every key averages the visited page's V rows
    vrow = vp[pt[2, 0]].astype(np.float32).reshape(ps, H, D)
    if pages == 'int8':
        vrow = vrow * vs[pt[2, 0]][..., None]
    np.testing.assert_allclose(got[2, 0].reshape(H, D), vrow.mean(0), **FP32)


def test_paged_splits_cover_the_table_and_fill_the_card():
    # decode at the serve's shapes: 7 splits of one tile, 896 CTAs
    assert tpa.paged_splits(8, 1, 16, 28, 16, 132) == (1, 7, 1)
    # prefill: 16 blocks of 8 queries a head, 4 splits of 2 tiles
    assert tpa.paged_splits(1, 128, 16, 28, 16, 132) == (8, 4, 2)
    # long contexts: 8 splits of 8 tiles
    assert tpa.paged_splits(8, 1, 16, 256, 16, 132) == (1, 8, 8)
    for B, T, H, P, ps in ((3, 4, 2, 4, 8), (1, 1, 1, 1, 1),
                           (8, 128, 16, 28, 16), (2, 7, 3, 33, 5)):
        qb, splits, per = tpa.paged_splits(B, T, H, P, ps, 132)
        assert qb == (1 if T == 1 else 8)
        assert splits * per * tpa.TILE_KEYS >= P * ps
        assert (splits - 1) * per * tpa.TILE_KEYS < P * ps


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_plain_route_and_count_no_launch():
    _build.reset_launches()
    x = torch.randn(4, 16)
    w, b = torch.randn(16), torch.randn(16)
    assert torch.equal(tfn.layer_norm(x, w, b, 1e-5),
                       tfn.layer_norm_plain(x, w, b, 1e-5))
    assert torch.equal(tfe.bias_gelu(x, b, True),
                       tfe.bias_gelu_plain(x, b, True))
    q, kp, vp, pt, sl, ql, H, D = _mixed_case_with_idle_row()
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(pt), torch.from_numpy(sl), torch.from_numpy(ql))
    assert torch.equal(
        tpa.ragged_paged_attention(*args, num_heads=H, head_dim=D),
        tpa.ragged_paged_attention_plain(*args, num_heads=H, head_dim=D))
    kq, vq, ks, vs = (torch.from_numpy(a) for a in _int8_pages(
        kp.shape[0], kp.shape[1], H, D, seed=1))
    int8_args = (args[0], kq, vq) + args[3:]
    assert torch.equal(
        tpa.ragged_paged_attention(*int8_args, num_heads=H, head_dim=D,
                                   k_scales=ks, v_scales=vs),
        tpa.ragged_paged_attention_plain(*int8_args, num_heads=H,
                                         head_dim=D, k_scales=ks,
                                         v_scales=vs))
    snap = _build.routes_snapshot()
    assert set(snap) == {'layer_norm', 'layer_norm_bwd', 'bias_gelu',
                         'bias_gelu_bwd', 'paged_attention',
                         'paged_attention_int8', 'flash_fwd',
                         'flash_bwd_dq', 'flash_bwd_dkv', 'flash_bhld_fwd',
                         'flash_bhld_bwd_dq', 'flash_bhld_bwd_dkv',
                         'dropout_add', 'dropout_add_bwd', 'grad_stats',
                         'optimizer_step'}
    assert all(n == 0 for n in snap.values())


def test_mixed_devices_raise():
    meta = torch.empty(4, 16, device='meta')
    with pytest.raises(ValueError, match='different devices'):
        tfe.bias_gelu(meta, torch.zeros(16), True)
    with pytest.raises(ValueError, match='no kernel for device'):
        tfn.layer_norm(meta, torch.empty(16, device='meta'),
                       torch.empty(16, device='meta'), 1e-5)


def test_build_digest_covers_every_source():
    srcs = [p.name for p in _build.sources()]
    assert srcs == ['flash_attention.cu', 'fused_elementwise.cu',
                    'fused_norm.cu', 'fused_optimizer.cu',
                    'paged_attention.cu']
    assert '-gencode' in _build.NVCC_FLAGS and \
        'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    assert len(_build._digest()) == 16
