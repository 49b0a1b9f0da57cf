"""The backward reductions' grid and summation order, on the CPU.

The LayerNorm backward (`csrc/fused_norm.cu`) and the bias+GELU backward
(`csrc/fused_elementwise.cu`) cut the rows into chunks that the wrappers'
pure grid functions choose (`fused_norm.layer_norm_bwd_grid`,
`fused_elementwise.bias_gelu_bwd_grid`); each CTA writes its chunk's fp32
column partials, and `ptt::launch_column_sum` adds the partials in a
fixed order. The kernels run only on the card; here:

- the grid functions, over a sweep of rows, widths, dtypes and SM counts,
  cover every row exactly once with chunks the C entries accept, size the
  scratch as the C entries read it, and keep it under `_build.SCRATCH_CAP`;
- a plain-PyTorch emulation of the kernels' order (per-thread fp32 sums
  over a chunk's rows in row order, the bias+GELU CTA's 8 warps added in
  warp order, then the column sum's 8 strided groups added in group
  order), fed the grid functions' partition, matches the Pallas bodies on
  the same numpy inputs, run as the JAX package's tests run them on the
  CPU (interpret mode). Bars: dx at the fp32 bar, rtol 2e-4 / atol 2e-5
  (the row sums in another order); dw, db and dbias at rtol 1e-3 / atol
  1e-4, the on-card tests' FP32_SUMS (hundreds of rows summed in another
  order than the Pallas body's sequential row blocks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_elementwise as jfe
from paddle_tpu.ops.pallas import fused_norm as jfn
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_elementwise as tfe
from paddle_tpu_torch.ops.kernels import fused_norm as tfn

FP32 = dict(rtol=2e-4, atol=2e-5)
FP32_SUMS = dict(rtol=1e-3, atol=1e-4)
# csrc/common.cuh column_sum_kernel: partial p goes to group p % 8
SUM_GROUPS = 8
# csrc/fused_elementwise.cu: a bias+GELU CTA's warps walk rows 8 apart
GELU_WARPS = 8
GRID_ROWS = (1, 7, 100, 300, 2049, 16384, 16411)
GRID_WIDTHS = (1, 37, 64, 2048, 2056, 8192, 8200, 29056, 40000)
GRID_SMS = (1, 8, 132)


def _chunk_rows(chunks, per, rows):
    return [range(i * per, min(rows, (i + 1) * per)) for i in range(chunks)]


def _assert_partition(chunks, per, rows):
    # the C entries' check: chunks * per covers rows, no chunk is empty
    assert chunks >= 1 and per >= 1
    assert chunks * per >= rows > (chunks - 1) * per
    covered = [r for rng in _chunk_rows(chunks, per, rows) for r in rng]
    assert covered == list(range(rows))


@pytest.mark.parametrize('sms', GRID_SMS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', GRID_WIDTHS)
def test_layer_norm_bwd_grid_covers_every_row_once(n, dtype, sms):
    for rows in GRID_ROWS:
        chunks, per = tfn.layer_norm_bwd_grid(rows, n, dtype, sms)
        _assert_partition(chunks, per, rows)
        # part [chunks, 2n] fp32, under the cap unless one row is larger
        scratch = chunks * 2 * n * 4
        assert scratch <= max(_build.SCRATCH_CAP, 2 * n * 4)
        assert chunks <= min(rows, max(tfn.BWD_CTAS_PER_SM.values()) * sms)


@pytest.mark.parametrize('sms', GRID_SMS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', GRID_WIDTHS)
def test_bias_gelu_bwd_grid_covers_every_row_once(n, dtype, sms):
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    tile = tfe.BWD_TILE_VECS * vec
    for rows in GRID_ROWS:
        tiles, chunks, per = tfe.bias_gelu_bwd_grid(rows, n, dtype, sms)
        _assert_partition(chunks, per, rows)
        assert (tiles - 1) * tile < n <= tiles * tile
        assert chunks <= 65535                      # gridDim.y
        assert chunks * n * 4 <= max(_build.SCRATCH_CAP, n * 4)
        # about one resident wave of CTAs, or one a row when rows are few
        assert tiles * chunks <= max(tiles, 4 * sms) or chunks == 1


def test_layer_norm_bwd_grid_refuses_rows_beyond_the_kernel():
    tfn.layer_norm_bwd_grid(4, tfn.BWD_MAX_N - 1, torch.bfloat16, 132)
    with pytest.raises(ValueError, match='exceed'):
        tfn.layer_norm_bwd_grid(4, tfn.BWD_MAX_N, torch.bfloat16, 132)


def test_scratch_cap_bounds_the_chunks():
    # 16384 rows at n = 40000 (a streamed row, one CTA an SM): 132 chunks
    # would take 42 MB of partials
    chunks, per = tfn.layer_norm_bwd_grid(16384, 40000, torch.float32, 132)
    _assert_partition(chunks, per, 16384)
    assert chunks <= _build.SCRATCH_CAP // (2 * 40000 * 4) < 132


def _column_sum(part):
    """column_sum_kernel's order: group g sums partials g, g+8, ... in
    order; the 8 group sums are added in group order."""
    total = torch.zeros(part.shape[1], dtype=torch.float32)
    for g in range(SUM_GROUPS):
        s = torch.zeros(part.shape[1], dtype=torch.float32)
        for p in range(g, part.shape[0], SUM_GROUPS):
            s = s + part[p]
        total = total + s
    return total


def _ln_bwd_emulated(x, w, dy, mean, rstd, chunks, per):
    """The LayerNorm backward in the kernel's order, fp32 inputs: dx per
    row from the row's two sums; dw, db summed over each chunk's rows in
    row order (a thread owns its columns), then the column sum."""
    rows, n = x.shape
    xhat = (x - mean[:, None]) * rstd[:, None]
    dxhat = dy * w
    m1 = dxhat.sum(-1, keepdim=True) / n
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / n
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    part = torch.zeros(chunks, 2 * n, dtype=torch.float32)
    for i, rng in enumerate(_chunk_rows(chunks, per, rows)):
        for r in rng:
            part[i, :n] = part[i, :n] + dy[r] * xhat[r]
            part[i, n:] = part[i, n:] + dy[r]
    sums = _column_sum(part)
    return dx, sums[:n], sums[n:]


def _bg_bwd_emulated(x, b, dy, approximate, chunks, per):
    """The bias+GELU backward in the kernel's order, fp32 inputs: a warp
    sums the chunk's rows r0 + w, r0 + w + 8, ... in order, the CTA adds
    its 8 warps in order, then the column sum."""
    rows, n = x.shape
    du = dy * tfe.gelu_grad_f32(x + b, approximate)
    part = torch.zeros(chunks, n, dtype=torch.float32)
    for i, rng in enumerate(_chunk_rows(chunks, per, rows)):
        warps = [torch.zeros(n, dtype=torch.float32)
                 for _ in range(GELU_WARPS)]
        for k, r in enumerate(rng):
            warps[k % GELU_WARPS] = warps[k % GELU_WARPS] + du[r]
        for s in warps:
            part[i] = part[i] + s
    return du, _column_sum(part)


@pytest.mark.parametrize('sms', [8, 132])
@pytest.mark.parametrize('n', [2048, 8192])
def test_layer_norm_bwd_order_matches_pallas_body(n, sms):
    rng = np.random.RandomState(21)
    rows = 300
    x = (rng.randn(rows, n) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(n)).astype(np.float32)
    b = (0.1 * rng.randn(n)).astype(np.float32)
    dy = rng.randn(rows, n).astype(np.float32)
    jx, jw, jdy = (jnp.asarray(a) for a in (x, w, dy))
    _o, jmean, jrstd = jfn._fwd_pallas(jx, jw, jnp.asarray(b), 1e-5)
    want = jfn._bwd_pallas(jx, jw, jdy, jmean, jrstd)
    chunks, per = tfn.layer_norm_bwd_grid(rows, n, torch.float32, sms)
    assert chunks > 1
    mean = torch.from_numpy(np.array(jmean)[:rows, 0])
    rstd = torch.from_numpy(np.array(jrstd)[:rows, 0])
    got = _ln_bwd_emulated(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(dy), mean, rstd, chunks, per)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FP32)
    for g, e in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **FP32_SUMS)


@pytest.mark.parametrize('approximate', [True, False], ids=['tanh', 'erf'])
@pytest.mark.parametrize('sms', [32, 132])
@pytest.mark.parametrize('n', [2048, 8192])
def test_bias_gelu_bwd_order_matches_pallas_body(n, sms, approximate):
    rng = np.random.RandomState(22)
    rows = 300
    x = (2 * rng.randn(rows, n)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    dy = rng.randn(rows, n).astype(np.float32)
    jdx, jdb = jfe._bg_bwd(approximate, (jnp.asarray(x), jnp.asarray(b)),
                           jnp.asarray(dy))
    _tiles, chunks, per = tfe.bias_gelu_bwd_grid(rows, n, torch.float32, sms)
    assert chunks > 1
    dx, db = _bg_bwd_emulated(torch.from_numpy(x), torch.from_numpy(b),
                              torch.from_numpy(dy), approximate, chunks, per)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **FP32)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **FP32_SUMS)
