"""The reductions' grids and summation orders, on the CPU.

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

The gradient statistics (`csrc/fused_optimizer.cu`, one launch whose last
CTA sums the CTAs' partials) and the LayerNorm forward's register body
(`csrc/fused_norm.cu`, a row to one warp or to W warps of a CTA) are held
the same way: `fused_optimizer.grad_stats_grid` and
`fused_norm.layer_norm_fwd_plan` cover every element and every row once,
and an emulation of each kernel's order (the header comments of the two
sources state it), fed those partitions, matches the Pallas
`_stats_kernel` (rtol 1e-5, chip_smoke.py's `grad_stats` bar; NaN where
the input has one) and `_fwd_kernel` (y at chip_smoke.py's `layer_norm`
bar, mean and rstd at its `fp32_sum` bar) in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_elementwise as jfe
from paddle_tpu.ops.pallas import fused_norm as jfn
from paddle_tpu.ops.pallas import fused_optimizer as jfo
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_elementwise as tfe
from paddle_tpu_torch.ops.kernels import fused_norm as tfn
from paddle_tpu_torch.ops.kernels import fused_optimizer as tfo
from torch_threads import one_intra_op_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# the gradient statistics: one launch, the last CTA sums the partials
# ---------------------------------------------------------------------------
# chip_smoke.py's TOLERANCES: grad_stats (rtol), layer_norm (atol, rtol),
# fp32_sum (atol as a multiple of the RMS, rtol, relative L2)
STATS_RTOL = 1e-5
LAYER_NORM = dict(atol=2e-2, rtol=1e-2)
FP32_SUM = dict(atol_x_rms=1e-4, rtol=1e-3, rel_l2=1e-4)
STATS_SIZES = (1, 8, 37, 7777, 3 * 2048 + 5, 8192, 100_003, 1 << 20)
WARP = 32


def _vec(dtype):
    return 16 // torch.empty((), dtype=dtype).element_size()


def _stats_thread_elements(n, vec, ctas, aligned):
    """[(element indices of thread g, in the order it adds them)] of the
    statistics kernel: the vectors g + (4 i + k) S, then the scalar tail
    nvec * vec + g + j S."""
    S = ctas * tfo.STATS_THREADS
    nvec = n // vec if aligned else 0
    out = []
    for g in range(S):
        vecs = range(g, nvec, S)          # (4 i + k) S + g in order
        elems = [c * vec + j for c in vecs for j in range(vec)]
        elems += range(nvec * vec + g, n, S)
        out.append(elems)
    return out


@pytest.mark.parametrize('aligned', [True, False], ids=['vec', 'scalar'])
@pytest.mark.parametrize('sms', GRID_SMS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_grad_stats_grid_covers_every_element_once(dtype, sms, aligned):
    for n in STATS_SIZES[:-1] + (300_001,):
        ctas = tfo.grad_stats_grid(n, dtype, sms)
        assert 1 <= ctas <= tfo.STATS_CTAS_PER_SM * sms
        per_thread = _stats_thread_elements(n, _vec(dtype), ctas, aligned)
        got = np.sort(np.concatenate([np.asarray(e, np.int64)
                                      for e in per_thread]))
        assert np.array_equal(got, np.arange(n))
        if aligned:         # no CTA without an element to read
            per_cta = np.add.reduceat(
                [len(e) for e in per_thread],
                np.arange(0, len(per_thread), tfo.STATS_THREADS))
            assert per_cta.min() > 0


def test_grad_stats_grid_fills_the_card_on_a_bucket():
    # gpt_1p3b's fc1 bucket and its word-embedding bucket, bf16: 8 CTAs an
    # SM of 132, each thread with several trips
    for n in (16_777_216, 103_022_592):
        assert tfo.grad_stats_grid(n, torch.bfloat16, 132) == 8 * 132


def _tree(v):
    """The xor-shuffle tree over the last axis (32 lanes): lane 0's sum."""
    lanes = np.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(np.float32)
    return v[..., 0]


def _cta_sums(v):
    """[ctas, 256] thread sums -> [ctas]: warp trees, then the 8 warps in
    order from 0."""
    warps = _tree(v.reshape(v.shape[0], -1, WARP))
    t = np.zeros(v.shape[0], np.float32)
    for w in range(warps.shape[1]):
        t = (t + warps[:, w]).astype(np.float32)
    return t


def _pairwise(q):
    """A vector's values (last axis, 4 or 8), pairwise as
    ptt::pairwise_sum: ((q0+q1)+(q2+q3)) [+ ((q4+q5)+(q6+q7))]."""
    a = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
    if q.shape[-1] == 8:
        a = a + ((q[..., 4] + q[..., 5]) + (q[..., 6] + q[..., 7]))
    return a


def _stats_emulated(x, vec, ctas, aligned):
    """(Σx², nonfinite count) of fp32 `x` in the kernel's order."""
    n = x.size
    T = tfo.STATS_THREADS
    S = ctas * T
    nvec = n // vec if aligned else 0
    g = np.arange(S)
    s = np.zeros(S, np.float32)
    q = (x[:nvec * vec] * x[:nvec * vec]).reshape(nvec, vec)
    vsum = _pairwise(q).astype(np.float32)
    for base in range(0, nvec, tfo.STATS_UNROLL * S):
        for k in range(tfo.STATS_UNROLL):
            c = base + k * S + g
            live = c < nvec
            s[live] = s[live] + vsum[c[live]]
    for start in range(nvec * vec, n, S):
        i = start + g
        live = i < n
        s[live] = s[live] + x[i[live]] * x[i[live]]
    part = _cta_sums(s.reshape(ctas, T))
    t = np.zeros(T, np.float32)
    for p0 in range(0, ctas, T):
        p = p0 + np.arange(T)
        live = p < ctas
        t[live] = t[live] + part[p[live]]
    total = _cta_sums(t.reshape(1, T))[0]
    return total, int((~np.isfinite(x)).sum())


def _stats_input(n, dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.exp(rng.randn(n))).astype(np.float32)
    # the value each side sees: bf16 rounds once, both read it as fp32
    return torch.from_numpy(x).to(dtype).float().numpy()


@pytest.mark.parametrize('aligned', [True, False], ids=['vec', 'scalar'])
@pytest.mark.parametrize('sms', [1, 8, 132])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', [37, 7777, 3 * 2048 + 5, 100_003, 1 << 18])
def test_grad_stats_order_matches_pallas_body(n, dtype, sms, aligned):
    x = _stats_input(n, dtype, seed=n % 89)
    ctas = tfo.grad_stats_grid(n, dtype, sms)
    s, c = _stats_emulated(x, _vec(dtype), ctas, aligned)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ps, pc = jfo.grad_stats_pallas(jnp.asarray(x).astype(jdt))
    np.testing.assert_allclose(s, float(ps), rtol=STATS_RTOL, atol=0)
    assert c == float(pc) == 0


@pytest.mark.parametrize('sms', [1, 132])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_grad_stats_order_is_poisoned_by_nan_and_inf(dtype, sms):
    n = 100_003
    x = _stats_input(n, dtype, seed=5)
    x[n // 3] = np.nan
    x[n - 1] = np.inf
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ps, pc = jfo.grad_stats_pallas(jnp.asarray(x).astype(jdt))
    for aligned in (True, False):
        s, c = _stats_emulated(x, _vec(dtype), tfo.grad_stats_grid(
            n, dtype, sms), aligned)
        assert np.isnan(s) and np.isnan(float(ps))
        assert c == float(pc) == 2


# ---------------------------------------------------------------------------
# the LayerNorm forward: a row to one warp, or to W warps of a CTA
# ---------------------------------------------------------------------------
FWD_WIDTHS = (1, 37, 64, 256, 768, 2048, 2056, 4096, 8192, 8200, 12288,
              16384, 16392, 40000)


@pytest.mark.parametrize('sms', GRID_SMS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', FWD_WIDTHS)
def test_layer_norm_fwd_plan_covers_every_row_and_column_once(n, dtype,
                                                              sms):
    vec = _vec(dtype)
    vectors = -(-n // vec)
    for rows in GRID_ROWS:
        w, k, per, ctas = tfn.layer_norm_fwd_plan(rows, n, dtype, sms)
        if w == 0:                       # the shared-memory body
            assert n > 16384 and (per, ctas) == (1, rows)
            continue
        assert w in tfn.FWD_WARPS and per == tfn.FWD_THREADS // 32 // w
        assert k * vec <= tfn.FWD_LANE_VALUES
        # one or two vectors a lane over the fewest warps that hold the
        # row, or 8 warps of more; two only when the rows fill the card
        assert (k <= 2 and (w == 1 or 32 * (w // 2) * k < vectors)) or \
            w == 8
        blocks = -(-rows // per)
        if k == 2 and w < 8:
            assert blocks >= tfn.FWD_CTAS_PER_SM[2] * sms
        # resident CTAs, or one a block of rows
        assert ctas == min(blocks, tfn.FWD_CTAS_PER_SM[k] * sms)
        # every row once: CTA c takes blocks c, c + ctas, ..., group g
        # row g of a block
        got = sorted(blk * per + g for c in range(ctas)
                     for blk in range(c, blocks, ctas) for g in range(per)
                     if blk * per + g < rows)
        assert got == list(range(rows))
        # lane l takes columns (l + 32 w k') * vec + j, k' < k
        cols = ((np.arange(32 * w)[:, None, None]
                 + 32 * w * np.arange(k)[None, :, None]) * vec
                + np.arange(vec)[None, None, :]).ravel()
        cols = np.sort(cols[cols < n])
        assert np.array_equal(cols, np.arange(n))
        # the fewest vectors a lane that cover the row
        assert k == 1 or 32 * w * (k // 2) < vectors


def test_layer_norm_fwd_plan_at_gpt_1p3b_shapes():
    # bf16 n = 2048: the train step's rows over 4 warps of two vectors a
    # lane, walked by 4 CTAs an SM; the decode step's 8 rows over 8 warps
    # of one vector a lane, one row a CTA
    assert tfn.layer_norm_fwd_plan(16384, 2048, torch.bfloat16, 132) == \
        (4, 2, 2, 4 * 132)
    assert tfn.layer_norm_fwd_plan(8, 2048, torch.bfloat16, 132) == \
        (8, 1, 1, 8)


def _ln_fwd_emulated(x, w, b, eps, dtype, sms):
    """The forward's register body in its order: x, w, b fp32 tensors
    holding `dtype` values; (y in dtype, mean, rstd). The CTAs' walk
    over the rows does not change a row's order."""
    rows, n = x.shape
    W, K, _per, _ctas = tfn.layer_norm_fwd_plan(rows, n, dtype, sms)
    assert W > 0
    vec = _vec(dtype)
    lanes = 32 * W
    idx = ((torch.arange(lanes)[:, None, None]
            + lanes * torch.arange(K)[None, :, None]) * vec
           + torch.arange(vec)[None, None, :]).reshape(lanes, K * vec)
    valid = idx < n
    xl = torch.where(valid, x[:, idx.clamp(max=n - 1)], torch.zeros(()))

    def total(v):                        # [rows, lanes] -> [rows]
        t = torch.from_numpy(_tree(v.reshape(rows, W, WARP).numpy()))
        out = torch.zeros(rows)
        for i in range(W):
            out = out + t[:, i]
        return out

    def lane_sums(v):                    # [rows, lanes, K vec] by vector
        vs = torch.from_numpy(_pairwise(
            v.reshape(rows, lanes, K, vec).numpy()))
        s = torch.zeros(rows, lanes)
        for k in range(K):
            s = s + vs[:, :, k]
        return s

    mean = total(lane_sums(xl)) / n
    d = torch.where(valid, xl - mean[:, None, None], torch.zeros(()))
    ss = lane_sums(d * d)
    rstd = 1.0 / torch.sqrt(total(ss) / n + eps)
    xn = ((x - mean[:, None]) * rstd[:, None]).to(dtype).float()
    y = ((xn * w).to(dtype).float() + b).to(dtype)
    return y, mean, rstd


def _assert_fp32_sum(got, want):
    err = (got - want).abs()
    norm = float(want.norm())
    assert float(err.norm()) / norm <= FP32_SUM['rel_l2']
    atol = FP32_SUM['atol_x_rms'] * norm / want.numel() ** 0.5
    assert bool((err <= atol + FP32_SUM['rtol'] * want.abs()).all())


@pytest.mark.parametrize('sms', [1, 132], ids=['many-rows', 'few-rows'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', [64, 768, 2048, 4096])
def test_layer_norm_fwd_order_matches_pallas_body(n, dtype, sms):
    rng = np.random.RandomState(23 + n)
    rows = 40
    x, w, b = (torch.from_numpy(a.astype(np.float32)).to(dtype).float()
               for a in (rng.randn(rows, n) * 2 + 0.5,
                         1 + 0.1 * rng.randn(n), 0.1 * rng.randn(n)))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jy, jmean, jrstd = jfn._fwd_pallas(
        *(jnp.asarray(t.numpy()).astype(jdt) for t in (x, w, b)), 1e-5)
    W, K = tfn.layer_norm_fwd_plan(rows, n, dtype, sms)[:2]
    # 40 rows fill one SM: two vectors a lane over the fewest warps; over
    # 132 SMs they do not: one vector a lane over more warps (fp32 rows of
    # 2048 and both dtypes' 4096 need more than 8 warps of one)
    fp32 = dtype == torch.float32
    want = {(64, 1): (1, 1), (64, 132): (1, 1),
            (768, 1): (4, 2) if fp32 else (2, 2),
            (768, 132): (8, 1) if fp32 else (4, 1),
            (2048, 1): (8, 2) if fp32 else (4, 2),
            (2048, 132): (8, 2) if fp32 else (8, 1),
            (4096, 1): (8, 4) if fp32 else (8, 2),
            (4096, 132): (8, 4) if fp32 else (8, 2)}[n, sms]
    assert (W, K) == want
    y, mean, rstd = _ln_fwd_emulated(x, w, b, 1e-5, dtype, sms)
    want = torch.from_numpy(np.array(jy.astype(jnp.float32)))
    torch.testing.assert_close(y.float(), want, **LAYER_NORM)
    _assert_fp32_sum(mean, torch.from_numpy(np.array(jmean)[:rows, 0]))
    _assert_fp32_sum(rstd, torch.from_numpy(np.array(jrstd)[:rows, 0]))
