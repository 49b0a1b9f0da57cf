"""paddle_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernels are built
from paddle_tpu_torch/csrc at first use) and skips elsewhere. The file
imports neither jax nor paddle_tpu, so it also runs on a GPU machine
without JAX, where tests/conftest.py (which imports jax) cannot load:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: fp32 at rtol 2e-4 / atol 2e-5 (summation order); bf16
LayerNorm and bias+GELU at rtol 1e-2 / atol 2e-2 (one bf16 rounding may
flip, 2^-8 relative, on outputs up to ~4); bf16 attention at rtol 2e-2
/ atol 1e-2 (fp32 online softmax in another key order, one bf16
rounding). fp32 flash attention and the fp32 backward reductions at
rtol 1e-3 / atol 1e-4: the kernels sum up to 256 keys, 128 dims or
hundreds of rows in another order than the plain versions, with fp32
intermediates of magnitude ~10, so they differ by a few 1e-6 relative
(the bar leaves a margin of ten or more). The fused update: fp32 at
rtol 2e-6 / atol 5e-7 (the reference test's bar: the same op order,
each op rounded), bf16 outputs 99.9 % bit-equal and the rest within one
bf16 ulp; the gradient sum of squares at rtol 1e-5 (summation order),
its nonfinite count exact; dropout+residual bit-equal. The update's
Adagrad, RMSProp, Adamax, Adadelta and DecayedAdagrad rules bit-equal to
the plain chain (each op rounded in the same order on both sides); the
per-parameter route (`ParamUpdates`, every fusible rule, a loss-scale
prefactor rounded back to the gradient's dtype) bit-equal to the plain
chain over 3 steps, and the pipeline engine's loss-scaled fp32 steps
bit-equal to its unscaled ones. The
BHLD flash kernels (key bias, keep mask) at the flash bars above. The
bf16 flash gradients (the tensor-core backward, which rounds P keep and
dS to bf16 before the products that consume them) at FLASH_BF16_TC:
atol 2^-3 of the plain gradient's RMS, rtol 2^-7, relative L2 error
under 1e-2 (chip_smoke.py's flash_bf16_tc). The
bucketed step on the card vs the CPU: fp32, one clipped SGD step, rtol
1e-4; with attention dropout, two steps at rtol 1e-4. The int8 paged
attention: fp32 q at rtol 1e-3 / atol 1e-4 (the K scale applied to the
dot's sum and the V scale to the probability, where the plain version
scales each element, over up to 29 keys of magnitude up to 127 x
scale); bf16 q at the flash bar, atol 2^-6 of the plain output's RMS,
rtol 2^-7, relative L2 error under 1e-2 (one bf16 rounding of the
output). The serving engine on the card: fused and serial windows
token-identical, greedy and sampled (the same shapes run in both).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import gpt as tgpt_serve
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import fused_optimizer as tfo
from paddle_tpu_torch.ops.kernels import fused_elementwise as tfe
from paddle_tpu_torch.ops.kernels import fused_norm as tfn
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

FP32 = dict(rtol=2e-4, atol=2e-5)
FP32_SUMS = dict(rtol=1e-3, atol=1e-4)
BF16_ELEMENTWISE = dict(rtol=1e-2, atol=2e-2)
BF16_ATTENTION = dict(rtol=2e-2, atol=1e-2)
# chip_smoke.py's flash_bf16_tc: the bf16 flash backward on the tensor
# cores rounds P keep and dS to bf16 before the products that consume
# them; atol is a multiple of the plain gradient's RMS (see
# assert_flash_bf16_tc), grounded on the CPU in tests/test_torch_flash.py
FLASH_BF16_TC = dict(atol_x_rms=2.0 ** -3, rtol=2.0 ** -7, rel_l2=1e-2)
# chip_smoke.py's flash_bf16: the bf16 forward on the tensor cores (P keep
# as two bf16 terms) against the plain fp32 version, one bf16 rounding of o
FLASH_BF16 = dict(atol_x_rms=2.0 ** -6, rtol=2.0 ** -7, rel_l2=1e-2)


def assert_flash_bf16_tc(got, want, bar=FLASH_BF16_TC):
    """|got - want| <= atol_x_rms * RMS(want) + rtol * |want| per element,
    and the relative L2 error under rel_l2."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    norm = float(w.norm())
    rel = float(err.norm()) / norm if norm else float(err.norm())
    assert rel <= bar['rel_l2'], f'relative L2 error {rel:.3g}'
    atol = bar['atol_x_rms'] * norm / w.numel() ** 0.5
    bad = err > atol + bar['rtol'] * w.abs()
    assert not bool(bad.any()), (f'{int(bad.sum())} elements outside; '
                                 f'max |diff| {float(err.max()):.3g}')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    return torch.device('cuda')


# the backward reductions' shapes: (shape, element offset of x and dy from
# a 16-byte aligned start). A row, fewer rows than the CTAs of one column
# tile, a row count no chunk divides, n a multiple of 8 but not of the
# column tile, n = 37, inputs one element off 16-byte alignment, the
# gpt_1p3b train step's shapes (the 16384 rows also in fp32); LayerNorm
# rows held in registers 1, 2 and 4 vectors a thread and wider rows that
# stream (12288; 40000, past the parent's 29,051).
BWD_LN_CASES = [((3, 5, 64), 0), ((300, 2048), 0), ((2, 37), 0),
                ((1, 2048), 0), ((100, 2048), 0), ((16411, 2048), 0),
                ((300, 2056), 0), ((300, 37), 0), ((300, 2048), 1),
                ((16384, 2048), 0), ((64, 4096), 0), ((64, 8192), 0),
                ((64, 12288), 0), ((8, 40000), 0), ((64, 8200), 1)]
BWD_GELU_CASES = [((3, 5, 64), 0), ((300, 8192), 0), ((2, 37), 0),
                  ((1, 8192), 0), ((10, 8192), 0), ((16411, 8192), 0),
                  ((300, 8200), 0), ((300, 2056), 0), ((300, 37), 0),
                  ((300, 8192), 1), ((16384, 8192), 0), ((8, 40000), 0)]


def _offset_randn(shape, offset, gen, device, dtype):
    """randn of `shape`, contiguous, starting `offset` elements into an
    allocation (so offset 1 is off 16-byte alignment)."""
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=gen, device=device).to(dtype)
    return flat[offset:].view(shape)


def _paged_case(head_dim, seed=3):
    """A decode row, a pure-prefill row, a long multi-page row with
    padding (shuffled page tables) and the engine's idle slot (seq_len 1,
    q_len 0, page row of zeros) — tests/test_torch_kernels.py's case."""
    rng = np.random.RandomState(seed)
    B, T, H, ps, P = 3, 4, 2, 8, 4
    HD = H * head_dim
    num_pages = B * P + 3
    q = rng.randn(B + 1, T, HD)
    k_pages = rng.randn(num_pages, ps, HD)
    v_pages = rng.randn(num_pages, ps, HD)
    page_tables = rng.permutation(num_pages)[:B * P].reshape(B, P)
    page_tables = np.concatenate([page_tables, np.zeros((1, P), np.int64)])
    lens = np.asarray([[13, 1], [4, 4], [29, 2], [1, 0]])
    return q, k_pages, v_pages, page_tables, lens[:, 0], lens[:, 1], H


def _split_case(T, seed=8):
    """Rows over a pool of page_size 16, 40 pages a row, gpt_1p3b's heads:
    contexts that cross 64-key tiles and split boundaries (600, 257, 129
    keys), a row with fewer keys than new tokens when T > 1 (its first
    queries see no key), a seq_len-0 slot, the engine's idle slot, and a
    table with repeated and out-of-range entries (clamped)."""
    rng = np.random.RandomState(seed)
    H, D, ps, P, N = 16, 128, 16, 40, 300
    lens = np.asarray([[600, 1], [129, 3], [2, 4], [0, 1], [1, 0],
                       [257, 5]])
    lens[:, 1] = np.minimum(lens[:, 1], T)
    B = len(lens)
    q = rng.randn(B, T, H * D)
    k_pages = rng.randn(N, ps, H * D)
    v_pages = rng.randn(N, ps, H * D)
    pt = rng.randint(0, N, (B, P))
    pt[4] = 0
    pt[5, :6] = [3, 3, 7, -2, N + 5, 3]
    return q, k_pages, v_pages, pt, lens[:, 0], lens[:, 1], H, D


def _int8_pool(N, ps, H, D, seed=0):
    """int8 K/V pages with fp32 scales [N, ps, H]: codes over the whole
    range -127..127, and page 0's slots left as a fresh pool holds them
    (code 0, scale 0)."""
    g = torch.Generator().manual_seed(seed)
    kp, vp = (torch.randint(-127, 128, (N, ps, H * D), generator=g,
                            dtype=torch.int64).to(torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand(N, ps, H, generator=g) * 0.05 for _ in range(2))
    for t in (kp, vp, ks, vs):
        t[0] = 0
    return kp, vp, ks, vs


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('shape', [(3, 5, 64), (7, 2048), (2, 37)])
    def test_layer_norm_kernel(self, cuda, dtype, shape):
        g = torch.Generator(device=cuda).manual_seed(0)
        x = torch.randn(shape, generator=g, device=cuda).to(dtype)
        w = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
        b = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
        _build.reset_launches()
        got = tfn.layer_norm(x, w, b, 1e-5)
        assert _build.routes_snapshot()['layer_norm'] == 1
        tol = FP32 if dtype == torch.float32 else BF16_ELEMENTWISE
        torch.testing.assert_close(
            got.float(), tfn.layer_norm_plain(x, w, b, 1e-5).float(), **tol)

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('rows,n,offset', [
        (300, 64, 0), (300, 768, 0), (16411, 2048, 0), (8, 2048, 0),
        (2000, 768, 1), (2000, 37, 0), (16411, 768, 1), (300, 512, 0),
        (20000, 256, 0), (16411, 512, 1),
        (300, 2048, 1), (300, 2056, 0), (300, 4096, 0), (64, 8192, 0),
        (64, 8192, 1), (64, 12288, 0), (9, 16384, 0), (8, 20000, 0),
        (8, 20000, 1)])
    def test_layer_norm_fwd_paths(self, cuda, dtype, rows, n, offset):
        """The forward's register body at 1, 2, 4 and 8 warps a row with
        one vector a lane (few rows) or two (rows that fill the card: n =
        512, 768, 2048 at 16411 rows), 8 warps of up to 16 vectors a lane
        (n up to 16384), CTAs that walk several blocks of rows (a partial
        last block) or one each, and the shared-memory body (wider),
        aligned and one element off 16-byte alignment, with and without
        mean and rstd, against the plain version."""
        g = torch.Generator(device=cuda).manual_seed(6)
        flat = torch.randn(rows * n + offset, generator=g, device=cuda)
        x = (2 * flat + 0.5).to(dtype)[offset:].view(rows, n)
        w = 1 + 0.1 * torch.randn(n, generator=g, device=cuda).to(dtype)
        b = 0.1 * torch.randn(n, generator=g, device=cuda).to(dtype)
        _build.reset_launches()
        y, mean, rstd = tfn._fwd_kernel(x, w, b, 1e-5, True)
        y2 = tfn._fwd_kernel(x, w, b, 1e-5, False)[0]
        assert _build.routes_snapshot()['layer_norm'] == 2
        y_p, mean_p, rstd_p = tfn.layer_norm_fwd_plain(x, w, b, 1e-5)
        tol = FP32 if dtype == torch.float32 else BF16_ELEMENTWISE
        torch.testing.assert_close(y.float(), y_p.float(), **tol)
        assert torch.equal(y, y2)
        for a, e in ((mean, mean_p), (rstd, rstd_p)):
            torch.testing.assert_close(a, e, **FP32)

    @pytest.mark.parametrize('approximate', [True, False])
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('shape,offset', [
        ((3, 5, 64), 0), ((8, 8192), 0), ((2, 37), 0), ((1024, 8192), 0),
        ((16411, 8192), 0), ((300, 2051), 0), ((64, 8192), 1)])
    def test_bias_gelu_kernel(self, cuda, dtype, shape, offset, approximate):
        """The forward at the serve's decode and prefill rows, rows that
        walk a chunk (16411: a ragged last trip and chunk), n not a
        multiple of 8, and x one element off 16-byte alignment (the
        element-by-element route), against the plain version; one launch
        a call, two calls bit-equal."""
        g = torch.Generator(device=cuda).manual_seed(1)
        x = _offset_randn(shape, offset, g, cuda, dtype)
        x.mul_(3)
        b = torch.randn(shape[-1], generator=g, device=cuda)
        _build.reset_launches()
        got = tfe.bias_gelu(x, b, approximate)
        assert _build.routes_snapshot()['bias_gelu'] == 1
        assert torch.equal(got, tfe.bias_gelu(x, b, approximate))
        assert _build.routes_snapshot()['bias_gelu'] == 2
        tol = FP32 if dtype == torch.float32 else BF16_ELEMENTWISE
        torch.testing.assert_close(
            got.float(), tfe.bias_gelu_plain(x, b, approximate).float(),
            **tol)

    def test_bias_gelu_records_a_gradient_only_when_one_is_needed(self, cuda):
        """The wrapper skips the autograd Function when no gradient is
        recorded, and still records one through the kernels when x or the
        bias requires it."""
        g = torch.Generator(device=cuda).manual_seed(7)
        x = torch.randn(8, 8192, generator=g, device=cuda).bfloat16()
        b = torch.randn(8192, generator=g, device=cuda).bfloat16()
        _build.reset_launches()
        assert tfe.bias_gelu(x, b, True).grad_fn is None
        b.requires_grad_()
        with torch.no_grad():
            assert tfe.bias_gelu(x, b, True).grad_fn is None
        y = tfe.bias_gelu(x, b, True)
        assert y.grad_fn is not None
        y.float().sum().backward()
        snap = _build.routes_snapshot()
        assert snap['bias_gelu'] == 3 and snap['bias_gelu_bwd'] == 2
        _dx, db = tfe.bias_gelu_bwd_plain(x, b.detach(), torch.ones_like(x),
                                          True)
        torch.testing.assert_close(b.grad.float(), db.bfloat16().float(),
                                   **BF16_ELEMENTWISE)

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('head_dim', [8, 32, 64, 128, 256])
    def test_paged_attention_kernel(self, cuda, dtype, head_dim):
        q, kp, vp, pt, sl, ql, H = _paged_case(head_dim)
        args = [torch.from_numpy(a).to(cuda, dtype) for a in (q, kp, vp)]
        args += [torch.from_numpy(a).to(cuda) for a in (pt, sl, ql)]
        _build.reset_launches()
        got = tpa.ragged_paged_attention(*args, num_heads=H,
                                         head_dim=head_dim)
        assert _build.routes_snapshot()['paged_attention'] == 1
        want = tpa.ragged_paged_attention_plain(*args, num_heads=H,
                                                head_dim=head_dim)
        tol = FP32 if dtype == torch.float32 else BF16_ATTENTION
        torch.testing.assert_close(got.float(), want.float(), **tol)

    def test_paged_attention_no_visible_key_matches_plain(self, cuda):
        # seq_len 0 writes zeros; a query before every key averages the
        # visited page's V rows, as the Pallas body does
        rng = np.random.RandomState(5)
        H, D, ps, N, T = 1, 32, 4, 3, 3
        q = torch.from_numpy(rng.randn(2, T, H * D)).float().to(cuda)
        kp = torch.from_numpy(rng.randn(N, ps, H * D)).float().to(cuda)
        vp = torch.from_numpy(rng.randn(N, ps, H * D)).float().to(cuda)
        meta = [torch.tensor(a, device=cuda)
                for a in ([[1, 2], [2, 1]], [0, 2], [1, 3])]
        got = tpa.ragged_paged_attention(q, kp, vp, *meta, num_heads=H,
                                         head_dim=D)
        want = tpa.ragged_paged_attention_plain(q, kp, vp, *meta,
                                                num_heads=H, head_dim=D)
        torch.testing.assert_close(got, want, **FP32)
        assert not got[0].any()

    def test_write_kv_pages_on_card_spares_page_0(self, cuda):
        ps, H, D, N = 4, 2, 32, 5
        HD = H * D
        # the pages end in the sink page (index N), where padding lands
        kp = torch.zeros(N + 1, ps, HD, device=cuda)
        vp = torch.zeros(N + 1, ps, HD, device=cuda)
        new = torch.randn(2, 3, HD, device=cuda)
        pt = torch.tensor([[3, 1, 0, 0], [0, 0, 0, 0]])
        sl = torch.tensor([7, 1])
        ql = torch.tensor([2, 0])
        tpa.write_kv_pages(kp, vp, new, new, pt, sl, ql)
        assert not kp[0].any()
        assert int((kp[:N].abs().sum(-1) > 0).sum()) == 2
        assert kp[N, 0].any() and not kp[N, 1:].any()
        torch.testing.assert_close(kp[1, 1], new[0, 0])
        torch.testing.assert_close(kp[1, 2], new[0, 1])

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('head_dim', [8, 32, 64, 128, 256])
    def test_paged_attention_int8_kernel(self, cuda, dtype, head_dim):
        q, _kp, _vp, pt, sl, ql, H = _paged_case(head_dim, seed=4)
        kp, vp, ks, vs = _int8_pool(pt.size + 3, 8, H, head_dim, seed=4)
        args = [torch.from_numpy(q).to(cuda, dtype)]
        args += [t.to(cuda) for t in (kp, vp)]
        args += [torch.from_numpy(a).to(cuda) for a in (pt, sl, ql)]
        scales = dict(k_scales=ks.to(cuda), v_scales=vs.to(cuda))
        _build.reset_launches()
        got = tpa.ragged_paged_attention(*args, num_heads=H,
                                         head_dim=head_dim, **scales)
        snap = _build.routes_snapshot()
        assert (snap['paged_attention_int8'], snap['paged_attention']) \
            == (1, 0)
        want = tpa.ragged_paged_attention_plain(*args, num_heads=H,
                                                head_dim=head_dim, **scales)
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
        else:
            g, w = got.float(), want.float()
            rms = float(w.norm()) / w.numel() ** 0.5
            assert float((g - w).norm() / w.norm()) < 1e-2
            torch.testing.assert_close(g, w, rtol=2.0 ** -7,
                                       atol=2.0 ** -6 * rms)

    def test_paged_attention_int8_signs_and_no_visible_key(self, cuda):
        # codes of -127 and 127 only (a sign-extension fault would turn
        # -127 into 129); a seq_len-0 row writes zeros, and a query
        # before every key averages the visited page's dequantized V
        H, D, ps, N, T = 1, 128, 4, 3, 3
        g = torch.Generator().manual_seed(6)
        codes = torch.where(torch.rand(N, ps, H * D, generator=g) < 0.5,
                            -127, 127).to(torch.int8)
        vcodes = codes.flip(-1).contiguous()
        ks = torch.rand(N, ps, H, generator=g) * 0.05
        vs = torch.rand(N, ps, H, generator=g)
        q = torch.randn(2, T, H * D, generator=g)
        meta = [torch.tensor(a) for a in ([[1, 2], [2, 1]], [0, 2], [1, 3])]
        args = [t.to(cuda) for t in (q, codes, vcodes, *meta)]
        scales = dict(k_scales=ks.to(cuda), v_scales=vs.to(cuda))
        got = tpa.ragged_paged_attention(*args, num_heads=H, head_dim=D,
                                         **scales)
        want = tpa.ragged_paged_attention_plain(*args, num_heads=H,
                                                head_dim=D, **scales)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
        assert not got[0].any()
        deq = vcodes[2].float() * vs[2]
        torch.testing.assert_close(got[1, 0].cpu(), deq.mean(0), rtol=1e-4,
                                   atol=1e-4)

    @pytest.mark.parametrize('ctas_per_sm', [8, 1])
    @pytest.mark.parametrize('pages', ['dense', 'int8'])
    @pytest.mark.parametrize('T', [1, 5])
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_paged_attention_splits(self, cuda, dtype, T, pages,
                                    ctas_per_sm, monkeypatch):
        """Contexts over several splits (ctas_per_sm 1: fewer splits of
        several tiles, double-buffered in bf16, one buffer in fp32), both
        page types, against the plain version; the seq_len-0 slot writes
        zeros."""
        monkeypatch.setattr(tpa, 'CTAS_PER_SM', ctas_per_sm)
        q, kp, vp, pt, sl, ql, H, D = _split_case(T)
        args = [torch.from_numpy(q).to(cuda, dtype)]
        kw = dict(num_heads=H, head_dim=D)
        if pages == 'int8':
            kq, vq, ks, vs = _int8_pool(kp.shape[0], kp.shape[1], H, D,
                                        seed=9)
            args += [kq.to(cuda), vq.to(cuda)]
            kw.update(k_scales=ks.to(cuda), v_scales=vs.to(cuda))
        else:
            args += [torch.from_numpy(a).to(cuda, dtype) for a in (kp, vp)]
        args += [torch.from_numpy(a).to(cuda) for a in (pt, sl, ql)]
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        _qb, splits, per_split = tpa.paged_splits(
            len(sl), T, H, pt.shape[1], kp.shape[1], sms)
        assert splits > 1 and (per_split > 1) == (ctas_per_sm == 1)
        name = 'paged_attention_int8' if pages == 'int8' else \
            'paged_attention'
        _build.reset_launches()
        got = tpa.ragged_paged_attention(*args, **kw)
        assert _build.routes_snapshot()[name] == 1
        want = tpa.ragged_paged_attention_plain(*args, **kw)
        assert not got[3].any()
        if dtype == torch.float32:
            tol = FP32 if pages == 'dense' else dict(rtol=1e-3, atol=1e-4)
            torch.testing.assert_close(got, want, **tol)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       **BF16_ATTENTION)

    def test_paged_attention_int8_refusals(self, cuda):
        H, D = 2, 32
        kp, vp, ks, vs = (t.to(cuda) for t in _int8_pool(4, 8, H, D))
        q = torch.randn(1, 1, H * D, device=cuda)
        meta = [torch.zeros(1, 2, dtype=torch.int32, device=cuda),
                torch.ones(1, dtype=torch.int32, device=cuda),
                torch.ones(1, dtype=torch.int32, device=cuda)]
        kw = dict(num_heads=H, head_dim=D)
        _build.reset_launches()
        with pytest.raises(ValueError, match='both k_scales and v_scales'):
            tpa.ragged_paged_attention(q, kp, vp, *meta, k_scales=ks, **kw)
        with pytest.raises(TypeError, match='int8 pages need'):
            tpa.ragged_paged_attention(q, kp, vp, *meta, **kw)
        with pytest.raises(ValueError, match='contiguous float32'):
            tpa.ragged_paged_attention(q, kp, vp, *meta, k_scales=ks.half(),
                                       v_scales=vs, **kw)
        with pytest.raises(ValueError, match='contiguous float32'):
            tpa.ragged_paged_attention(q, kp, vp, *meta, k_scales=ks[:, :4],
                                       v_scales=vs, **kw)
        with pytest.raises(TypeError, match='int8 pages only'):
            tpa.ragged_paged_attention(q, kp.float(), vp.float(), *meta,
                                       k_scales=ks, v_scales=vs, **kw)
        assert _build.routes_snapshot()['paged_attention_int8'] == 0

    def test_quantizers_and_sampling_bits_match_the_cpu(self, cuda):
        # the KV and weight quantizers divide tensor by tensor and the
        # draw's uniforms are integer hashes: bit-equal on both devices
        from paddle_tpu_torch.quantization import quantize_to_int8
        from paddle_tpu_torch.serving import engine as teng
        g = torch.Generator().manual_seed(8)
        x = torch.randn(4, 9, 256, generator=g) * torch.rand(4, 9, 1,
                                                            generator=g) * 9
        for got, want in zip(tpa.quantize_kv_rows(x.to(cuda), 2),
                             tpa.quantize_kv_rows(x, 2)):
            assert torch.equal(got.cpu(), want)
        w = torch.randn(256, 96, generator=g).to(torch.bfloat16)
        for got, want in zip(quantize_to_int8(w.to(cuda), quant_axis=1),
                             quantize_to_int8(w, quant_axis=1)):
            assert torch.equal(got.cpu(), want)
        ords, pos = torch.arange(5), torch.arange(5) * 37 + 3
        assert torch.equal(
            teng.sample_uniforms(11, ords.to(cuda), pos.to(cuda),
                                 50304).cpu(),
            teng.sample_uniforms(11, ords, pos, 50304))

    @pytest.mark.parametrize('top_k', [0, 5], ids=['greedy', 'sampled'])
    def test_engine_fused_windows_on_card(self, cuda, top_k):
        # an int8 KV pool and int8 weights on the card: fused windows of
        # 4 emit the serial engine's tokens, attention only on the int8
        # kernel, and a window fetches once
        cfg = tgpt_serve.GPTConfig(
            vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=128, hidden_dropout=0.0, attn_dropout=0.0)
        gen = torch.Generator(device=cuda).manual_seed(9)
        model = tgpt_serve.GPTForCausalLM(cfg, device=cuda, generator=gen)
        rng = np.random.RandomState(3)
        prompts = [list(rng.randint(1, 128, n)) for n in (5, 11, 3, 17)]
        outs = {}
        for k in (1, 4):
            eng = ServingEngine(model, ServingConfig(
                page_size=8, max_batch_size=3, prefill_chunk=8,
                kv_dtype='int8', weight_dtype='int8', fused_k=k, seed=3),
                device=cuda)
            _build.reset_launches()
            outs[k] = eng.generate(prompts, max_new_tokens=9, top_k=top_k,
                                   temperature=0.8)
            snap = _build.routes_snapshot()
            assert snap['paged_attention_int8'] > 0
            assert snap['paged_attention'] == 0
            assert (eng.stats()['fused_windows_total'] > 0) == (k > 1)
            assert eng.pool.pages_in_use == 0
            eng.shutdown()
        assert outs[4] == outs[1]

    def test_kernel_refuses_what_it_does_not_take(self, cuda):
        x = torch.randn(4, 16, device=cuda, dtype=torch.float16)
        with pytest.raises(TypeError, match='no kernel for dtype'):
            tfe.bias_gelu(x, torch.zeros(16, device=cuda), True)
        y = torch.randn(16, 4, device=cuda).t()
        with pytest.raises(ValueError, match='contiguous'):
            tfn.layer_norm(y, torch.ones(16, device=cuda),
                           torch.zeros(16, device=cuda), 1e-5)
        q = torch.randn(1, 1, 2 * 512, device=cuda)
        pages = torch.randn(2, 4, 2 * 512, device=cuda)
        meta = [torch.zeros(1, 1, dtype=torch.int32, device=cuda),
                torch.ones(1, dtype=torch.int32, device=cuda),
                torch.ones(1, dtype=torch.int32, device=cuda)]
        with pytest.raises(ValueError, match='head_dim > 256'):
            tpa.ragged_paged_attention(q, pages, pages, *meta, num_heads=2,
                                       head_dim=512)

    # -----------------------------------------------------------------
    # the training slice's kernels
    # -----------------------------------------------------------------
    @pytest.mark.parametrize('L', [256, 200, 129])
    @pytest.mark.parametrize('head_dim', [32, 64, 128])
    @pytest.mark.parametrize('with_bias', [False, True],
                             ids=['nobias', 'bias'])
    @pytest.mark.parametrize('causal', [True, False],
                             ids=['causal', 'full'])
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_flash_kernels(self, cuda, dtype, causal, with_bias, head_dim,
                           L):
        g = torch.Generator(device=cuda).manual_seed(7)
        B, H = 2, 2
        q, k, v, do = (torch.randn(B, L, H * head_dim, generator=g,
                                   device=cuda).to(dtype) for _ in range(4))
        bias = None
        if with_bias:
            bias = torch.where(torch.rand(B, L, generator=g, device=cuda)
                               > 0.2, 0.0, -1e4)
        kw = dict(num_heads=H, head_dim=head_dim, bias=bias, causal=causal)
        _build.reset_launches()
        o, lse = tfa.flash_attention_packed_fwd(q, k, v, **kw)
        dq, dk, dv = tfa.flash_attention_packed_bwd(q, k, v, o, lse, do,
                                                    **kw)
        snap = _build.routes_snapshot()
        assert (snap['flash_fwd'], snap['flash_bwd_dq'],
                snap['flash_bwd_dkv']) == (1, 1, 1)
        o_p, lse_p = tfa.flash_attention_packed_plain(q, k, v, **kw)
        grads_p = tfa.flash_attention_packed_bwd_plain(q, k, v, o_p, lse_p,
                                                       do, **kw)
        tol = FP32_SUMS if dtype == torch.float32 else BF16_ATTENTION
        torch.testing.assert_close(o.float(), o_p.float(), **tol)
        torch.testing.assert_close(lse, lse_p, **FP32_SUMS)
        for got, want in zip((dq, dk, dv), grads_p):
            if dtype == torch.bfloat16:
                assert_flash_bf16_tc(got, want)
            else:
                torch.testing.assert_close(got.float(), want.float(), **tol)

    @pytest.mark.parametrize('L', [256, 200])
    @pytest.mark.parametrize('head_dim', [32, 64, 128])
    @pytest.mark.parametrize('case', ['causal', 'causal_mask', 'full_bias',
                                      'causal_bias_mask'])
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_bhld_flash_kernels(self, cuda, dtype, case, head_dim, L):
        g = torch.Generator(device=cuda).manual_seed(17)
        B, H = 2, 3
        q, k, v, do = (torch.randn(B * H, L, head_dim, generator=g,
                                   device=cuda).to(dtype) for _ in range(4))
        bias = mask = None
        if 'bias' in case:
            bias = torch.where(torch.rand(B, L, generator=g, device=cuda)
                               > 0.2, 0.0, -1e4)
        if 'mask' in case:
            mask = torch.rand(B * H, L, L, generator=g, device=cuda) >= 0.1
        kw = dict(bias=bias, num_heads=H, causal=case.startswith('causal'),
                  dropout_mask=mask, dropout=0.1 if mask is not None else 0.0)
        _build.reset_launches()
        o, lse = tfa._flash_forward(q, k, v, **kw)
        dq, dk, dv = tfa._flash_backward(q, k, v, o, lse, do, **kw)
        snap = _build.routes_snapshot()
        assert (snap['flash_bhld_fwd'], snap['flash_bhld_bwd_dq'],
                snap['flash_bhld_bwd_dkv']) == (1, 1, 1)
        assert snap['flash_fwd'] == snap['flash_bwd_dq'] == 0
        o_p, lse_p = tfa.flash_forward_plain(q, k, v, **kw)
        grads_p = tfa.flash_backward_plain(q, k, v, o_p, lse_p, do, **kw)
        tol = FP32_SUMS if dtype == torch.float32 else BF16_ATTENTION
        torch.testing.assert_close(o.float(), o_p.float(), **tol)
        torch.testing.assert_close(lse, lse_p, **FP32_SUMS)
        for got, want in zip((dq, dk, dv), grads_p):
            if dtype == torch.bfloat16:
                assert_flash_bf16_tc(got, want)
            else:
                torch.testing.assert_close(got.float(), want.float(), **tol)

    @pytest.mark.parametrize('L', [129, 200, 2048])
    @pytest.mark.parametrize('head_dim', [32, 64, 128])
    @pytest.mark.parametrize('layout', ['packed', 'bhld_mask'])
    def test_bf16_forward_on_the_tensor_cores(self, cuda, layout, head_dim,
                                              L):
        """The tensor-core forward on inputs that start 2 bytes past a
        16-byte boundary (the wrapper copies them aligned), causal; BHLD
        with a keep mask at p = 0.1, staged a byte at a time where
        L % 16 != 0."""
        g = torch.Generator(device=cuda).manual_seed(19)
        B, H = (1 if L == 2048 else 2), 2

        def misaligned(*shape):
            n = int(np.prod(shape))
            x = torch.randn(n + 1, generator=g, device=cuda).bfloat16()
            return x[1:].view(*shape)

        mask = None
        if layout == 'packed':
            q, k, v = (misaligned(B, L, H * head_dim) for _ in range(3))
            kw = dict(num_heads=H, head_dim=head_dim, bias=None,
                      causal=True)
            _build.reset_launches()
            o, lse = tfa.flash_attention_packed_fwd(q, k, v, **kw)
            assert _build.routes_snapshot()['flash_fwd'] == 1
            o_p, lse_p = tfa.flash_attention_packed_plain(
                q.float(), k.float(), v.float(), **kw)
        else:
            q, k, v = (misaligned(B * H, L, head_dim) for _ in range(3))
            mask = torch.rand(B * H, L, L, generator=g, device=cuda) >= 0.1
            kw = dict(num_heads=H, causal=True, dropout_mask=mask,
                      dropout=0.1)
            _build.reset_launches()
            o, lse = tfa._flash_forward(q, k, v, **kw)
            assert _build.routes_snapshot()['flash_bhld_fwd'] == 1
            o_p, lse_p = tfa.flash_forward_plain(q.float(), k.float(),
                                                 v.float(), **kw)
        assert q.data_ptr() % 16 and o.dtype == torch.bfloat16
        assert_flash_bf16_tc(o, o_p, FLASH_BF16)
        torch.testing.assert_close(lse, lse_p, **FP32_SUMS)

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_gradients_flow_through_the_bhld_functions(self, cuda, dtype):
        """flash_attention_bhld, _flash_attn_dropout and _flash_attn_biased
        on the card: grad_fns, the BHLD kernels launched, gradients as the
        CPU's plain route gives them, the bias gradient zeros."""
        g = torch.Generator(device=cuda).manual_seed(18)
        B, H, L, D = 2, 2, 160, 64

        def leaf(*shape):
            return torch.randn(*shape, generator=g, device=cuda).to(
                dtype).requires_grad_()

        q, k, v = leaf(B * H, L, D), leaf(B * H, L, D), leaf(B * H, L, D)
        bias = torch.where(torch.rand(B, L, generator=g, device=cuda) > 0.2,
                           0.0, -1e4).requires_grad_()
        mask = torch.rand(B * H, L, L, generator=g, device=cuda) >= 0.1

        def outs(q, k, v, bias, mask):
            return [tfa.flash_attention_bhld(q, k, v),
                    tfa._flash_attn_dropout(0.1, q, k, v, mask),
                    tfa._flash_attn_biased(False, H, q, k, v, bias)]

        _build.reset_launches()
        got = outs(q, k, v, bias, mask)
        for o in got:
            assert o.grad_fn is not None
        sum(o.float().square().sum() for o in got).backward()
        snap = _build.routes_snapshot()
        assert (snap['flash_bhld_fwd'], snap['flash_bhld_bwd_dq'],
                snap['flash_bhld_bwd_dkv']) == (3, 3, 3)
        assert bias.grad is not None and not bias.grad.any()
        cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v, bias)]
        want = outs(*cpu, mask.cpu())
        sum(o.float().square().sum() for o in want).backward()
        for t, c in zip((q, k, v), cpu):
            assert t.grad.dtype == dtype
            if dtype == torch.bfloat16:     # the tensor-core backward
                assert_flash_bf16_tc(t.grad.cpu(), c.grad)
            else:
                torch.testing.assert_close(t.grad.float().cpu(),
                                           c.grad.float(), **FP32_SUMS)

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('shape,offset', BWD_LN_CASES)
    def test_layer_norm_bwd_kernel(self, cuda, dtype, shape, offset):
        g = torch.Generator(device=cuda).manual_seed(2)
        x = _offset_randn(shape, offset, g, cuda, dtype)
        w = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
        b = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
        dy = _offset_randn(shape, offset, g, cuda, dtype)
        _y, mean, rstd = tfn.layer_norm_fwd_plain(x, w, b, 1e-5)
        _build.reset_launches()
        got = tfn.layer_norm_bwd(x, w, dy, mean, rstd)
        assert _build.routes_snapshot()['layer_norm_bwd'] == 2
        want = tfn.layer_norm_bwd_plain(x, w, dy, mean, rstd)
        tol = FP32_SUMS if dtype == torch.float32 else BF16_ELEMENTWISE
        torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
        for a, e in zip(got[1:], want[1:]):       # fp32 sums over rows
            torch.testing.assert_close(a, e, **FP32_SUMS)

    @pytest.mark.parametrize('approximate', [True, False])
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('shape,offset', BWD_GELU_CASES)
    def test_bias_gelu_bwd_kernel(self, cuda, dtype, shape, offset,
                                  approximate):
        g = torch.Generator(device=cuda).manual_seed(3)
        x = _offset_randn(shape, offset, g, cuda, dtype)
        b = torch.randn(shape[-1], generator=g, device=cuda)
        dy = _offset_randn(shape, offset, g, cuda, dtype)
        _build.reset_launches()
        dx, db = tfe.bias_gelu_bwd(x, b, dy, approximate)
        assert _build.routes_snapshot()['bias_gelu_bwd'] == 2
        dx_p, db_p = tfe.bias_gelu_bwd_plain(x, b, dy, approximate)
        tol = FP32 if dtype == torch.float32 else BF16_ELEMENTWISE
        torch.testing.assert_close(dx.float(), dx_p.float(), **tol)
        torch.testing.assert_close(db, db_p, **FP32_SUMS)

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('shape,offset', [((16384, 2048), 0),
                                              ((16411, 8200), 0),
                                              ((300, 37), 0),
                                              ((300, 2048), 1)])
    def test_backward_reductions_are_deterministic(self, cuda, dtype, shape,
                                                   offset):
        """Two calls on the same inputs give the same bits: dx, dw, db of
        the LayerNorm backward and dx, dbias of the bias+GELU backward
        (fixed partitions summed in a fixed order, no float atomics)."""
        g = torch.Generator(device=cuda).manual_seed(5)
        x = _offset_randn(shape, offset, g, cuda, dtype)
        dy = _offset_randn(shape, offset, g, cuda, dtype)
        w = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
        _y, mean, rstd = tfn.layer_norm_fwd_plain(x, w, w, 1e-5)
        for fn in (lambda: tfn.layer_norm_bwd(x, w, dy, mean, rstd),
                   lambda: tfe.bias_gelu_bwd(x, w, dy, True)):
            first, second = fn(), fn()
            for a, c in zip(first, second):
                assert torch.equal(a, c)

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_gradients_flow_through_every_kernel_wrapper(self, cuda, dtype):
        """A CUDA output that needs a gradient has a grad_fn, and its
        backward fills every input's .grad through the kernels, as the
        CPU route's does."""
        g = torch.Generator(device=cuda).manual_seed(4)

        def leaf(*shape):
            return torch.randn(*shape, generator=g, device=cuda).to(
                dtype).requires_grad_()

        x, w, b = leaf(6, 128), leaf(128), leaf(128)
        fb = leaf(128)
        B, L, H, D = 1, 96, 2, 64
        q, k, v = leaf(B, L, H * D), leaf(B, L, H * D), leaf(B, L, H * D)
        _build.reset_launches()
        outs = [tfn.layer_norm(x, w, b, 1e-5), tfe.bias_gelu(x, fb, True),
                tfa.flash_attention_packed(q, k, v, H, D, causal=True)]
        for o in outs:
            assert o.grad_fn is not None
        sum(o.float().square().sum() for o in outs).backward()
        for t in (x, w, b, fb, q, k, v):
            assert t.grad is not None and t.grad.dtype == dtype
            assert bool(t.grad.float().abs().sum() > 0)
        snap = _build.routes_snapshot()
        for name in ('layer_norm', 'layer_norm_bwd', 'bias_gelu',
                     'bias_gelu_bwd', 'flash_fwd', 'flash_bwd_dq',
                     'flash_bwd_dkv'):
            assert snap[name] > 0, name
        # the same loss through the plain versions on the CPU
        cpu = [t.detach().cpu().requires_grad_() for t in (x, w, b, fb, q, k,
                                                            v)]
        xc, wc, bc, fbc, qc, kc, vc = cpu
        outs_c = [tfn.layer_norm(xc, wc, bc, 1e-5),
                  tfe.bias_gelu(xc, fbc, True),
                  tfa.flash_attention_packed(qc, kc, vc, H, D, causal=True)]
        sum(o.float().square().sum() for o in outs_c).backward()
        tol = FP32_SUMS if dtype == torch.float32 else BF16_ATTENTION
        for i, (t, c) in enumerate(zip((x, w, b, fb, q, k, v), cpu)):
            if dtype == torch.bfloat16 and i >= 4:  # q, k, v: tensor cores
                assert_flash_bf16_tc(t.grad.cpu(), c.grad)
            else:
                torch.testing.assert_close(t.grad.float().cpu(),
                                           c.grad.float(), **tol)

    def test_paged_attention_refuses_grad_on_card(self, cuda):
        q, kp, vp, pt, sl, ql, H = _paged_case(32)
        args = [torch.from_numpy(a).to(cuda, torch.float32)
                for a in (q, kp, vp)]
        args[0].requires_grad_()
        args += [torch.from_numpy(a).to(cuda) for a in (pt, sl, ql)]
        with pytest.raises(RuntimeError, match='no backward'):
            tpa.ragged_paged_attention(*args, num_heads=H, head_dim=32)
        with torch.no_grad():
            tpa.ragged_paged_attention(*args, num_heads=H, head_dim=32)

    # -----------------------------------------------------------------
    # the bucketed optimizer's and the dropout+residual kernels
    # -----------------------------------------------------------------
    @pytest.mark.parametrize('n', [8, 7777, 1 << 20, 3 * 2048 + 5])
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_grad_stats_kernel(self, cuda, dtype, n):
        g = torch.Generator(device=cuda).manual_seed(8)
        x = torch.randn(n, generator=g, device=cuda).to(dtype)
        _build.reset_launches()
        s, c = tfo.grad_stats(x)
        assert _build.routes_snapshot()['grad_stats'] == 1   # one launch
        ps, pc = tfo.grad_stats_plain(x)
        torch.testing.assert_close(s, ps, rtol=1e-5, atol=0)
        assert float(c) == float(pc) == 0.0
        s2, c2 = tfo.grad_stats(x)                 # the same bits again
        assert torch.equal(s, s2) and torch.equal(c, c2)
        x[n // 2] = float('nan')
        x[0] = float('inf')
        s, c = tfo.grad_stats(x)
        assert not bool(torch.isfinite(s)) and float(c) == 2.0

    def test_grad_stats_ticket_resets_between_calls(self, cuda):
        """50 calls over three sizes in turn (one CTA, a few, the whole
        card; one off 16-byte alignment), queued back to back on one
        stream: each matches the plain version, so the last CTA of every
        call found the ticket at 0 and left it there."""
        g = torch.Generator(device=cuda).manual_seed(9)
        base = torch.randn((1 << 22) + 1, generator=g, device=cuda)
        xs = [base[:8].bfloat16(), base[1:7778], base[:1 << 22].bfloat16()]
        got = [tfo.grad_stats(xs[i % 3]) for i in range(50)]
        want = [tfo.grad_stats_plain(x) for x in xs]
        for i, (s, c) in enumerate(got):
            ps, pc = want[i % 3]
            torch.testing.assert_close(s, ps, rtol=1e-5, atol=0)
            assert float(c) == float(pc) == 0.0
            assert torch.equal(s, got[i % 3][0])
        assert int(tfo._TICKETS[cuda.index or 0].item()) == 0

    @pytest.mark.parametrize('n', [1000, 4096 + 3])
    @pytest.mark.parametrize('storage', [
        (torch.float32, False), (torch.float32, True),
        (torch.bfloat16, True), (torch.bfloat16, False)],
        ids=['fp32', 'fp32-master', 'bf16-master', 'bf16'])
    @pytest.mark.parametrize('rule', ['sgd', 'momentum', 'nesterov', 'adam',
                                      'adamw', 'adamw_bf16_moments',
                                      'adagrad', 'rmsprop',
                                      'rmsprop_centered', 'adamax',
                                      'adadelta', 'decayed_adagrad'])
    def test_fused_update_kernel(self, cuda, rule, storage, n):
        dtype, master = storage
        mk = {'sgd': lambda: topt.SGD(0.1, weight_decay=0.01,
                                      multi_precision=master),
              'momentum': lambda: topt.Momentum(0.05, weight_decay=1e-4,
                                                multi_precision=master),
              'nesterov': lambda: topt.Momentum(0.05, use_nesterov=True,
                                                multi_precision=master),
              'adam': lambda: topt.Adam(0.01, weight_decay=0.01,
                                        multi_precision=master),
              'adamw': lambda: topt.AdamW(0.01, multi_precision=master),
              'adamw_bf16_moments': lambda: topt.AdamW(
                  0.01, moment_dtype='bfloat16', multi_precision=master),
              'adagrad': lambda: topt.Adagrad(
                  0.1, initial_accumulator_value=0.1, weight_decay=0.01),
              'rmsprop': lambda: topt.RMSProp(0.01, momentum=0.9),
              'rmsprop_centered': lambda: topt.RMSProp(
                  0.01, momentum=0.9, centered=True, weight_decay=1e-4),
              'adamax': lambda: topt.Adamax(0.01),
              'adadelta': lambda: topt.Adadelta(0.5),
              'decayed_adagrad': lambda: topt.DecayedAdagrad(0.05)}
        # the rules added with their optimizer classes must be bit-equal
        exact = rule in ('adagrad', 'rmsprop', 'rmsprop_centered', 'adamax',
                         'adadelta', 'decayed_adagrad')
        opt = mk[rule]()
        # the five newer classes, as the reference's, take no
        # multi_precision argument; the no-master case is set directly
        opt._multi_precision = master
        gen = torch.Generator(device=cuda).manual_seed(9)
        p = torch.randn(n, generator=gen, device=cuda).to(dtype)
        st = opt.init_state(torch.zeros(n, device=cuda))
        for k, v in st.items():
            if k == 'mean_grad':       # |mean_grad| <= sqrt(mean_square)/2
                v.copy_((torch.rand(n, generator=gen, device=cuda) - 0.5)
                        * st['mean_square'].sqrt())
            elif v.dim():
                v.copy_(0.1 * torch.rand(n, generator=gen, device=cuda))
            else:
                v.fill_(0.9 ** 3 if k == 'beta1_pow' else 0.999 ** 3)
        if master:
            st['master'] = p.float() + 1e-3 * torch.randn(
                n, generator=gen, device=cuda)
        lr, pref = torch.tensor(0.01, device=cuda), torch.tensor(
            0.7, device=cuda)
        for gdt in {dtype, torch.float32}:
            grad = torch.randn(n, generator=gen, device=cuda).to(gdt)
            for fi in (None, torch.tensor(False, device=cuda)):
                want_p, want_s = tfo.fused_shard_update_plain(
                    opt, p, grad, dict(st), lr, prefactor=pref, found_inf=fi)
                gp, gs = p.clone(), {k: v.clone() for k, v in st.items()}
                _build.reset_launches()
                out_p, out_s = tfo.fused_shard_update(
                    opt, gp, grad, gs, lr, prefactor=pref, found_inf=fi)
                assert _build.routes_snapshot()['optimizer_step'] == 1
                assert out_p is gp and set(out_s) == set(want_s)
                for got, want in [(out_p, want_p)] + [
                        (out_s[k], want_s[k]) for k in want_s]:
                    assert got.dtype == want.dtype
                    if exact:
                        assert torch.equal(got, want), rule
                    elif got.dtype == torch.float32:
                        torch.testing.assert_close(got, want, rtol=2e-6,
                                                   atol=5e-7)
                    else:
                        # bf16: the same fp32 value rounds once; an fp32
                        # ulp may cross a bf16 rounding boundary
                        torch.testing.assert_close(
                            got.float(), want.float(), rtol=2.0 ** -7,
                            atol=0)
                        same = (got == want).float().mean()
                        assert float(same) >= 0.999

    @pytest.mark.parametrize('rule', ['momentum', 'adamw_bf16_moments',
                                      'rmsprop_centered', 'adamax'])
    def test_fused_update_found_inf_is_an_exact_noop(self, cuda, rule):
        opt = {'momentum': lambda: topt.Momentum(0.05),
               'adamw_bf16_moments': lambda: topt.AdamW(
                   0.01, moment_dtype='bfloat16', multi_precision=False),
               'rmsprop_centered': lambda: topt.RMSProp(
                   0.01, momentum=0.9, centered=True),
               'adamax': lambda: topt.Adamax(0.01)}[rule]()
        n = 5000
        p = torch.randn(n, device=cuda).to(torch.bfloat16)
        st = opt.init_state(torch.zeros(n, device=cuda))
        for v in st.values():
            v.copy_(torch.rand(v.shape, device=cuda)) if v.dim() else \
                v.fill_(0.5)
        grad = torch.full((n,), float('nan'), device=cuda,
                          dtype=torch.bfloat16)
        gp, gs = p.clone(), {k: v.clone() for k, v in st.items()}
        _, ns = tfo.fused_shard_update(
            opt, gp, grad, gs, torch.tensor(0.01, device=cuda),
            prefactor=torch.tensor(1.0, device=cuda),
            found_inf=torch.tensor(True, device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(gp.view(torch.int16), p.view(torch.int16))
        for k, v in st.items():
            assert torch.equal(ns[k], v), k

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('rule', ['sgd', 'momentum', 'adam', 'adamw',
                                      'adamw_bf16_moments', 'adagrad',
                                      'rmsprop_centered', 'adamax',
                                      'adadelta', 'decayed_adagrad'])
    def test_param_updates_match_the_plain_chain(self, cuda, rule, dtype):
        """The per-parameter route: one launch a parameter, the step's
        scalar block shared, the loss-scale prefactor rounded back to the
        gradient's dtype; bit-equal to the plain chain over 3 steps (the
        beta powers read where the last call left them)."""
        mk = {'sgd': lambda: topt.SGD(0.1, weight_decay=0.01),
              'momentum': lambda: topt.Momentum(0.05, weight_decay=1e-4),
              'adam': lambda: topt.Adam(0.01, weight_decay=0.01),
              'adamw': lambda: topt.AdamW(0.01),
              'adamw_bf16_moments': lambda: topt.AdamW(
                  0.01, moment_dtype='bfloat16', multi_precision=False),
              'adagrad': lambda: topt.Adagrad(0.1, weight_decay=0.01),
              'rmsprop_centered': lambda: topt.RMSProp(
                  0.01, momentum=0.9, centered=True),
              'adamax': lambda: topt.Adamax(0.01),
              'adadelta': lambda: topt.Adadelta(0.5),
              'decayed_adagrad': lambda: topt.DecayedAdagrad(0.05)}
        opt = mk[rule]()
        gen = torch.Generator(device=cuda).manual_seed(3)
        shapes = [(1000,), (64, 48), (4096 + 3,)]
        ps = [torch.randn(sh, generator=gen, device=cuda).to(dtype)
              for sh in shapes]
        kp = [p.clone() for p in ps]
        want_s = [{} for _ in ps]
        got_s = [{} for _ in ps]
        lr = torch.tensor(0.01, device=cuda)
        pref = 1.0 / torch.tensor(2.0 ** 10, device=cuda)
        for _ in range(3):
            grads = [(2.0 ** 10 * torch.randn(sh, generator=gen,
                                              device=cuda)).to(dtype)
                     for sh in shapes]
            _build.reset_launches()
            upd = tfo.ParamUpdates(opt, lr, prefactor=pref)
            for i, (p, g) in enumerate(zip(kp, grads)):
                st = got_s[i] or opt.init_state(p)
                _p, got_s[i] = upd(p, g, st)
            assert _build.routes_snapshot()['optimizer_step'] == len(ps)
            for i, (p, g) in enumerate(zip(ps, grads)):
                st = want_s[i] or opt.init_state(p)
                ps[i], want_s[i] = tfo.fused_shard_update_plain(
                    opt, p, g, st, lr, prefactor=pref, round_prefactor=True)
        for i in range(len(ps)):
            assert torch.equal(kp[i], ps[i]), rule
            assert set(got_s[i]) == set(want_s[i])
            for k in want_s[i]:
                assert torch.equal(got_s[i][k], want_s[i][k]), (rule, k)

    @pytest.mark.parametrize('rule', ['sgd', 'momentum', 'nesterov', 'adam',
                                      'adamw', 'adamw_bf16_moments',
                                      'adagrad', 'rmsprop',
                                      'rmsprop_centered', 'adamax',
                                      'adadelta', 'decayed_adagrad'])
    def test_list_form_matches_the_plain_chain(self, cuda, rule):
        """The list form (`ParamUpdates.apply`): one launch a dtype
        group (fp32; bf16; bf16 with an fp32 master), bit-equal to the
        plain chain over 2 steps for every rule, with odd sizes, a view
        one element off 16-byte alignment and an empty tensor among them,
        under a loss scale rounded back to the gradient's dtype; then a
        found-inf step on NaN gradients leaves every output's bits."""
        mk = {'sgd': lambda: topt.SGD(0.1, weight_decay=0.01),
              'momentum': lambda: topt.Momentum(0.05, weight_decay=1e-4),
              'nesterov': lambda: topt.Momentum(0.05, use_nesterov=True),
              'adam': lambda: topt.Adam(0.01, weight_decay=0.01),
              'adamw': lambda: topt.AdamW(0.01),
              'adamw_bf16_moments': lambda: topt.AdamW(
                  0.01, moment_dtype='bfloat16'),
              'adagrad': lambda: topt.Adagrad(0.1, weight_decay=0.01),
              'rmsprop': lambda: topt.RMSProp(0.01, momentum=0.9),
              'rmsprop_centered': lambda: topt.RMSProp(
                  0.01, momentum=0.9, centered=True, weight_decay=1e-4),
              'adamax': lambda: topt.Adamax(0.01),
              'adadelta': lambda: topt.Adadelta(0.5),
              'decayed_adagrad': lambda: topt.DecayedAdagrad(0.05)}
        opt = mk[rule]()
        opt._multi_precision = False      # masters below, where wanted
        gen = torch.Generator(device=cuda).manual_seed(21)
        ps = [_offset_randn((n,), off, gen, cuda, dt)
              for dt in (torch.float32, torch.bfloat16)
              for n, off in ((1000, 0), (4099, 0), (7, 0), (1001, 1),
                             (0, 0))]
        sts = []
        for i, p in enumerate(ps):
            st = opt.init_state(p)
            for k, v in st.items():
                if k == 'mean_grad':
                    v.copy_((torch.rand(v.shape, generator=gen, device=cuda)
                             - 0.5) * st['mean_square'].sqrt())
                elif v.dim():
                    v.copy_(0.1 * torch.rand(v.shape, generator=gen,
                                             device=cuda))
            if p.dtype == torch.bfloat16 and i % 2:
                # a third group: bf16 with an fp32 master
                st['master'] = p.float() + 1e-3 * torch.randn(
                    p.shape, generator=gen, device=cuda)
            sts.append(st)
        groups = len({(p.dtype, 'master' in st) for p, st in zip(ps, sts)
                      if p.numel() or st.get('beta1_pow') is not None})
        lr = torch.tensor(0.01, device=cuda)
        pref = 1.0 / torch.tensor(2.0 ** 10, device=cuda)
        kp = [p.clone() if not p.storage_offset() else
              _offset_randn(p.shape, 1, gen, cuda, p.dtype).copy_(p)
              for p in ps]
        assert kp[3].data_ptr() % 16 and kp[8].data_ptr() % 16
        got = [{k: v.clone() for k, v in st.items()} for st in sts]
        want = sts
        for step in range(3):
            fi = torch.tensor(step == 2, device=cuda)
            grads = [(2.0 ** 10 * torch.randn(p.shape, generator=gen,
                                              device=cuda)).to(p.dtype)
                     for p in ps]
            if step == 2:
                grads = [torch.full_like(g, float('nan')) for g in grads]
            before = [(p.clone(), {k: v.clone() for k, v in st.items()})
                      for p, st in zip(kp, got)]
            _build.reset_launches()
            out = tfo.ParamUpdates(opt, lr, prefactor=pref, found_inf=fi
                                   ).apply(list(zip(kp, grads, got)))
            assert _build.routes_snapshot()['optimizer_step'] == groups
            got = [st for _p, st in out]
            for i, (p, g) in enumerate(zip(ps, grads)):
                ps[i], want[i] = tfo.fused_shard_update_plain(
                    opt, p, g, want[i], lr, prefactor=pref, found_inf=fi,
                    round_prefactor=True)
            for i in range(len(ps)):
                assert torch.equal(kp[i], ps[i]), (rule, step, i)
                assert set(got[i]) == set(want[i])
                for k in want[i]:
                    assert torch.equal(got[i][k], want[i][k]), (rule, step,
                                                                 i, k)
            if step == 2:
                for (p0, st0), p, st in zip(before, kp, got):
                    assert torch.equal(p, p0)
                    for k, v in st0.items():
                        assert torch.equal(st[k], v), (rule, k)

    def test_list_above_capacity_splits_on_card(self, cuda):
        """TABLE_CAP + 16 tensors of one group: two launches, in order,
        bit-equal to one call a tensor."""
        opt = topt.AdamW(0.01, weight_decay=0.05, multi_precision=False,
                         moment_dtype='bfloat16')
        gen = torch.Generator(device=cuda).manual_seed(22)
        n = tfo.TABLE_CAP + 16
        ps = [torch.randn(100 + 37 * i, generator=gen, device=cuda).to(
            torch.bfloat16) for i in range(n)]
        gs = [torch.randn(p.shape, generator=gen, device=cuda).to(
            torch.bfloat16) for p in ps]
        lr = torch.tensor(0.01, device=cuda)
        want = [(p.clone(), opt.init_state(p)) for p in ps]
        upd = tfo.ParamUpdates(opt, lr)
        for i, ((p, st), g) in enumerate(zip(want, gs)):
            want[i] = upd(p, g, st)
        _build.reset_launches()
        got = tfo.ParamUpdates(opt, lr).apply(
            [(p, g, opt.init_state(p)) for p, g in zip(ps, gs)])
        assert _build.routes_snapshot()['optimizer_step'] == 2
        for (p, st), (wp, ws) in zip(got, want):
            assert torch.equal(p, wp)
            for k in ws:
                assert torch.equal(st[k], ws[k]), k

    def test_a_list_on_two_devices_raises(self, cuda):
        """CPU and card tensors in one list raise on either route (the
        CPU tensor first or the card's), under a Python lr, before any
        tensor is updated: no card tensor reaches the plain chain."""
        opt = topt.Momentum(0.05)
        a, b = torch.randn(5), torch.randn(4, device=cuda)
        on_cpu = (a, torch.randn(5), opt.init_state(a))
        on_card = (b, torch.randn(4, device=cuda), opt.init_state(b))
        a0, b0 = a.clone(), b.clone()
        for entries in ([on_cpu, on_card], [on_card, on_cpu]):
            with pytest.raises(ValueError, match='different devices'):
                tfo.ParamUpdates(opt, 0.1).apply(entries)
        assert torch.equal(a, a0) and torch.equal(b, b0)

    def test_engine_loss_scale_on_card(self, cuda):
        """SpmdPipelineEngine's loss-scaling path on the card: a scale of
        2^10 leaves fp32 SGD bit-equal to the unscaled steps; each scaled
        step launches the statistics kernel once a parameter and the
        update kernel once (one list); a step at scale=inf skips the
        update bit for bit."""
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            spmd_pipeline as tsp)
        cfg = tgpt_serve.GPTConfig(vocab_size=128, hidden_size=64,
                                   num_layers=2, num_heads=2,
                                   max_seq_len=64, hidden_dropout=0.0,
                                   attn_dropout=0.0)
        ids = np.random.RandomState(0).randint(0, 128, (4, 64)).astype(
            'int32')
        data = (ids, np.roll(ids, -1, 1).astype('int32'))

        def engine():
            triple = tgpt_serve.build_gpt_pipeline(
                cfg, generator=torch.Generator().manual_seed(5))
            return tsp.SpmdPipelineEngine(
                *triple, topt.SGD(learning_rate=1e-2), accumulate_steps=2,
                device=cuda)

        plain, scaled = engine(), engine()
        for _ in range(2):
            plain.train_batch(data)
        _build.reset_launches()
        for _ in range(2):
            scaled.train_batch(data, scale=1024.0)
            assert not bool(scaled.last_found_inf)
        n = len(scaled._named)
        counts = _build.routes_snapshot()
        assert counts['grad_stats'] == 2 * n
        assert counts['optimizer_step'] == 2
        for (_, a), (_, b) in zip(plain._named, scaled._named):
            assert torch.equal(a, b)
        before = [p.detach().clone() for _, p in scaled._named]
        scaled.train_batch(data, scale=float('inf'))
        assert bool(scaled.last_found_inf)
        for b, (_, p) in zip(before, scaled._named):
            assert torch.equal(b, p)

    @pytest.mark.parametrize('shape', [(3, 5, 64), (16, 2048), (7, 37)])
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_dropout_add_kernels(self, cuda, dtype, shape):
        g = torch.Generator(device=cuda).manual_seed(10)
        x, r, dy = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                    for _ in range(3))
        keep = torch.rand(shape, generator=g, device=cuda) < 0.9
        _build.reset_launches()
        y = tfe.dropout_add_fwd(x, r, keep, 0.1)
        dx = tfe.dropout_add_bwd(keep, dy, 0.1)
        snap = _build.routes_snapshot()
        assert (snap['dropout_add'], snap['dropout_add_bwd']) == (1, 1)
        assert torch.equal(y, tfe.dropout_add_plain(x, r, keep, 0.1))
        assert torch.equal(dx, tfe.dropout_add_bwd_plain(keep, dy, 0.1))

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_gradients_flow_through_dropout_add(self, cuda, dtype):
        g = torch.Generator(device=cuda).manual_seed(11)
        x, r = (torch.randn(4, 96, generator=g, device=cuda).to(dtype)
                .requires_grad_() for _ in range(2))
        keep = torch.rand(4, 96, generator=g, device=cuda) < 0.8
        _build.reset_launches()
        y = tfe.dropout_add(x, r, keep, 0.2)
        assert y.grad_fn is not None
        y.float().square().sum().backward()
        snap = _build.routes_snapshot()
        assert (snap['dropout_add'], snap['dropout_add_bwd']) == (1, 1)
        dy = (2 * y.detach().float()).to(dtype)
        assert torch.equal(r.grad, dy)
        assert torch.equal(x.grad, tfe.dropout_add_bwd_plain(keep, dy, 0.2))
        assert not bool(x.grad[~keep].any())

    def test_bucketed_train_step_on_card(self, cuda):
        """The default TrainStep on the card: grads are views of their
        buckets, every new kernel launches, and the card's first step
        (SGD with the global-norm clip) matches the CPU's from the same
        weights and masks."""
        from paddle_tpu_torch import jit as tjit
        from paddle_tpu_torch import nn as tnn
        from paddle_tpu_torch.core import rng as trng
        from paddle_tpu_torch.models import gpt as tgpt

        cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
                   max_seq_len=64, hidden_dropout=0.1, attn_dropout=0.0)
        gen = torch.Generator().manual_seed(0)
        cpu_model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), generator=gen)
        card_model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
        card_model.load_state_dict(cpu_model.state_dict())
        masks = [torch.rand(2, 32, 64, generator=gen) < 0.9
                 for _ in range(5)]
        calls = []

        def replay(shape, keep_prob, device):
            calls.append(shape)
            return masks[(len(calls) - 1) % 5].to(device)

        def loss(model, ids, labels):
            return tgpt.GPTPretrainingCriterion()(model(ids), labels)

        ids = torch.randint(0, 128, (2, 32), generator=gen)
        labels = torch.roll(ids, -1, 1)
        losses = []
        orig = trng.keep_mask
        trng.keep_mask = replay
        try:
            for model, dev in ((card_model, None), (cpu_model, 'cpu')):
                calls.clear()
                # SGD: Adam would step a noise-level gradient (the key
                # bias's, exactly 0 in exact arithmetic) by ~lr either way
                opt = topt.SGD(0.1, grad_clip=tnn.ClipGradByGlobalNorm(1.0))
                step = tjit.TrainStep(model, loss, opt, device=dev)
                assert step.use_buckets
                _build.reset_launches()
                losses.append(float(step(ids, labels)))
                snap = _build.routes_snapshot()
                nb = len(step.layout.buckets)
                if dev is None:
                    assert snap['grad_stats'] == nb
                    assert snap['optimizer_step'] == 1     # all nb
                    assert snap['dropout_add'] == snap['dropout_add_bwd'] == 4
                    for n, p in model.named_parameters():
                        s = step.layout.slots[n]
                        base = step._flat_grads[s.bucket]
                        assert p.grad.data_ptr() == base.data_ptr() + \
                            s.offset * base.element_size()
                        assert p.data_ptr() == \
                            step._flat_params[s.bucket].data_ptr() + \
                            s.offset * base.element_size()
        finally:
            trng.keep_mask = orig
        assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
        cpu = dict(cpu_model.named_parameters())
        for n, p in card_model.named_parameters():
            torch.testing.assert_close(p.detach().cpu(), cpu[n].detach(),
                                       rtol=1e-4, atol=1e-5)

    def test_attention_dropout_train_step_on_card(self, cuda):
        """GPTConfig's default dropouts (hidden and attention 0.1) at
        L = 512 on the card: the BHLD flash kernels launch once a layer a
        step each, and two default TrainSteps match the CPU's from the
        same weights and masks (fp32, SGD, rtol 1e-4)."""
        from paddle_tpu_torch import jit as tjit
        from paddle_tpu_torch.core import rng as trng
        from paddle_tpu_torch.models import gpt as tgpt

        cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
                   max_seq_len=512, hidden_dropout=0.1, attn_dropout=0.1)
        gen = torch.Generator().manual_seed(1)
        cpu_model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), generator=gen)
        card_model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
        card_model.load_state_dict(cpu_model.state_dict())
        recorded, replayed = [], []
        draw = trng.keep_mask

        def record(shape, keep_prob, device):
            m = draw(shape, keep_prob, device)
            recorded.append(m.cpu())
            return m

        def replay(shape, keep_prob, device):
            replayed.append(recorded[len(replayed)])
            return replayed[-1].to(device)

        def loss(model, ids, labels):
            return tgpt.GPTPretrainingCriterion()(model(ids), labels)

        ids = torch.randint(0, 128, (2, 512), generator=gen)
        labels = torch.roll(ids, -1, 1)
        losses = {}
        try:
            for model, dev, fn in ((card_model, None, record),
                                   (cpu_model, 'cpu', replay)):
                trng.keep_mask = fn
                step = tjit.TrainStep(model, loss, topt.SGD(0.1), device=dev)
                _build.reset_launches()
                losses[dev] = [float(step(ids, labels)) for _ in range(2)]
                if dev is None:
                    snap = _build.routes_snapshot()
                    for name in ('flash_bhld_fwd', 'flash_bhld_bwd_dq',
                                 'flash_bhld_bwd_dkv'):
                        assert snap[name] == 2 * 2, name
                    assert snap['flash_fwd'] == 0
        finally:
            trng.keep_mask = draw
        assert len(replayed) == len(recorded) == 2 * (1 + 3 * 2)
        torch.testing.assert_close(torch.tensor(losses[None]),
                                   torch.tensor(losses['cpu']), rtol=1e-4,
                                   atol=0)
        cpu = dict(cpu_model.named_parameters())
        for n, p in card_model.named_parameters():
            torch.testing.assert_close(p.detach().cpu(), cpu[n].detach(),
                                       rtol=1e-4, atol=1e-5)


# the BERT leg's shapes (bench.py:276-303): 64 x 512 tokens, hidden 768,
# FFN 3072, 12 heads of 64
BERT_ROWS, BERT_HIDDEN, BERT_FFN = 64 * 512, 768, 3072


@pytest.mark.cuda
class TestBertOnCard:
    @pytest.mark.parametrize('with_bias', [False, True],
                             ids=['no_bias', 'key_bias'])
    def test_packed_flash_d64_non_causal(self, cuda, with_bias):
        """Rows 8-10 as the BERT leg runs them: packed [B, L, 12 x 64]
        bf16, non-causal, with and without a [B, L] key bias, forward
        (FLASH_BF16) and gradients (FLASH_BF16_TC) against the plain
        versions; the inputs also as the projections' [B, L, 12, 64]
        views through `mha_flash_attention_blhd`, and one input a view
        off 16-byte alignment (the wrapper copies it)."""
        gen = torch.Generator(device=cuda).manual_seed(21)
        B, L, H, D = 8, 512, 12, 64
        q, k, v, do = (torch.randn(B, L, H * D, generator=gen, device=cuda)
                       .to(torch.bfloat16) for _ in range(4))
        bias = None
        if with_bias:
            keep = torch.arange(L, device=cuda)[None, :] < torch.randint(
                384, L + 1, (B, 1), generator=gen, device=cuda)
            bias = torch.where(keep, 0.0, -1e9).float()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = tfa.mha_flash_attention_blhd(
            *(t.view(B, L, H, D) for t in leaves), key_bias=bias)
        o.backward(do.view(B, L, H, D))
        o_p, lse_p = tfa.flash_attention_packed_plain(q, k, v, H, D, bias,
                                                      False)
        assert_flash_bf16_tc(o.reshape(B, L, H * D), o_p, FLASH_BF16)
        want = tfa.flash_attention_packed_bwd_plain(q, k, v, o_p, lse_p, do,
                                                    H, D, bias, False)
        for leaf, w in zip(leaves, want):
            assert_flash_bf16_tc(leaf.grad, w)
        buf = torch.empty(B * L * H * D + 1, device=cuda,
                          dtype=torch.bfloat16)
        q_off = buf[1:].view(B, L, H * D)
        q_off.copy_(q)
        assert q_off.data_ptr() % 16
        o_off = tfa.flash_attention_packed(q_off, k, v, H, D, bias=bias)
        assert torch.equal(o_off, o.detach().reshape(B, L, H * D))

    def test_erf_bias_gelu_at_bert_shape(self, cuda):
        gen = torch.Generator(device=cuda).manual_seed(22)
        x, dy = (torch.randn(BERT_ROWS, BERT_FFN, generator=gen,
                             device=cuda).to(torch.bfloat16)
                 for _ in range(2))
        b = (0.1 * torch.randn(BERT_FFN, generator=gen, device=cuda)).to(
            torch.bfloat16)
        torch.testing.assert_close(tfe.bias_gelu(x, b, False).float(),
                                   tfe.bias_gelu_plain(x, b, False).float(),
                                   **BF16_ELEMENTWISE)
        dx, db = tfe.bias_gelu_bwd(x, b, dy, False)
        dx_p, db_p = tfe.bias_gelu_bwd_plain(x, b, dy, False)
        torch.testing.assert_close(dx.float(), dx_p.float(),
                                   **BF16_ELEMENTWISE)
        torch.testing.assert_close(db.float(), db_p.float(), **FP32_SUMS)

    def test_layer_norm_at_bert_shape(self, cuda):
        gen = torch.Generator(device=cuda).manual_seed(23)
        x, dy = (torch.randn(BERT_ROWS, BERT_HIDDEN, generator=gen,
                             device=cuda).to(torch.bfloat16)
                 for _ in range(2))
        w = (1 + 0.1 * torch.randn(BERT_HIDDEN, generator=gen,
                                   device=cuda)).to(torch.bfloat16)
        b = (0.1 * torch.randn(BERT_HIDDEN, generator=gen, device=cuda)).to(
            torch.bfloat16)
        y, mean, rstd = tfn._fwd_kernel(x, w, b, 1e-12, True)
        y_p, mean_p, rstd_p = tfn.layer_norm_fwd_plain(x, w, b, 1e-12)
        torch.testing.assert_close(y.float(), y_p.float(), **BF16_ELEMENTWISE)
        torch.testing.assert_close(mean, mean_p, **FP32_SUMS)
        torch.testing.assert_close(rstd, rstd_p, **FP32_SUMS)
        got = tfn.layer_norm_bwd(x, w, dy, mean, rstd)
        want = tfn.layer_norm_bwd_plain(x, w, dy, mean, rstd)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   **BF16_ELEMENTWISE)
        for g, wt in zip(got[1:], want[1:]):
            torch.testing.assert_close(g.float(), wt.float(), **FP32_SUMS)

    def test_hybrid_engine_update_is_the_plain_chain(self, cuda):
        """HybridParallelTrainStep's per-parameter update (one update
        kernel launch for all the parameters) on bf16 parameters with
        fp32 masters
        and moments, under the global-norm clip: bit-equal to the plain
        chain from the same parameters, states and gradients."""
        from paddle_tpu_torch import nn as tnn
        from paddle_tpu_torch.distributed import topology_runtime as ttr
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            hybrid_engine as the)
        from paddle_tpu_torch.models import bert as tbert

        ttr.build_mesh(['dp', 'sharding'], [1, 1])
        cfg = tbert.BertConfig(vocab_size=512, hidden_size=128,
                               num_layers=2, num_heads=2,
                               intermediate_size=512, max_seq_len=64,
                               hidden_dropout=0.0, attn_dropout=0.0)
        gen = torch.Generator(device=cuda).manual_seed(24)
        model = tbert.BertForPretraining(cfg, device=cuda,
                                         dtype=torch.bfloat16, generator=gen)
        opt = topt.AdamW(1e-3, weight_decay=0.01,
                         grad_clip=tnn.ClipGradByGlobalNorm(0.5))

        def loss(m, ids, nsp):
            return m(ids, masked_lm_labels=ids, next_sentence_label=nsp)
        eng = the.HybridParallelTrainStep(model, loss, opt)
        ids = torch.randint(0, 512, (4, 64), generator=gen, device=cuda)
        nsp = torch.randint(0, 2, (4,), generator=gen, device=cuda)
        eng(ids, nsp)                      # states past their first step
        before = [(p.detach().clone(),
                   {k: v.clone() for k, v in eng._states[n].items()})
                  for n, p in eng._named]
        _build.reset_launches()
        eng(ids, nsp)
        assert _build.routes_snapshot()['optimizer_step'] == 1
        grads = [p.grad for _, p in eng._named]
        factor = eng._clip_factor(grads)
        lr = torch.tensor(1e-3, device=cuda)
        for (n, p), (p0, st0), g in zip(eng._named, before, grads):
            want_p, want_s = tfo.fused_shard_update_plain(
                opt, p0, g, st0, lr, prefactor=factor, round_prefactor=True)
            assert 'master' in want_s, n
            assert torch.equal(p.detach(), want_p), n
            for k, v in want_s.items():
                assert torch.equal(eng._states[n][k], v), (n, k)


def _tier_pool(cuda, dtype, num_pages=64, page_size=16, host_pages=96,
               **tier_kw):
    from paddle_tpu_torch.serving import KVPagePool
    from paddle_tpu_torch.serving.host_tier import HostTier
    pool = KVPagePool(num_pages=num_pages, page_size=page_size,
                      num_layers=2, num_heads=4, head_dim=64, dtype=dtype,
                      prefix_cache=True)
    pool.materialize(cuda)
    gen = torch.Generator(device=cuda).manual_seed(17)
    for layer in pool.kv:
        for b in layer:
            if b.dtype == torch.int8:
                b.copy_(torch.randint(-128, 128, b.shape, device=cuda,
                                      generator=gen, dtype=torch.int8))
            else:
                b.copy_(torch.randn(b.shape, device=cuda, generator=gen)
                        .to(b.dtype))
    pool.attach_host_tier(HostTier(host_pages, **tier_kw))
    return pool


def _park(pool, seq, toks):
    pool.ensure_capacity(seq, len(toks))
    pool.register_prefix(seq, toks, written=len(toks))
    pool.release(seq)


@pytest.mark.cuda
class TestHostTierOnCard:
    """The pinned host tier on the card: pinned buffers and a copy stream,
    rows back bit for bit (bf16, and int8 with their fp32 scales)."""

    @pytest.mark.parametrize('dtype', [torch.bfloat16, 'int8'])
    def test_round_trip_under_concurrent_writes(self, cuda, dtype):
        # spills run on the copy stream while the compute stream keeps
        # writing OTHER pages; the fetched rows equal the rows spilled
        pool = _tier_pool(cuda, dtype, chunk_pages=8)
        toks = list(range(1000, 1000 + 40 * 16))           # 40 pages
        _park(pool, 'a', toks)
        spilled = pool._match_pages(toks)
        want = [[b[spilled].clone() for b in layer] for layer in pool.kv]
        pool.ensure_capacity('busy', 8 * 16)
        busy = torch.as_tensor(pool.page_table('busy'), device=cuda)
        assert pool.spill_lru(max_pages=40) == 40          # async
        for i in range(50):
            for layer in pool.kv:
                for b in layer:
                    b.index_fill_(0, busy, i % 7)
        pool.host_tier.drain()
        assert all(b.is_pinned() for layer in pool.host_tier._buffers
                   for b in layer)
        assert pool.host_tier._copy_stream is not None
        for layer in pool.kv:                  # the device copies go stale
            for b in layer:
                b[:pool.num_pages].index_fill_(
                    0, torch.as_tensor(spilled, device=cuda), 3)
        pool.release('busy')
        got = pool.match_and_map('b', toks + [1], limit=len(toks))
        assert got == len(toks)
        pages = pool.page_table('b')
        for lw, layer in zip(want, pool.kv):
            for w, b in zip(lw, layer):
                assert torch.equal(b[pages], w)
        pool.host_tier.shutdown()

    def test_fetch_races_inflight_spill(self, cuda):
        # a resurrect of the very slots whose spill is still in flight
        # waits for it to land, then reads the landed rows
        pool = _tier_pool(cuda, torch.bfloat16, window=1)
        toks = list(range(5000, 5000 + 24 * 16))
        _park(pool, 'a', toks)
        spilled = pool._match_pages(toks)
        want = [[b[spilled].clone() for b in layer] for layer in pool.kv]
        assert pool.spill_lru() == 24                      # async
        got = pool.match_and_map('b', toks + [1], limit=len(toks))
        assert got == len(toks)
        pages = pool.page_table('b')
        for lw, layer in zip(want, pool.kv):
            for w, b in zip(lw, layer):
                assert torch.equal(b[pages], w)
        st = pool.stats()
        assert st['tier_spilled_pages_total'] == 24
        assert st['tier_fetched_pages_total'] == 24
        pool.release('b')
        pool.host_tier.shutdown()


class _RecordingClient:
    """A PS client double: pull gives rows of the ids' values, push keeps
    what reached it (host arrays)."""

    def __init__(self):
        self.pushed = []

    def pull(self, tid, ids, dim):
        return np.repeat(np.asarray(ids, np.float32)[:, None], dim, 1)

    def push(self, tid, ids, grads, lr):
        self.pushed.append((np.array(ids), np.array(grads)))


@pytest.mark.cuda
class TestPsCommunicatorOnCard:
    """AsyncCommunicator's two stream hand-offs on the card."""

    def test_device_put_on_the_copy_stream(self, cuda):
        from paddle_tpu_torch.distributed.ps.communicator import (
            AsyncCommunicator)
        comm = AsyncCommunicator(
            _RecordingClient(), 0, 8, depth=2,
            device_put=lambda r: torch.from_numpy(r).pin_memory().to(
                cuda, non_blocking=True))
        batches = [np.arange(i * 50_000, (i + 1) * 50_000) for i in range(6)]
        for ids, rows in comm.pull_ahead(batches):
            assert rows.is_cuda
            want = torch.from_numpy(ids.astype(np.float32))[:, None]
            assert torch.equal((rows + 0).cpu(), want.expand(-1, 8))
        assert comm._copy_stream is not None
        comm.stop()

    def test_push_async_reads_a_card_gradient_after_its_stream(self, cuda):
        from paddle_tpu_torch.distributed.ps.communicator import (
            AsyncCommunicator)
        client = _RecordingClient()
        comm = AsyncCommunicator(client, 0, 8, depth=2)
        g = np.random.RandomState(0).randn(3, 4096, 8).astype(np.float32)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            for k in range(3):
                g_dev = torch.zeros(4096, 8, device=cuda)
                torch.cuda._sleep(20_000_000)     # the write lands late
                g_dev.copy_(torch.from_numpy(g[k]).to(cuda))
                comm.push_async(np.arange(4096), g_dev, 0.1)
        comm.flush()
        assert [p[1].tobytes() for p in client.pushed] == [
            g[k].tobytes() for k in range(3)]
        comm.stop()
