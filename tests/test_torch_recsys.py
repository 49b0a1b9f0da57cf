"""The port's recsys ops (`paddle_tpu_torch/ops/recsys.py`) against the
JAX package's on the same numpy-seeded inputs, at the bars of
tests/test_recsys_ops.py (rtol 1e-5; 1e-6 where it holds one), and
bit-equal where the op is host integer work (tdm_child, tdm_sampler's
draws, pyramid_hash's hashing, filter_by_instag). shuffle_batch draws its
permutation from a torch generator: it is held to be a permutation whose
gather and gradient match, and against the reference on the reference's
own permutation."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import recsys as R
from paddle_tpu_torch.ops import recsys as TR

RTOL = 1e-5


def _j(a):
    return Tensor(jnp.asarray(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.data)


def _jit_vjp(fn, dy, *args):
    """(fn(*args), its cotangents at dy), jitted as one program (eager
    JAX compiles every primitive on its own)."""
    def f(dy_, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(dy_)
    return jax.jit(f)(jnp.asarray(dy), *map(jnp.asarray, args))


TREE = np.array([[0, 0, 0, 0, 0], [0, 0, 0, 2, 3], [0, 1, 1, 4, 5],
                 [0, 1, 1, 6, 0], [9, 2, 2, 0, 0], [8, 2, 2, 0, 0],
                 [7, 2, 3, 0, 0]], np.int32)


def test_tdm_child_equals_reference():
    x = np.array([[1, 2, 3], [4, 0, 6]], np.int32)
    want = R.tdm_child(_j(x), _j(TREE), child_nums=2)
    got = TR.tdm_child(torch.from_numpy(x), TREE, child_nums=2)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize('case', ['layerwise', 'padding', 'no_positive'])
def test_tdm_sampler_equals_reference(case):
    travel = np.array([[0, 0], [1, 2], [1, 3], [1, 0]], np.int32)
    layer = np.array([1, 2, 3, 4, 5, 6], np.int32)
    kw = dict(neg_samples_num_list=[0, 2], layer_offset_lod=[0, 1, 6],
              output_positive=case != 'no_positive', seed=3)
    x = np.array([1, 2, 3] if case == 'padding' else [1, 2, 1], np.int32)
    want = R.tdm_sampler(_j(x), _j(travel), _j(layer), **kw)
    got = TR.tdm_sampler(torch.from_numpy(x), travel, layer, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    with pytest.raises(ValueError, match='distinct'):
        TR.tdm_sampler(np.array([1], np.int32), np.array([[0], [1]]),
                       np.array([1, 2]), neg_samples_num_list=[3],
                       layer_offset_lod=[0, 2])


@pytest.mark.parametrize('use_cvm', [True, False])
def test_cvm_forward_and_gradients(use_cvm):
    rng = np.random.RandomState(2)
    x = np.abs(rng.rand(4, 6)).astype(np.float32)
    cvm = rng.rand(4, 2).astype(np.float32)
    dy = rng.randn(4, 6 if use_cvm else 4).astype(np.float32)
    y, (gx, gc) = _jit_vjp(R._cvm_use if use_cvm else R._cvm_drop, dy,
                           x, cvm)
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(cvm).requires_grad_(True)
    out = TR.continuous_value_model(xt, ct, use_cvm=use_cvm)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(_np(out), np.asarray(y), rtol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), rtol=1e-6)
    np.testing.assert_array_equal(_np(ct.grad), np.asarray(gc))
    # the lead columns' dx is the CVM input (cvm_op.h:42)
    np.testing.assert_array_equal(_np(xt.grad)[:, :2], cvm)


def test_data_norm_and_update():
    rng = np.random.RandomState(3)
    x = rng.rand(8, 4).astype(np.float32) * 3
    stats = (np.full(4, 10.0, np.float32), rng.rand(4).astype(np.float32)
             * 10, np.full(4, 12.0, np.float32))
    want = R.data_norm(_j(x), *map(_j, stats))
    got = TR.data_norm(torch.from_numpy(x), *stats)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL)
    want = R.data_norm_update(_j(x), *map(_j, stats), summary_decay=0.99)
    got = TR.data_norm_update(x, *stats, summary_decay=0.99)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL)


@pytest.mark.parametrize('bias', [True, False])
def test_batch_fc(bias):
    rng = np.random.RandomState(4)
    x, w, b = (rng.rand(*s).astype(np.float32)
               for s in ((3, 5, 4), (3, 4, 2), (3, 2)))
    args = (x, w, b) if bias else (x, w)
    want = R.batch_fc(*map(_j, args))
    got = TR.batch_fc(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)


def test_rank_attention_forward_and_gradients():
    rng = np.random.RandomState(5)
    N, D, P, K = 4, 3, 2, 2
    x = rng.rand(N, D).astype(np.float32)
    param = rng.rand(K * K * D, P).astype(np.float32)
    ro = np.array([[1, 1, 0, 2, 1], [2, 1, 0, 0, 0], [0, 1, 2, 2, 3],
                   [2, 2, 3, 1, 2]], np.int32)
    dy = rng.randn(N, P).astype(np.float32)
    out, (gx, gp) = _jit_vjp(lambda a, p: R._rank_attention_arrays(
        a, p, jnp.asarray(ro), max_rank=K), dy, x, param)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(param).requires_grad_(True)
    got = TR.rank_attention(xt, ro, pt, max_rank=K)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(_np(got), np.asarray(out), rtol=RTOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), rtol=RTOL)
    np.testing.assert_allclose(_np(pt.grad), np.asarray(gp), rtol=RTOL)


@pytest.mark.parametrize('shape', [(8, 3), (2, 4, 3), (6,)])
def test_shuffle_batch_gathers_and_unshuffles(shape):
    rng = np.random.RandomState(6)
    x = rng.rand(*shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, idx = TR.shuffle_batch(xt, seed=4)
    lead = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
    flat = x.reshape(lead, -1) if len(shape) > 1 else x
    i = _np(idx)
    assert idx.dtype == torch.int32
    assert sorted(i.tolist()) == list(range(lead))
    np.testing.assert_array_equal(_np(out), flat[i].reshape(shape))
    # the same seed draws the same permutation; the gradient unshuffles
    assert torch.equal(TR.shuffle_batch(x, seed=4)[1], idx)
    dy = rng.randn(*shape).astype(np.float32)
    out.backward(torch.from_numpy(dy))
    dflat = dy.reshape(lead, -1) if len(shape) > 1 else dy
    back = np.zeros_like(dflat)
    back[i] = dflat
    np.testing.assert_array_equal(_np(xt.grad), back.reshape(shape))
    # the reference's own permutation through the port's gather
    ref_out, ref_idx = R.shuffle_batch(_j(x), seed=4)
    np.testing.assert_array_equal(
        _np(TR._shuffle_take(torch.from_numpy(x), _np(ref_idx))),
        _np(ref_out))


@pytest.mark.parametrize('lens', [False, True])
def test_match_matrix_tensor(lens):
    rng = np.random.RandomState(7)
    B, Lx, Ly, D, T = 2, 3, 4, 5, 2
    x, y, w = (rng.rand(*s).astype(np.float32)
               for s in ((B, Lx, D), (B, Ly, D), (D, T, D)))
    kw = dict(x_len=np.array([2, 3]), y_len=np.array([1, 4])) if lens \
        else {}
    want = R.match_matrix_tensor(_j(x), _j(y), _j(w),
                                 **{k: _j(v) for k, v in kw.items()})
    got = TR.match_matrix_tensor(x, y, w, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize('stride', [1, 2])
def test_var_conv_2d(stride):
    rng = np.random.RandomState(9)
    x = rng.rand(2, 2, 7, 6).astype(np.float32)
    w = rng.rand(3, 2 * 3 * 3).astype(np.float32)
    rl, cl = np.array([7, 4]), np.array([6, 3])
    want = R.var_conv_2d(_j(x), _j(w), 2, 3, 3, stride=stride,
                         row_lens=_j(rl), col_lens=_j(cl))
    got = TR.var_conv_2d(x, w, 2, 3, 3, stride=stride, row_lens=rl,
                         col_lens=cl)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=1e-6)
    plain = TR.var_conv_2d(x, w, 2, 3, 3, stride=stride)
    np.testing.assert_allclose(
        _np(plain), _np(R.var_conv_2d(_j(x), _j(w), 2, 3, 3,
                                      stride=stride)), rtol=RTOL, atol=1e-6)


def test_tree_conv_forward_and_filter_gradient():
    rng = np.random.RandomState(12)
    F, O, M = 2, 2, 2
    feats = rng.rand(2, 4, F).astype(np.float32)
    edges = np.array([[[1, 2], [1, 3], [2, 4]],
                      [[1, 2], [0, 0], [0, 0]]], np.int32)
    w = rng.rand(F, 3, O, M).astype(np.float32)
    want = R.tree_conv(_j(feats), _j(edges), _j(w), max_depth=2)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = TR.tree_conv(torch.from_numpy(feats), edges, wt, max_depth=2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)
    got.sum().backward()
    gw = jax.grad(lambda wa: R.tree_conv(
        _j(feats), _j(edges), Tensor(wa), max_depth=2).data.sum())(
            jnp.asarray(w))
    np.testing.assert_allclose(_np(wt.grad), np.asarray(gw), rtol=RTOL)


def test_pyramid_hash_forward_and_table_gradient():
    rng = np.random.RandomState(13)
    space, rand_len, num_emb = 64, 4, 8
    w = rng.rand(space + rand_len, 1).astype(np.float32)
    x = np.array([[3, 5, 7, 0], [1, 2, 3, 4]], np.int64)
    kw = dict(num_emb=num_emb, space_len=space, pyramid_layer=3,
              rand_len=rand_len, seed=1)
    want = R.pyramid_hash(_j(x), _j(w), seq_lens=_j(np.array([3, 4])),
                          **kw)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = TR.pyramid_hash(x, wt, seq_lens=np.array([3, 4]), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)
    got.sum().backward()
    gw = jax.grad(lambda wa: R.pyramid_hash(
        _j(x), Tensor(wa), seq_lens=_j(np.array([3, 4])),
        **kw).data.sum())(jnp.asarray(w))
    np.testing.assert_array_equal(_np(wt.grad), np.asarray(gw))


@pytest.mark.parametrize('filter_tag', [[2, 9], [42]])
def test_filter_by_instag(filter_tag):
    rng = np.random.RandomState(14)
    ins = rng.rand(5, 3).astype(np.float32)
    tags = np.array([[1, -1], [2, 3], [9, -1], [4, 2], [5, 6]], np.int64)
    want = R.filter_by_instag(_j(ins), _j(tags), _j(np.array(filter_tag)),
                              out_val_if_empty=-1)
    got = TR.filter_by_instag(ins, tags, np.array(filter_tag),
                              out_val_if_empty=-1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
