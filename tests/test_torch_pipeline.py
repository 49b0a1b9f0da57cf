"""paddle_tpu_torch's SpmdPipelineEngine at pp = 1 against
`paddle_tpu`'s, GPTLMHead and fused_linear_cross_entropy against JAX's,
the schedule's pure helpers, train_step and the engine's refusals.

The engine cases: a tiny GPT (vocab 128, hidden 64, 2 layers, 2 heads,
dropout 0) built by the JAX `build_gpt_pipeline` and bridged into the
port's triple (`load_jax_pipeline_params`); the JAX engine runs on mesh
['dp', 'pp'] = [1, 1] (as tests/test_remat.py does). Both take 3
`train_batch` calls of A = 4 micro-batches of 2 rows, L = 64 on the
dense attention route and L = 512 on the flash route, with `use_remat`
on (the bench's engine). Tolerances:
- SGD and Adam, fp32, either accumulator dtype: losses and parameters at
  rtol 2e-4 / atol 2e-5 (summation order);
- AdamW with bf16 parameters, bf16 moments, no master and 'param'
  accumulation (the bench's headline): the bf16 case of
  tests/test_torch_train.py, `_check_bf16_update` and losses at rtol
  2^-8.
fused_linear_cross_entropy: loss, dx and dw against JAX's at rtol 2e-4 /
atol 2e-5 (fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.fleet as jfleet
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import topology_runtime
from paddle_tpu.distributed.fleet.meta_parallel import spmd_pipeline as jsp
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import nn_ops as jF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import async_step as tasync
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    spmd_pipeline as tsp)
from paddle_tpu_torch.models import (gpt as tgpt, load_jax_pipeline_params,
                                     pipeline_params_as_stacked)
from paddle_tpu_torch.ops import nn_ops as tF
from test_torch_train import _check_bf16_update
from torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=512, hidden_dropout=0.0, attn_dropout=0.0,
            use_flash_attention=True)
ROUTE_L = {'dense': 64, 'flash': 512}
A, MB, STEPS, LR = 4, 2, 3, 1e-3
FP32 = dict(rtol=2e-4, atol=2e-5)
GROUPS = ('embed', 'blocks', 'head')


def _jax_triple(seed=3, bf16=False):
    jfleet.fleet._hcg = None
    jfleet.fleet._user_defined_strategy = None
    topology_runtime.build_mesh(['dp', 'pp'], [1, 1])
    paddle.seed(seed)
    triple = jgpt.build_gpt_pipeline(jgpt.GPTConfig(**TINY))
    if bf16:
        for layer in [triple[0], triple[2]] + triple[1]:
            for p in layer.parameters():
                p.data = p.data.astype(jnp.bfloat16)
    return triple


def _arrays(embed, blocks, head):
    def host(layer):
        return {n: np.asarray(p.data) for n, p in layer.named_parameters()}
    return {'embed': host(embed), 'blocks': [host(b) for b in blocks],
            'head': host(head)}


def _port_triple(arrays, dtype=None):
    triple = tgpt.build_gpt_pipeline(tgpt.GPTConfig(**TINY), dtype=dtype)
    return load_jax_pipeline_params(*triple, arrays)


def _optimizers(kind):
    kw = dict(learning_rate=LR)
    if kind == 'sgd':
        return paddle.optimizer.SGD(parameters=[], **kw), topt.SGD(**kw)
    kw['weight_decay'] = 0.01
    if kind == 'adam':
        return paddle.optimizer.Adam(parameters=[], **kw), topt.Adam(**kw)
    kw.update(multi_precision=False, moment_dtype='bfloat16')
    return paddle.optimizer.AdamW(parameters=[], **kw), topt.AdamW(**kw)


def _batch(L, seed=0):
    ids = np.random.RandomState(seed).randint(
        0, TINY['vocab_size'], (A * MB, L)).astype('int32')
    return ids, np.roll(ids, -1, 1).astype('int32')


def _flat(stacked):
    """{group/name or blocks/i/name: fp32 array} from stacked trees."""
    out = {}
    for g in GROUPS:
        for n, a in stacked[g].items():
            a = np.asarray(a)
            if g == 'blocks':
                for i in range(a.shape[0]):
                    out[f'blocks/{i}/{n}'] = a[i]
            else:
                out[f'{g}/{n}'] = a
    return out


def _jax_states(jeng):
    out = {}
    for g in GROUPS:
        for n, st in jeng._states[g].items():
            if g == 'blocks':
                for i in range(TINY['num_layers']):
                    out[f'blocks/{i}/{n}'] = {
                        k: np.asarray(v)[i] if np.ndim(v) else np.asarray(v)
                        for k, v in st.items()}
            else:
                out[f'{g}/{n}'] = {k: np.asarray(v) for k, v in st.items()}
    return out


CASES = [('sgd', 'param'), ('sgd', 'float32'), ('adam', 'float32'),
         ('adamw_bf16', 'param')]


@pytest.mark.parametrize('route', ['dense', 'flash'])
@pytest.mark.parametrize('kind,accum', CASES,
                         ids=[f'{k}-{a}' for k, a in CASES])
def test_engine_matches_jax_engine(kind, accum, route):
    bf16 = kind == 'adamw_bf16'
    je, jb, jh = _jax_triple(bf16=bf16)
    arrays = _arrays(je, jb, jh)
    te, tb, th = _port_triple(arrays, torch.bfloat16 if bf16 else None)
    jopt, popt = _optimizers(kind)
    jeng = jsp.SpmdPipelineEngine(je, jb, jh, jopt, accumulate_steps=A,
                                  use_remat=True, schedule='1F1B',
                                  grad_accum_dtype=accum)
    teng = tsp.SpmdPipelineEngine(te, tb, th, popt, accumulate_steps=A,
                                  use_remat=True, schedule='1F1B',
                                  grad_accum_dtype=accum, device='cpu')
    assert teng._block_fn is not teng._block_apply      # 'full' per block
    ids, labels = _batch(ROUTE_L[route])
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jeng.train_batch((Tensor(ids), Tensor(labels)))))
        loss = teng.train_batch((ids, labels))
        assert loss.dtype == torch.float32 and loss.dim() == 0
        tl.append(float(loss))
    jp = {k: np.asarray(v, np.float32)
          for k, v in _flat(jeng._params).items()}
    jstates = _jax_states(jeng)
    jeng.shutdown()
    tp = _flat(pipeline_params_as_stacked(te, tb, th))
    assert set(tp) == set(jp)
    assert tl[-1] < tl[0]
    if not bf16:
        np.testing.assert_allclose(tl, jl, **FP32)
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **FP32)
        return
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8)
    before = _flat({'embed': arrays['embed'], 'head': arrays['head'],
                    'blocks': {n: np.stack([b[n] for b in arrays['blocks']])
                               for n in arrays['blocks'][0]}})
    tstates = teng.named_opt_states()
    _check_bf16_update(jp, tp, before, jstates, tstates)


# ---------------------------------------------------------------------------
# the pure helpers against the reference's outputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('layers,pp,v', [(4, 1, 1), (8, 2, 2), (12, 2, 3),
                                         (24, 4, 2), (6, 3, 1)])
def test_chunk_layer_order_matches_reference(layers, pp, v):
    assert tsp.chunk_layer_order(layers, pp, v) == \
        jsp.chunk_layer_order(layers, pp, v)


@pytest.mark.parametrize('layers,pp,v', [(6, 4, 1), (4, 2, 4), (10, 4, 2)])
def test_chunk_layer_order_rejects_uneven(layers, pp, v):
    with pytest.raises(jsp.PipelineScheduleError) as want:
        jsp.chunk_layer_order(layers, pp, v)
    with pytest.raises(tsp.PipelineScheduleError) as got:
        tsp.chunk_layer_order(layers, pp, v)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('schedule,pp,A,v,mode', [
    ('1F1B', 1, 4, 1, 'stash'), ('1F1B', 2, 8, 1, None),
    ('F-then-B', 4, 8, 1, 'stash'), ('FThenB', 2, 3, 1, None),
    ('interleaved', 2, 8, 2, 'recompute'), ('interleaved', 4, 8, 3, None)])
def test_schedule_model_matches_reference(schedule, pp, A, v, mode):
    assert tsp.schedule_model(schedule, pp, A, v, memory_mode=mode) == \
        jsp.schedule_model(schedule, pp, A, v, memory_mode=mode)


@pytest.mark.parametrize('kw,env', [({}, None), ({'virtual_stages': 3}, '2'),
                                    ({}, '4'), ({'from_layer': 2}, None),
                                    ({'from_layer': 2}, '5')])
def test_resolve_virtual_stages_matches_reference(kw, env, monkeypatch):
    if env is None:
        monkeypatch.delenv('PTPU_PP_VIRTUAL', raising=False)
    else:
        monkeypatch.setenv('PTPU_PP_VIRTUAL', env)
    assert tsp.resolve_virtual_stages(**kw) == \
        jsp.resolve_virtual_stages(**kw)


def test_resolve_virtual_stages_bad_env(monkeypatch):
    monkeypatch.setenv('PTPU_PP_VIRTUAL', 'two')
    with pytest.raises(tsp.PipelineScheduleError, match='not an integer'):
        tsp.resolve_virtual_stages()


# ---------------------------------------------------------------------------
# train_step, the window and the engine's refusals
# ---------------------------------------------------------------------------
def _port_engine(seed=3, **kw):
    te, tb, th = tgpt.build_gpt_pipeline(
        tgpt.GPTConfig(**TINY), generator=torch.Generator().manual_seed(seed))
    kw.setdefault('device', 'cpu')
    opt = kw.pop('optimizer', None) or topt.AdamW(learning_rate=LR)
    return tsp.SpmdPipelineEngine(te, tb, th, opt, accumulate_steps=A, **kw)


def test_train_step_then_flush_equals_train_batch():
    ids, labels = _batch(64)
    sync = _port_engine(use_remat=True)
    want = [float(sync.train_batch((ids, labels))) for _ in range(STEPS)]
    eng = _port_engine(use_remat=True, dispatch_window=2)
    results = [eng.train_step((ids, labels)) for _ in range(STEPS)]
    assert all(isinstance(r, tasync.AsyncResult) for r in results)
    assert results[0].done() and not results[-1].done()   # window of 2
    assert results[-1].loss.dtype == torch.float32
    drained = eng.flush()
    assert drained == results[1:] and all(r.done() for r in results)
    assert [float(r) for r in results] == want
    for p, q in zip(sync.head.parameters(), eng.head.parameters()):
        assert torch.equal(p, q)
    # train_batch after queued steps drains them first
    eng.train_step((ids, labels))
    assert len(eng._inflight) == 1
    eng.train_batch((ids, labels))
    assert len(eng._inflight) == 0
    eng.sync_model()
    eng.shutdown()
    with pytest.raises(RuntimeError, match='shut down'):
        eng.train_batch((ids, labels))


def test_dispatch_window_resolution(monkeypatch):
    monkeypatch.delenv('PTPU_DISPATCH_WINDOW', raising=False)
    assert tasync.resolve_dispatch_window() == 2
    assert tasync.resolve_dispatch_window(0) == 1
    monkeypatch.setenv('PTPU_DISPATCH_WINDOW', '5')
    assert tasync.resolve_dispatch_window() == 5
    assert tasync.resolve_dispatch_window(3) == 3


class _Mesh:
    def __init__(self, **shape):
        self.shape = shape


REFUSED = {
    'mesh-pp2': dict(mesh=_Mesh(dp=1, pp=2)),
    'mesh-dp2': dict(mesh=_Mesh(dp=2, pp=1)),
    'interleaved': dict(schedule='interleaved'),
    'f-then-b': dict(schedule='F-then-B'),
    'virtual-stages': dict(virtual_stages=2),
    'memory-recompute': dict(memory_mode='recompute'),
    'use-buckets': dict(use_buckets=True),
    'comm-dtype': dict(comm_dtype='bfloat16'),
    'bucket-mb': dict(bucket_mb=8),
    'comm-block': dict(comm_block=256),
    'comm-overlap': dict(comm_overlap=True),
    'prefetch-depth': dict(prefetch_depth=2),
    'comm-chunk': dict(comm_chunk=1024),
    'grad-clip': dict(optimizer=topt.AdamW(
        learning_rate=LR, grad_clip=tnn.ClipGradByGlobalNorm(1.0))),
}


@pytest.mark.parametrize('kw', list(REFUSED.values()), ids=list(REFUSED))
def test_engine_refuses_unported_knobs(kw):
    with pytest.raises(NotImplementedError, match='not ported yet'):
        _port_engine(**kw)


def test_engine_takes_every_knob_at_its_default():
    eng = _port_engine(mesh=_Mesh(dp=1, pp=1), use_buckets=False,
                       comm_overlap=False, device_lr=False, virtual_stages=1,
                       grad_accum_dtype='param', dispatch_window=1)
    assert eng.grad_accum_dtype == 'param' and eng._inflight.size == 1


@pytest.mark.parametrize('kw,match', [
    (dict(schedule='GPipe'), 'unknown pipeline schedule'),
    (dict(memory_mode='swap'), 'memory_mode'),
    (dict(grad_accum_dtype='bfloat16'), 'grad_accum_dtype'),
    (dict(virtual_stages=0), 'virtual_stages must be')])
def test_engine_rejects_bad_values(kw, match):
    with pytest.raises(ValueError, match=match):
        _port_engine(**kw)


@pytest.mark.parametrize('rows,label_rows,match', [
    (6, 6, 'not divisible'), (8, 4, 'disagree'), (0, 0, 'not divisible')])
def test_bad_batch_raises_pipeline_batch_error(rows, label_rows, match):
    eng = _port_engine()
    ids = np.zeros((rows, 64), np.int32)
    with pytest.raises(tsp.PipelineBatchError, match=match):
        eng.train_batch((ids, np.zeros((label_rows, 64), np.int32)))


def test_engine_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _port_engine(device=None)


def test_bridge_takes_stacked_trees_and_checks_them():
    je, jb, jh = _jax_triple()
    arrays = _arrays(je, jb, jh)
    stacked = {'embed': arrays['embed'], 'head': arrays['head'],
               'blocks': {n: np.stack([b[n] for b in arrays['blocks']])
                          for n in arrays['blocks'][0]}}
    triple = _port_triple(arrays)
    again = tgpt.build_gpt_pipeline(tgpt.GPTConfig(**TINY))
    load_jax_pipeline_params(*again, stacked)
    for a, b in zip(pipeline_params_as_stacked(*triple)['blocks'].values(),
                    pipeline_params_as_stacked(*again)['blocks'].values()):
        np.testing.assert_array_equal(a, b)
    short = dict(stacked, blocks={n: a[:1] for n, a in
                                  stacked['blocks'].items()})
    with pytest.raises(ValueError, match='stacked rows'):
        load_jax_pipeline_params(*again, short)
    with pytest.raises(KeyError, match='missing'):
        load_jax_pipeline_params(*again, dict(stacked, head={}))


# ---------------------------------------------------------------------------
# fused_linear_cross_entropy and GPTLMHead
# ---------------------------------------------------------------------------
def _xent_inputs(N, H, V, transpose_y, seed=0, ignore=()):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H).astype(np.float32)
    w = (0.3 * rng.randn(*((V, H) if transpose_y else (H, V)))).astype(
        np.float32)
    lab = rng.randint(0, V, (N,)).astype(np.int32)
    lab[list(ignore)] = -100
    return x, w, lab


def _jax_xent(x, w, lab, **kw):
    def f(xa, wa):
        return jF.fused_linear_cross_entropy(
            Tensor(xa), Tensor(wa), Tensor(jnp.asarray(lab)), **kw).data
    (loss, vjp) = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.ones_like(loss))
    return np.asarray(loss), np.asarray(dx), np.asarray(dw)


def _port_xent(x, w, lab, **kw):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = tF.fused_linear_cross_entropy(xt, wt, torch.tensor(lab), **kw)
    assert loss.dtype == torch.float32
    loss.backward(torch.ones_like(loss))
    return loss.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize('transpose_y', [True, False])
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_fused_linear_cross_entropy_matches_jax(transpose_y, reduction):
    x, w, lab = _xent_inputs(48, 32, 96, transpose_y, ignore=(3, 17))
    kw = dict(transpose_y=transpose_y, reduction=reduction)
    for got, want in zip(_port_xent(x, w, lab, **kw),
                         _jax_xent(x, w, lab, **kw)):
        np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize('chunks', [5, 7, 48, 64])
def test_fused_linear_cross_entropy_chunks_step_down(chunks):
    """48 rows: 5 steps down to 4, 7 to 6, 64 to 48 (one row a chunk)."""
    x, w, lab = _xent_inputs(48, 16, 40, False, seed=1, ignore=(0,))
    kw = dict(transpose_y=False, chunks=chunks, ignore_index=-100)
    want = _jax_xent(x, w, lab, **kw)
    for got, ref in zip(_port_xent(x, w, lab, **kw), want):
        np.testing.assert_allclose(got, ref, **FP32)


def test_fused_linear_cross_entropy_leading_dims_and_ignore_index():
    x, w, lab = _xent_inputs(24, 16, 30, True, seed=2)
    lab[[1, 5]] = 7
    kw = dict(ignore_index=7, reduction='none')
    got = _port_xent(x.reshape(2, 12, 16), w, lab.reshape(2, 12), **kw)
    want = _jax_xent(x.reshape(2, 12, 16), w, lab.reshape(2, 12), **kw)
    assert got[0].shape == (2, 12) and got[0][0, 1] == 0.0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FP32)


@pytest.mark.parametrize('branch', ['plain', 'fused'])
def test_gpt_lm_head_matches_jax(branch, monkeypatch):
    """The port's head on each side of its switch against the JAX head
    (its plain branch at this size: tokens x vocab is below 2^28)."""
    if branch == 'fused':
        monkeypatch.setattr(tgpt, 'FUSED_HEAD_MIN_LOGITS', 0)
        calls = []
        fused = tF.fused_linear_cross_entropy
        monkeypatch.setattr(tF, 'fused_linear_cross_entropy',
                            lambda *a, **k: calls.append(1) or fused(*a, **k))
    assert tgpt.FUSED_HEAD_MIN_LOGITS == (0 if branch == 'fused'
                                          else 2 ** 28)
    paddle.seed(5)
    jh = jgpt.GPTLMHead(jgpt.GPTConfig(**TINY))
    th = tgpt.GPTLMHead(tgpt.GPTConfig(**TINY))
    from paddle_tpu_torch.models import load_jax_params
    load_jax_params(th, {n: np.asarray(p.data)
                         for n, p in jh.named_parameters()})
    assert [n for n, _ in th.named_parameters()] == \
        ['norm.weight', 'norm.bias', 'out.weight']
    rng = np.random.RandomState(4)
    hidden = rng.randn(2, 16, 64).astype(np.float32)
    labels = rng.randint(0, 128, (2, 16)).astype(np.int32)
    jparams = {n: p.data for n, p in jh.named_parameters()}

    def jloss(ps, h):
        from paddle_tpu.jit import bind_arrays
        with bind_arrays(jh, ps):
            return jh(Tensor(h), Tensor(jnp.asarray(labels))).data
    loss, (gp, gh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jparams, jnp.asarray(hidden))
    ht = torch.tensor(hidden, requires_grad=True)
    tl = th(ht, torch.tensor(labels))
    tl.backward()
    if branch == 'fused':
        assert calls == [1]
    np.testing.assert_allclose(float(tl), float(loss), **FP32)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), **FP32)
    for n, p in th.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[n]),
                                   err_msg=n, **FP32)
