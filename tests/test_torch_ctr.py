"""The port's CTR training path on the CPU against the JAX package's:
DistributedEmbedding in its sync, async, geo and remote modes (pulled rows
and table rows after 3 pushes bit-equal over the same C++ table),
GeoCommunicator, DeepFM (bridged, at the fp32 bars rtol 2e-4 / atol 2e-5;
its PS form against its plain form; the port's copies of
tests/test_ssd_deepfm.py's TestDeepFM cases), WideDeep in the sync and
geo modes, fleet.metrics, metric and entry_attr; and the refusals.

The JAX models draw their initial weights from numpy (`numpy_draws`),
where jax.random would compile a sampler a shape, and the bridged
DeepFM's forward and backward run jitted through `bind_arrays`, as
tests/test_torch_vision_models.py runs the vision models; the values
are bridged, so both sides hold the same ones."""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import bind_arrays
from paddle_tpu.core import native as jnative
from paddle_tpu.distributed import entry_attr as jentry
from paddle_tpu.distributed.fleet import metrics as jfm
from paddle_tpu.distributed.ps import embedding as jemb
from paddle_tpu.distributed.ps.service import PsServer as JPsServer
from paddle_tpu import metric as jmetric
from paddle_tpu.models.deepfm import DeepFM as JDeepFM
from paddle_tpu.models.deepfm import deepfm_loss as jdeepfm_loss
from paddle_tpu.models.wide_deep import WideDeep as JWideDeep

from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import native as tnative
from paddle_tpu_torch.distributed import entry_attr as tentry
from paddle_tpu_torch.distributed.fleet import metrics as tfm
from paddle_tpu_torch.distributed.ps import embedding as temb
from paddle_tpu_torch.distributed.ps.service import PsServer as TPsServer
from paddle_tpu_torch.models import (DeepFM, WideDeep, bridge_ctr_params,
                                     deepfm_loss)

RTOL, ATOL = 2e-4, 2e-5          # both dense towers in fp32
CPU = 'cpu'


@contextlib.contextmanager
def numpy_draws(seed):
    """jax.random.uniform and .normal drawn by numpy (seeded)."""
    rng = np.random.RandomState(seed)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)
    with mock.patch.object(jax.random, 'uniform', uniform), \
            mock.patch.object(jax.random, 'normal', normal):
        yield


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.data)


def _ref_backward(out, ct):
    paddle.sum(out * Tensor(ct)).backward()


def _port_backward(out, ct):
    (out * torch.from_numpy(ct)).sum().backward()


@pytest.fixture
def communicators():
    yield
    jemb.global_communicator().stop()
    temb.global_communicator().stop()


def _layers(mode, dim=4):
    kw = dict(optimizer='adagrad', learning_rate=0.1, seed=3,
              num_shards=4)
    if mode == 'geo':
        kw.update(mode='geo', geo_k=2)
    elif mode == 'async':
        kw.update(a_sync=True)
    if mode != 'remote':
        return (jemb.DistributedEmbedding(dim, **kw),
                temb.DistributedEmbedding(dim, device=CPU, **kw), None)
    servers = []
    for cls in (JPsServer, TPsServer):
        srv = cls(host='127.0.0.1').start()
        srv.add_table(5, dim=dim, optimizer='adagrad', seed=3)
        servers.append(srv)
    kw = dict(learning_rate=0.1, table_id=5)
    return (jemb.DistributedEmbedding(
                dim, endpoints=[f'127.0.0.1:{servers[0].port}'], **kw),
            temb.DistributedEmbedding(
                dim, endpoints=[f'127.0.0.1:{servers[1].port}'],
                device=CPU, **kw), servers)


def _table_rows(layer, ids):
    table = layer.table
    if isinstance(table, (jemb.GeoCommunicator, temb.GeoCommunicator)):
        return table.local.pull(ids), table.remote.pull(ids)
    return (table.pull(ids),)


@pytest.mark.parametrize('mode', ['sync', 'async', 'geo', 'remote'])
def test_distributed_embedding_matches_reference(mode, communicators):
    rng = np.random.RandomState(0)
    ref, port, servers = _layers(mode)
    seen = set()
    for step in range(3):
        ids = rng.randint(0, 40, (6, 3)).astype(np.int64)
        ids[0, :2] = 7                       # a repeated id in the batch
        seen.update(ids.ravel().tolist())
        ct = rng.randn(6, 3, 4).astype(np.float32)
        ref_out = ref(Tensor(ids))
        port_out = port(torch.from_numpy(ids))
        assert port_out.requires_grad and port_out.shape == (6, 3, 4)
        assert _np(port_out).tobytes() == _np(ref_out).tobytes()
        _ref_backward(ref_out, ct)
        _port_backward(port_out, ct)
        if mode == 'async':
            ref.flush()
            port.flush()
    flat = np.array(sorted(seen), np.int64)
    for a, b in zip(_table_rows(port, flat), _table_rows(ref, flat)):
        assert a.tobytes() == b.tobytes()
    assert len(port) == len(ref) == len(seen)
    assert port._anchor.grad is None
    with torch.no_grad():
        out = port(ids)
    assert not out.requires_grad
    if servers:
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize('k', [1, 3])
def test_geo_communicator_push_without_pull_and_sync(k):
    rng = np.random.RandomState(1)
    geos = []
    for mod, emb in ((jnative, jemb), (tnative, temb)):
        base = mod.NativeSparseTable(4, optimizer='sgd', seed=3)
        geos.append(emb.GeoCommunicator(base, 4, k_steps=k))
    ids = np.array([5, 6, 5], np.int64)
    for step in range(2):
        g = rng.randn(3, 4).astype(np.float32)
        for geo in geos:
            geo.push(ids, g, lr=0.1)          # the first with no pull
    if k > 1:
        assert not np.array_equal(geos[1].remote.pull(ids),
                                  geos[1].local.pull(ids))
    for geo in geos:
        geo.sync()
    flat = np.array([5, 6], np.int64)
    assert geos[1].remote.pull(flat).tobytes() == \
        geos[0].remote.pull(flat).tobytes()
    assert geos[1].local.pull(flat).tobytes() == \
        geos[1].remote.pull(flat).tobytes()


def test_deepfm_bridged_matches_reference():
    kw = dict(num_features=50, fields=4, embed_dim=3, hidden=(8, 4))
    with numpy_draws(4):
        ref = JDeepFM(**kw)
    port = bridge_ctr_params(DeepFM(device=CPU, **kw), ref, None)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 50, (5, 4)).astype(np.int64)
    y = rng.randint(0, 2, (5, 1)).astype(np.float32)
    params = {n: p.data for n, p in ref.named_parameters()}

    def loss_fn(ps):
        with bind_arrays(ref, ps), no_grad():
            logits = ref(Tensor(jnp.asarray(ids))).data
            loss = jdeepfm_loss(Tensor(logits), Tensor(jnp.asarray(y)))
        return loss.data, logits
    (ref_loss, ref_logits), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    logits = port(torch.from_numpy(ids))
    loss = deepfm_loss(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(_np(logits), np.asarray(ref_logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL)
    for n, p in port.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(ref_grads[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


class _Recording:
    """A table that records what is pushed and forwards it."""

    def __init__(self, table):
        self.table, self.pushes = table, []

    def pull(self, ids):
        return self.table.pull(ids)

    def push(self, ids, grads, lr):
        self.pushes.append((np.array(ids), np.array(grads)))
        self.table.push(ids, grads, lr)


def test_deepfm_ps_equals_plain_deepfm_on_pulled_rows():
    fields, dim, vocab = 4, 3, 30
    gen = torch.Generator().manual_seed(0)
    ps = DeepFM(fields=fields, embed_dim=dim, hidden=(8,), use_ps=True,
                device=CPU, generator=gen)
    plain = DeepFM(num_features=vocab, fields=fields, embed_dim=dim,
                   hidden=(8,), device=CPU)
    assert ps.embedding.embedding_dim == dim
    assert ps.linear_embedding.embedding_dim == 1
    every = np.arange(vocab, dtype=np.int64)
    with torch.no_grad():
        plain.embedding.weight.copy_(torch.from_numpy(
            ps.embedding.table.pull(every)))
        plain.linear_embedding.weight.copy_(torch.from_numpy(
            ps.linear_embedding.table.pull(every)))
    dense = {n: p for n, p in ps.state_dict().items()}
    plain.load_state_dict({**plain.state_dict(), **dense})
    recorders = [_Recording(ps.embedding.table),
                 _Recording(ps.linear_embedding.table)]
    ps.embedding.table, ps.linear_embedding.table = recorders
    rng = np.random.RandomState(2)
    ids = rng.randint(0, vocab, (6, fields)).astype(np.int64)
    y = rng.randint(0, 2, (6, 1)).astype(np.float32)
    outs = []
    for m in (ps, plain):
        logits = m(torch.from_numpy(ids))
        deepfm_loss(logits, torch.from_numpy(y)).backward()
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])
    for n, p in ps.named_parameters():
        assert torch.equal(p.grad, dict(plain.named_parameters())[n].grad)
    for rec, table in zip(recorders, (plain.embedding,
                                      plain.linear_embedding)):
        (pushed_ids, grads), = rec.pushes
        summed = np.zeros((vocab, grads.shape[1]), np.float32)
        np.add.at(summed, pushed_ids, grads)
        np.testing.assert_allclose(summed, _np(table.weight.grad),
                                   rtol=1e-6, atol=1e-7)


def test_reference_ps_deepfm_faults_and_the_port_runs():
    """The JAX package's PS DeepFM passes num_features as the table's
    width (deepfm.py:35-36) and cannot run; the port builds tables of
    widths embed_dim and 1."""
    with numpy_draws(0):
        ref = JDeepFM(num_features=100, fields=4, embed_dim=8, use_ps=True)
    ids = np.random.RandomState(0).randint(0, 100, (5, 4)).astype(np.int64)
    with pytest.raises(TypeError, match='reshape'):
        ref(Tensor(ids))
    port = DeepFM(num_features=100, fields=4, embed_dim=8, use_ps=True,
                  device=CPU)
    assert tuple(port(torch.from_numpy(ids)).shape) == (5, 1)


def test_deepfm_trains_on_synthetic_ctr():
    """tests/test_ssd_deepfm.py TestDeepFM.test_trains_on_synthetic_ctr
    on the port: 40 Adam steps halve the loss, and the predictions
    separate the classes by 0.2."""
    rng = np.random.RandomState(0)
    F_, N = 6, 256
    ids = rng.randint(0, 100, (N, F_)).astype('int64')
    y = (ids < 12).sum(1, keepdims=True) >= 2
    m = DeepFM(num_features=100, fields=F_, embed_dim=8, device=CPU,
               generator=torch.Generator().manual_seed(3))
    opt = topt.Adam(learning_rate=5e-3, parameters=m.parameters())
    losses = []
    x, labels = torch.from_numpy(ids), torch.from_numpy(y.astype('float32'))
    for _ in range(40):
        loss = deepfm_loss(m(x), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    with torch.no_grad():
        p = torch.sigmoid(m(x)).numpy()
    assert p[y].mean() > p[~y].mean() + 0.2


def test_fm_interaction_matches_bruteforce():
    """TestDeepFM.test_fm_interaction_matches_bruteforce on the port."""
    rng = np.random.RandomState(1)
    m = DeepFM(num_features=50, fields=4, embed_dim=3, device=CPU,
               generator=torch.Generator().manual_seed(4))
    ids = torch.from_numpy(rng.randint(0, 50, (5, 4)).astype('int64'))
    with torch.no_grad():
        emb = m.embedding(ids).numpy()
    exp = np.zeros(5, 'float32')
    for n in range(5):
        for i in range(4):
            for j in range(i + 1, 4):
                exp[n] += emb[n, i] @ emb[n, j]
    s = emb.sum(1)
    trick = 0.5 * ((s * s).sum(-1) - (emb * emb).sum(2).sum(1))
    np.testing.assert_allclose(trick, exp, rtol=1e-4)


@pytest.mark.parametrize('mode', ['sync', 'geo'])
def test_wide_deep_matches_reference(mode, tmp_path):
    kw = dict(sparse_feature_dim=4, num_sparse_slots=3, dense_dim=5,
              hidden_sizes=(8,), mode=mode, geo_k=2)
    with numpy_draws(0):
        ref = JWideDeep(**kw)
    port = bridge_ctr_params(WideDeep(device=CPU, **kw), ref, tmp_path)
    opts = (paddle.optimizer.SGD(learning_rate=0.05,
                                 parameters=ref.parameters()),
            topt.SGD(learning_rate=0.05, parameters=port.parameters()))
    rng = np.random.RandomState(3)
    seen = set()
    for step in range(3):
        ids = rng.randint(0, 50, (8, 3)).astype(np.int64)
        dense = rng.rand(8, 5).astype(np.float32)
        y = rng.randint(0, 2, (8, 1)).astype(np.int64)
        seen.update(ids.ravel().tolist())
        ref_loss = ref.loss(ref(Tensor(ids), Tensor(dense)), Tensor(y))
        ref_loss.backward()
        loss = port.loss(port(torch.from_numpy(ids),
                              torch.from_numpy(dense)), torch.from_numpy(y))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL)
        for opt in opts:
            opt.step()
            opt.clear_grad()
    flat = np.array(sorted(seen), np.int64)
    for name in ('embedding', 'wide_embedding'):
        for a, b in zip(_table_rows(getattr(port, name), flat),
                        _table_rows(getattr(ref, name), flat)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    ref_w = {n: _np(p) for n, p in ref.named_parameters()}
    for n, p in port.named_parameters():
        np.testing.assert_allclose(_np(p), ref_w[n], rtol=RTOL, atol=ATOL)


def test_fleet_metrics_match_reference(monkeypatch):
    rng = np.random.RandomState(4)
    a = rng.rand(17).astype(np.float32)
    pos = rng.randint(0, 9, 33)
    neg = rng.randint(0, 9, 33)
    for name, args in (('sum', (a,)), ('max', (a,)), ('min', (a,)),
                       ('acc', (a[:5], np.full(5, 3.0))),
                       ('mae', (a, 17)), ('rmse', (a, np.full(17, 1.0))),
                       ('auc', (pos, neg)),
                       ('auc', (np.zeros(4), neg[:4]))):
        want = getattr(jfm, name)(*args)
        got = getattr(tfm, name)(*(torch.from_numpy(np.asarray(x))
                                   for x in args))
        assert got == want, name
    monkeypatch.setenv('PADDLE_TRAINERS_NUM', '2')
    with pytest.raises(NotImplementedError, match='item 7'):
        tfm.sum(a)


def test_metrics_match_reference():
    rng = np.random.RandomState(5)
    preds = rng.rand(64).astype(np.float32)
    labels = rng.randint(0, 2, 64)
    aucs = (jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255))
    for m in aucs:
        m.update(preds[:32], labels[:32])
    aucs[0].update(Tensor(np.stack([1 - preds[32:], preds[32:]], 1)),
                   Tensor(labels[32:]))
    aucs[1].update(torch.from_numpy(np.stack([1 - preds[32:], preds[32:]],
                                             1)), torch.from_numpy(
                                                 labels[32:]))
    assert aucs[1].accumulate() == aucs[0].accumulate()
    np.testing.assert_array_equal(aucs[1]._stat_pos, aucs[0]._stat_pos)
    # the bucket statistics feed fleet.metrics.auc
    assert abs(tfm.auc(aucs[1]._stat_pos, aucs[1]._stat_neg)
               - aucs[1].accumulate()) < 1e-12
    logits = rng.randn(10, 4).astype(np.float32)
    lab = rng.randint(0, 4, (10, 1))
    for topk in ((1,), (1, 3)):
        ja, ta = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
        jc = ja.compute(Tensor(logits), Tensor(lab))
        tc = ta.compute(torch.from_numpy(logits), torch.from_numpy(lab))
        np.testing.assert_array_equal(_np(tc), _np(jc))
        assert ta.update(tc) == ja.update(jc)
        assert ta.accumulate() == ja.accumulate() and ta.name() == ja.name()
    for cls in ('Precision', 'Recall'):
        jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), labels)
        assert tm.accumulate() == jm.accumulate()
    assert float(tmetric.accuracy(torch.from_numpy(logits),
                                  torch.from_numpy(lab), k=2)) == float(
        _np(jmetric.accuracy(Tensor(logits), Tensor(lab), k=2)))
    pred, lab2 = rng.randint(0, 5, 40), rng.randint(0, 5, 40)
    want = jmetric.mean_iou(Tensor(pred), Tensor(lab2), 6)
    got = tmetric.mean_iou(torch.from_numpy(pred), torch.from_numpy(lab2), 6)
    # the counts exactly; their fp32 mean up to summation order
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_entry_attrs_match_reference():
    for mod in (jentry, tentry):
        with pytest.raises(ValueError):
            mod.ProbabilityEntry(1)
        with pytest.raises(ValueError):
            mod.ProbabilityEntry(1.5)
        with pytest.raises(ValueError):
            mod.CountFilterEntry(-1)
        with pytest.raises(NotImplementedError):
            mod.EntryAttr()._to_attr()
    for args in (('ProbabilityEntry', 0.25), ('CountFilterEntry', 7)):
        want = getattr(jentry, args[0])(args[1])
        got = getattr(tentry, args[0])(args[1])
        assert repr(got) == repr(want) == got._to_attr() == want._to_attr()


def test_ctr_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (lambda: temb.DistributedEmbedding(4),
                  lambda: DeepFM(fields=2),
                  lambda: DeepFM(fields=2, use_ps=True),
                  lambda: WideDeep(num_sparse_slots=2)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()
    with pytest.raises(ValueError, match='bad PS mode'):
        temb.DistributedEmbedding(4, mode='bogus', device=CPU)
    assert DeepFM(fields=2, device=CPU).device.type == 'cpu'
