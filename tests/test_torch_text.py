"""The port's text models (`paddle_tpu_torch/text/models.py`) against
`paddle_tpu.text.models` on bridged weights: `LSTMSentiment` (one and
two layers, forward and bidirectional) and `BoWClassifier` forwards and
parameter gradients on padded id batches, and three `hapi.Model` steps
of the bidirectional classifier over the same padded `Imdb` batches.
Tolerances: the round's fp32 bars, rtol 2e-4 / atol 2e-5."""
import numpy as np
import pytest
import torch

from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import text as jtext
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import text as ttext
from paddle_tpu_torch.models import load_jax_params
from test_torch_vision_models import numpy_draws
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-4, atol=2e-5)
V = 50


def _pair(name, **kw):
    with numpy_draws(9):
        jm = getattr(jtext, name)(vocab_size=V, **kw)
    tm = getattr(ttext, name)(vocab_size=V, device='cpu', **kw)
    load_jax_params(tm, {n: np.asarray(p.data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _ids(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, V, (4, 7)).astype(np.int64)
    ids[1, 4:] = 0
    ids[2, 2:] = 0
    ids[3, :] = 0          # padding only: the pool divides by 1
    return ids


@pytest.mark.parametrize('name,kw', [
    ('LSTMSentiment', dict(embed_dim=8, hidden=6)),
    ('LSTMSentiment', dict(embed_dim=8, hidden=6, num_layers=2,
                           direction='bidirect')),
    ('BoWClassifier', dict(embed_dim=8))])
def test_text_models_match_reference(name, kw):
    jm, tm = _pair(name, **kw)
    ids = _ids()
    jy = jm(Tensor(ids.astype(np.int32)))
    ty = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.data),
                               **FP32)
    w = np.random.RandomState(1).randn(*ty.shape).astype(np.float32)
    (jy * Tensor(w)).sum().backward()
    (ty * torch.from_numpy(w)).sum().backward()
    for (n, jp), (_, tp) in zip(jm.named_parameters(),
                                tm.named_parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad.data),
                                   err_msg=n, **FP32)


def test_dropout_refused():
    with pytest.raises(NotImplementedError, match='dropout'):
        ttext.LSTMSentiment(vocab_size=V, dropout=0.1, device='cpu')


def pad_collate(batch, n=64):
    """Right-pad each doc with 0 to n ids (one shape: the reference
    compiles its scan once); labels [N, 1]."""
    ids = np.zeros((len(batch), n), np.int64)
    for i, (d, _) in enumerate(batch):
        ids[i, :len(d)] = d
    return ids, np.asarray([[y] for _, y in batch], np.int64)


def test_hapi_fit_on_imdb_matches_reference():
    jm, tm = _pair('LSTMSentiment', embed_dim=8, hidden=6,
                   direction='bidirect')
    losses = []
    for pkg, io, nn, opt, net, wrap in (
            (jhapi, jio, jnn, jopt, jm, lambda a: a.astype(np.int32)),
            (thapi, tio, tnn, topt, tm, lambda a: a)):
        model = pkg.Model(net) if pkg is jhapi else \
            pkg.Model(net, device='cpu')
        model.prepare(opt.Adam(learning_rate=1e-2,
                               parameters=net.parameters()),
                      nn.CrossEntropyLoss())
        np.random.seed(0)
        loader = io.DataLoader(
            jtext.Imdb(mode='train'), batch_size=16, shuffle=True,
            collate_fn=lambda b: tuple(wrap(a) for a in pad_collate(b)))
        seen = []
        for step, (x, y) in enumerate(loader):
            if step == 3:
                break
            seen.append(model.train_batch([x], [y])[0][0])
        losses.append(seen)
    np.testing.assert_allclose(losses[1], losses[0], **FP32)


def test_sequence_ops_wait_for_item_9c():
    with pytest.raises(NotImplementedError, match='item 9c'):
        ttext.viterbi_decode
    assert ttext.Imdb is ttext.datasets.Imdb


@pytest.mark.parametrize('name', ['LSTMSentiment', 'BoWClassifier'])
def test_models_are_built_on_the_card_unless_asked(name):
    if torch.cuda.is_available():
        m = getattr(ttext, name)(vocab_size=V)
        assert {p.device.type for p in m.parameters()} == {'cuda'}
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            getattr(ttext, name)(vocab_size=V)
