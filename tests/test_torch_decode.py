"""The port's beam search (`paddle_tpu_torch/nn/decode.py`) against
`paddle_tpu.nn.decode` on the same tables and bridged cells.

- `gather_tree` against `paddle_tpu.ops.contrib.gather_tree`: exact.
- `BeamSearchDecoder` + `dynamic_decode` with the reference's scripted
  cell (tests/test_beam_decode.py:9-42), whose tables tie many
  candidates (the lower flat index must win, as `jax.lax.top_k` picks
  it) and finish beams at different steps; with a bridged GRU cell and
  a bridged LSTM cell (embedding and projection bridged too): the same
  ids, parents and lengths, scores within 1e-5.
- `BasicDecoder` with the greedy and teacher-forcing helpers: the same
  ids and outputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops.contrib import gather_tree
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.nn import decode as tdec
from test_torch_vision_models import numpy_draws
from torch_threads import one_intra_op_thread  # noqa: F401

SCORES = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t.data) if isinstance(t, Tensor) else \
        t.detach().cpu().numpy()


def test_gather_tree_exact():
    rng = np.random.RandomState(0)
    T, B, W = 6, 3, 4
    ids = rng.randint(0, 50, (T, B, W)).astype(np.int64)
    parents = rng.randint(0, W, (T, B, W)).astype(np.int64)
    want = _np(gather_tree(Tensor(ids.astype(np.int32)),
                           Tensor(parents.astype(np.int32))))
    got = tdec._gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), want)


class _JaxScripted:
    def __init__(self, table):
        self.table = np.asarray(table, np.float32)

    def __call__(self, inputs, states):
        toks = np.asarray(inputs.data).astype(int).reshape(-1)
        return Tensor(jnp.asarray(self.table[toks])), states


class _TorchScripted:
    def __init__(self, table):
        self.table = torch.from_numpy(np.asarray(table, np.float32))

    def __call__(self, inputs, states):
        return self.table[inputs.reshape(-1).long()], states


def _tables():
    V = 4
    best = np.full((V, V), -5.0, np.float32)
    best[:, 2] = 2.0
    best[2, 3] = 6.0
    # five tokens, end = 4: ties everywhere, beams finishing at steps 1-4
    V = 5
    tied = np.zeros((V, V), np.float32)
    tied[0] = [1.0, 1.0, 0.5, 0.5, 0.8]
    tied[1] = [0.2, 0.2, 0.2, 0.2, 0.2]
    tied[2] = [0.0, 1.0, 1.0, 0.0, 1.0]
    tied[3] = [2.0, 0.0, 0.0, 2.0, 0.0]
    tied[4] = 0.0
    return [('best_path', best, 3, 2, 0), ('ties', tied, 4, 3, 0)]


def _compare(jout, jfinal, tout, tfinal):
    np.testing.assert_array_equal(_np(tout['predicted_ids']),
                                  _np(jout['predicted_ids']))
    np.testing.assert_allclose(_np(tout['scores']), _np(jout['scores']),
                               **SCORES)
    np.testing.assert_array_equal(_np(tfinal['lengths']),
                                  np.asarray(jfinal['lengths']))
    np.testing.assert_array_equal(_np(tfinal['finished']),
                                  np.asarray(jfinal['finished']))


@pytest.mark.parametrize('case', _tables(), ids=lambda c: c[0])
def test_scripted_beam_search_matches_reference(case):
    _, table, end, W, start = case
    B = 3
    jdec = jnn.BeamSearchDecoder(_JaxScripted(table), start_token=start,
                                 end_token=end, beam_size=W)
    jout, jfinal = jnn.dynamic_decode(
        jdec, inits={'h': Tensor(np.zeros((B, 1), np.float32))},
        max_step_num=8)
    tdecoder = tnn.BeamSearchDecoder(_TorchScripted(table), start_token=start,
                                     end_token=end, beam_size=W)
    tout, tfinal = tnn.dynamic_decode(
        tdecoder, inits={'h': torch.zeros(B, 1)}, max_step_num=8)
    _compare(jout, jfinal, tout, tfinal)


@pytest.mark.parametrize('cell', ['GRUCell', 'LSTMCell'])
def test_rnn_cell_beam_search_matches_reference(cell):
    V, H, B, W = 12, 8, 2, 3
    with numpy_draws(11):
        jemb, jcell, jproj = jnn.Embedding(V, H), getattr(jnn, cell)(H, H), \
            jnn.Linear(H, V)
    temb, tcell, tproj = tnn.Embedding(V, H), \
        getattr(tnn, cell)(H, H, device='cpu'), tnn.Linear(H, V)
    for j, t in ((jemb, temb), (jcell, tcell), (jproj, tproj)):
        load_jax_params(t, {n: np.asarray(p.data)
                            for n, p in j.named_parameters()})
    h0 = np.random.RandomState(1).randn(B, H).astype(np.float32)
    jinit = (Tensor(h0), Tensor(h0)) if cell == 'LSTMCell' else Tensor(h0)
    tinit = (torch.from_numpy(h0), torch.from_numpy(h0)) \
        if cell == 'LSTMCell' else torch.from_numpy(h0)
    jdec = jnn.BeamSearchDecoder(jcell, start_token=1, end_token=2,
                                 beam_size=W, embedding_fn=jemb,
                                 output_fn=jproj)
    jout, jfinal = jnn.dynamic_decode(jdec, inits=jinit, max_step_num=6)
    with torch.no_grad():
        tdecoder = tnn.BeamSearchDecoder(tcell, start_token=1, end_token=2,
                                         beam_size=W, embedding_fn=temb,
                                         output_fn=tproj)
        tout, tfinal = tnn.dynamic_decode(tdecoder, inits=tinit,
                                          max_step_num=6)
    _compare(jout, jfinal, tout, tfinal)


def test_basic_decoder_greedy_and_teacher_forcing():
    V, H, B, T = 10, 6, 3, 4
    with numpy_draws(13):
        jemb, jcell, jproj = jnn.Embedding(V, H), jnn.GRUCell(H, H), \
            jnn.Linear(H, V)
    temb, tcell, tproj = tnn.Embedding(V, H), \
        tnn.GRUCell(H, H, device='cpu'), tnn.Linear(H, V)
    for j, t in ((jemb, temb), (jcell, tcell), (jproj, tproj)):
        load_jax_params(t, {n: np.asarray(p.data)
                            for n, p in j.named_parameters()})
    h0 = np.zeros((B, H), np.float32)
    jout, _ = jnn.dynamic_decode(
        jnn.BasicDecoder(jcell, jnn.GreedyEmbeddingHelper(
            jemb, np.array([1, 3, 5]), 0), output_fn=jproj),
        inits=Tensor(h0), max_step_num=5)
    with torch.no_grad():
        tout, _ = tnn.dynamic_decode(
            tnn.BasicDecoder(tcell, tnn.GreedyEmbeddingHelper(
                temb, torch.tensor([1, 3, 5]), 0), output_fn=tproj),
            inits=torch.from_numpy(h0), max_step_num=5)
    np.testing.assert_array_equal(_np(tout['sample_ids']),
                                  _np(jout['sample_ids']))
    x = np.random.RandomState(2).randn(B, T, H).astype(np.float32)
    lens = np.array([4, 2, 3])
    jout, _ = jnn.dynamic_decode(
        jnn.BasicDecoder(jcell, jnn.TrainingHelper(Tensor(x), Tensor(lens))),
        inits=Tensor(h0), max_step_num=T)
    with torch.no_grad():
        tout, _ = tnn.dynamic_decode(
            tnn.BasicDecoder(tcell, tnn.TrainingHelper(
                torch.from_numpy(x), torch.from_numpy(lens))),
            inits=torch.from_numpy(h0), max_step_num=T)
    np.testing.assert_allclose(_np(tout['cell_outputs']),
                               _np(jout['cell_outputs']), rtol=2e-4,
                               atol=2e-5)
