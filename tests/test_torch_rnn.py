"""The port's recurrent stack (`paddle_tpu_torch/nn/layer/rnn.py`) against
`paddle_tpu.nn`'s on bridged weights and the same numpy inputs.

- Every cell, and every stack mode (LSTM, GRU, SimpleRNN tanh and relu)
  at 1 and 2 layers, forward and bidirectional, batch- and time-major,
  with and without given initial states: outputs, final states and the
  parameters' gradients of sum(y * w) + sum(final states).
- `sequence_length`, which the reference accepts and ignores: the
  oracle is the reference run on each row cut to its own length (the
  valid outputs and the final states); the port's outputs past a
  length are zero. The same for the `RNN` and `BiRNN` wrappers.
- Inter-layer dropout in training raises (the reference stores it and
  never applies it); at eval it is allowed.

Tolerances: the round's fp32 bars, rtol 2e-4 / atol 2e-5.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import load_jax_params
from test_torch_vision_models import numpy_draws
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-4, atol=2e-5)
B, T, C, H = 3, 5, 4, 6


def _np(t):
    return np.asarray(t.data) if isinstance(t, Tensor) else \
        t.detach().cpu().numpy()


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _pair(jcls, tcls, *args, **kw):
    with numpy_draws(7):
        jm = jcls(*args, **kw)
    tm = tcls(*args, device='cpu', **kw)
    load_jax_params(tm, {n: np.asarray(p.data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _run_both(jm, tm, x, states=None, **kw):
    """(reference outputs, port outputs, reference grads, port grads):
    each side's loss is sum(y * w) + the sum of its final states."""
    w = np.random.RandomState(3).randn(*_shape_of(jm, tm, x, states, **kw))
    w = w.astype(np.float32)
    jargs = [Tensor(x, stop_gradient=False)]
    targs = [torch.tensor(x, requires_grad=True)]
    if states is not None:
        jargs.append(_to_j(states))
        targs.append(_to_t(states))
    jy, jst = jm(*jargs, **kw)
    ty, tst = tm(*targs, **kw)
    jloss = (jy * Tensor(w)).sum()
    for s in _flat(jst):
        jloss = jloss + s.sum()
    tloss = (ty * torch.from_numpy(w)).sum() + sum(s.sum()
                                                   for s in _flat(tst))
    jloss.backward()
    tloss.backward()
    jg = {n: _np(p.grad) for n, p in jm.named_parameters()}
    tg = {n: _np(p.grad) for n, p in tm.named_parameters()}
    return (jy, jst), (ty, tst), jg, tg


def _shape_of(jm, tm, x, states, **kw):
    with torch.no_grad():
        args = [torch.tensor(x)] + ([] if states is None else
                                    [_to_t(states)])
        return tuple(tm(*args, **kw)[0].shape)


def _to_j(s):
    if isinstance(s, tuple):
        return tuple(_to_j(v) for v in s)
    return Tensor(s)


def _to_t(s):
    if isinstance(s, tuple):
        return tuple(_to_t(v) for v in s)
    return torch.from_numpy(s)


def _check(j, t, jg, tg):
    for a, b in zip(_flat(j), _flat(t)):
        np.testing.assert_allclose(_np(b), _np(a), **FP32)
    assert set(jg) == set(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **FP32)


CELLS = [('SimpleRNNCell', {}), ('SimpleRNNCell', {'activation': 'relu'}),
         ('LSTMCell', {}), ('GRUCell', {})]


@pytest.mark.parametrize('name,kw', CELLS)
@pytest.mark.parametrize('given', [False, True])
def test_cells_match_reference(name, kw, given):
    jm, tm = _pair(getattr(jnn, name), getattr(tnn, name), C, H, **kw)
    rng = np.random.RandomState(0)
    x = rng.randn(B, C).astype(np.float32)
    states = None
    if given:
        states = tuple(rng.randn(B, H).astype(np.float32)
                       for _ in range(2)) if name == 'LSTMCell' \
            else rng.randn(B, H).astype(np.float32)
    j, t, jg, tg = _run_both(jm, tm, x, states)
    _check(j, t, jg, tg)


MODES = [('LSTM', {}), ('GRU', {}), ('SimpleRNN', {}),
         ('SimpleRNN', {'activation': 'relu'})]


@pytest.mark.parametrize('name,kw', MODES)
@pytest.mark.parametrize('layers,direction,time_major,given', [
    (1, 'forward', False, False), (2, 'bidirect', False, True),
    (2, 'forward', True, True)])
def test_stacks_match_reference(name, kw, layers, direction, time_major,
                                given):
    jm, tm = _pair(getattr(jnn, name), getattr(tnn, name), C, H,
                   num_layers=layers, direction=direction,
                   time_major=time_major, **kw)
    assert [n for n, _ in jm.named_parameters()] == \
        [n for n, _ in tm.named_parameters()]
    rng = np.random.RandomState(1)
    shape = (T, B, C) if time_major else (B, T, C)
    x = rng.randn(*shape).astype(np.float32)
    states = None
    if given:
        nd = 2 if direction != 'forward' else 1
        s = lambda: rng.randn(layers * nd, B, H).astype(np.float32)
        states = (s(), s()) if name == 'LSTM' else s()
    j, t, jg, tg = _run_both(jm, tm, x, states)
    _check(j, t, jg, tg)


def _cut_oracle(jm, x, lens, time_major):
    """The reference run on each row alone, cut to its length: [(valid
    outputs [len, F], final states [layers*dirs, H] ...)]."""
    rows = []
    for b, n in enumerate(lens):
        xb = x[:n, b:b + 1] if time_major else x[b:b + 1, :n]
        y, st = jm(Tensor(xb))
        y = _np(y)
        rows.append((y[:, 0] if time_major else y[0],
                     [_np(s)[:, 0] for s in _flat(st)]))
    return rows


@pytest.mark.parametrize('name,direction,time_major', [
    ('LSTM', 'bidirect', False), ('GRU', 'bidirect', False),
    ('SimpleRNN', 'bidirectional', False), ('LSTM', 'forward', True)])
def test_sequence_length_is_the_per_row_cut(name, direction, time_major):
    jm, tm = _pair(getattr(jnn, name), getattr(tnn, name), C, H,
                   num_layers=2, direction=direction, time_major=time_major)
    lens = [5, 2, 4]
    x = np.random.RandomState(2).randn(
        *((T, B, C) if time_major else (B, T, C))).astype(np.float32)
    with torch.no_grad():
        y, st = tm(torch.from_numpy(x), sequence_length=torch.tensor(lens))
    y = _np(y)
    for b, (want_y, want_st) in enumerate(_cut_oracle(jm, x, lens,
                                                      time_major)):
        n = lens[b]
        got = y[:, b] if time_major else y[b]
        np.testing.assert_allclose(got[:n], want_y, **FP32)
        assert not got[n:].any()
        for s, w in zip(_flat(st), want_st):
            np.testing.assert_allclose(_np(s)[:, b], w, **FP32)


@pytest.mark.parametrize('cell', ['GRUCell', 'LSTMCell'])
def test_wrappers_sequence_length(cell):
    with numpy_draws(5):
        jf, jb = getattr(jnn, cell)(C, H), getattr(jnn, cell)(C, H)
    tf, tb = (getattr(tnn, cell)(C, H, device='cpu') for _ in range(2))
    for j, t in ((jf, tf), (jb, tb)):
        load_jax_params(t, {n: np.asarray(p.data)
                            for n, p in j.named_parameters()})
    jbi, tbi = jnn.BiRNN(jf, jb), tnn.BiRNN(tf, tb)
    x = np.random.RandomState(4).randn(B, T, C).astype(np.float32)
    # without lengths: the wrappers equal the reference's
    jy, jst = jbi(Tensor(x))
    with torch.no_grad():
        ty, tst = tbi(torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), _np(jy), **FP32)
    for a, b in zip(_flat(tst), _flat(jst)):
        np.testing.assert_allclose(_np(a), _np(b), **FP32)
    lens = [3, 5, 1]
    with torch.no_grad():
        ty, tst = tbi(torch.from_numpy(x), sequence_length=lens)
    ty = _np(ty)
    for b, n in enumerate(lens):
        wy, wst = jbi(Tensor(x[b:b + 1, :n]))
        np.testing.assert_allclose(ty[b, :n], _np(wy)[0], **FP32)
        assert not ty[b, n:].any()
        for a, w in zip(_flat(tst), _flat(wst)):
            np.testing.assert_allclose(_np(a)[b], _np(w)[0], **FP32)


def test_dropout_refused_in_training():
    m = tnn.LSTM(C, H, num_layers=2, dropout=0.2, device='cpu')
    x = torch.randn(B, T, C)
    with pytest.raises(NotImplementedError, match='never applies'):
        m(x)
    m.eval()
    assert m(x)[0].shape == (B, T, H)


def test_bad_lengths_raise():
    m = tnn.GRU(C, H, device='cpu')
    with pytest.raises(ValueError, match='sequence_length'):
        m(torch.randn(B, T, C), sequence_length=[0, 2, 3])


@pytest.mark.parametrize('name', ['LSTM', 'GRU', 'SimpleRNN', 'LSTMCell',
                                  'GRUCell', 'SimpleRNNCell'])
def test_layers_are_built_on_the_card_unless_asked(name):
    if torch.cuda.is_available():
        m = getattr(tnn, name)(C, H)
        assert {p.device.type for p in m.parameters()} == {'cuda'}
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            getattr(tnn, name)(C, H)
