"""Recurrent layers — counterpart of `paddle_tpu/nn/layer/rnn.py`: the
three cells, the `SimpleRNN` / `LSTM` / `GRU` stacks, and the `RNN` and
`BiRNN` wrappers, with paddle's parameter names (`weight_ih_l0`,
`bias_hh_l1_reverse`, ...), layouts ([gates · hidden, in]) and
initializer (uniform in ±1/sqrt(hidden)).

The reference scans each layer and direction in XLA with no Pallas body.
The port runs a whole stack as ONE call of torch's own recurrent op
(`torch._VF.lstm`, `gru`, `rnn_tanh`, `rnn_relu`: cuDNN on the card,
ATen on the CPU), and a cell as one call of its cell op
(`torch._VF.lstm_cell`, ...). Their formulas are the reference's: LSTM
gates i, f, g, o with c' = f c + i tanh(g), h' = o tanh(c'); GRU gates
r, z, c with c = tanh(x_c + r (h W_hc + b_hc)), h' = (1 - z) c + z h
(`tests/test_torch_rnn.py` holds them to the reference's scans).

`sequence_length` follows PaddlePaddle, where the reference accepts and
ignores it: past a row's length its state holds and its output is zero,
and the reverse direction runs within the row's length. The stacks pack
the batch (`pack_padded_sequence`: one host read of the lengths); the
wrappers mask each step. Inter-layer `dropout` > 0 in training raises:
the reference stores it and never applies it. The cells and stacks are
built on the card unless the caller passes `device='cpu'`.
"""
import math

import torch
from torch import nn
from torch.nn.utils import rnn as rnn_utils

from ...device import resolve_device
from .. import initializer as I
from .common import create_parameter


def _std_uniform(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-std, std)


def _to_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


class RNNCellBase(nn.Module):
    def get_initial_states(self, batch_ref, shape=None, dtype='float32',
                           init_value=0.0, batch_dim_idx=0):
        """Zero (or `init_value`) states for `batch_ref`'s batch, on its
        device: one tensor, or a tuple for a nested `shape`."""
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        kw = dict(dtype=_to_dtype(dtype), device=batch_ref.device)
        if isinstance(shape[0], (list, tuple)):
            return tuple(torch.full((batch,) + tuple(s), init_value, **kw)
                         for s in shape)
        return torch.full((batch,) + tuple(shape), init_value, **kw)

    def _make(self, gates, input_size, hidden_size, attrs, kw):
        init = _std_uniform(hidden_size)
        kw = dict(kw, device=resolve_device(kw['device']))
        wi, wh, bi, bh = attrs
        self.input_size, self.hidden_size = input_size, hidden_size
        self.weight_ih = create_parameter([gates * hidden_size, input_size],
                                          wi, default_initializer=init, **kw)
        self.weight_hh = create_parameter([gates * hidden_size, hidden_size],
                                          wh, default_initializer=init, **kw)
        self.bias_ih = create_parameter([gates * hidden_size], bi, True,
                                        default_initializer=init, **kw)
        self.bias_hh = create_parameter([gates * hidden_size], bh, True,
                                        default_initializer=init, **kw)

    def _weights(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if activation not in ('tanh', 'relu'):
            raise ValueError(f'activation must be tanh or relu, got '
                             f'{activation!r}')
        self.activation = activation
        self._make(1, input_size, hidden_size,
                   (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                    bias_hh_attr),
                   dict(device=device, dtype=dtype, generator=generator))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, dtype=inputs.dtype)
        op = torch._VF.rnn_tanh_cell if self.activation == 'tanh' \
            else torch._VF.rnn_relu_cell
        h = op(inputs, states, *self._weights())
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None, dtype=None, generator=None):
        super().__init__()
        self._make(4, input_size, hidden_size,
                   (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                    bias_hh_attr),
                   dict(device=device, dtype=dtype, generator=generator))

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, dtype=inputs.dtype)
        h, c = torch._VF.lstm_cell(inputs, tuple(states), *self._weights())
        return h, (h, c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None, dtype=None, generator=None):
        super().__init__()
        self._make(3, input_size, hidden_size,
                   (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                    bias_hh_attr),
                   dict(device=device, dtype=dtype, generator=generator))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, dtype=inputs.dtype)
        h = torch._VF.gru_cell(inputs, states, *self._weights())
        return h, h


_OPS = {'LSTM': 'lstm', 'GRU': 'gru', 'RNN_TANH': 'rnn_tanh',
        'RNN_RELU': 'rnn_relu'}


def _refuse_dropout(layer):
    if layer.dropout and layer.training:
        raise NotImplementedError(
            f'{type(layer).__name__}(dropout={layer.dropout}) in training is '
            f'not ported: the reference stores the inter-layer dropout '
            f'and never applies it; pass dropout=0 or call eval()')


def _lengths(sequence_length, batch, steps):
    """The lengths as a CPU int64 tensor (one host read), checked to lie
    in [1, steps]."""
    lens = torch.as_tensor(sequence_length).reshape(-1).to(
        'cpu', torch.int64)
    if lens.numel() != batch or int(lens.min()) < 1 or \
            int(lens.max()) > steps:
        raise ValueError(f'sequence_length must hold {batch} lengths in '
                         f'[1, {steps}], got {lens.tolist()}')
    return lens


class _RNNBase(nn.Module):
    """A multi-layer, optionally bidirectional stack (time_major=False:
    [batch, time, feature])."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if direction not in ('forward', 'bidirect', 'bidirectional'):
            raise ValueError(f'direction must be forward, bidirect or '
                             f'bidirectional, got {direction!r}')
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.num_directions = 1 if direction == 'forward' else 2
        g = {'LSTM': 4, 'GRU': 3}.get(mode, 1)
        init = _std_uniform(hidden_size)
        kw = dict(default_initializer=init, device=resolve_device(device),
                  dtype=dtype, generator=generator)
        self._flat_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self.num_directions
                suffix = f"_l{layer}" + ("_reverse" if d else "")
                for name, shape, attr, bias in (
                        ('weight_ih', [g * hidden_size, in_sz],
                         weight_ih_attr, False),
                        ('weight_hh', [g * hidden_size, hidden_size],
                         weight_hh_attr, False),
                        ('bias_ih', [g * hidden_size], bias_ih_attr, True),
                        ('bias_hh', [g * hidden_size], bias_hh_attr, True)):
                    self.register_parameter(
                        name + suffix,
                        create_parameter(shape, attr, bias, **kw))
                    self._flat_names.append(name + suffix)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _refuse_dropout(self)
        is_lstm = self.mode == 'LSTM'
        x = inputs
        batch = x.shape[1] if self.time_major else x.shape[0]
        steps = x.shape[0] if self.time_major else x.shape[1]
        n_states = self.num_layers * self.num_directions
        if initial_states is None:
            z = x.new_zeros(n_states, batch, self.hidden_size)
            initial_states = (z, torch.zeros_like(z)) if is_lstm else z
        hx = tuple(initial_states) if is_lstm else initial_states
        weights = [getattr(self, n) for n in self._flat_names]
        op = getattr(torch._VF, _OPS[self.mode])
        args = (weights, True, self.num_layers, 0.0, self.training,
                self.num_directions == 2)
        if sequence_length is None:
            out = op(x, hx, *args, not self.time_major)
            return (out[0], (out[1], out[2])) if is_lstm else tuple(out)
        packed = rnn_utils.pack_padded_sequence(
            x, _lengths(sequence_length, batch, steps),
            batch_first=not self.time_major, enforce_sorted=False)
        order = packed.sorted_indices.to(x.device)
        sort = (lambda h: h.index_select(1, order))
        hx = tuple(sort(h) for h in hx) if is_lstm else sort(hx)
        out = op(packed.data, packed.batch_sizes, hx, *args)
        y, _ = rnn_utils.pad_packed_sequence(
            rnn_utils.PackedSequence(out[0], packed.batch_sizes,
                                     packed.sorted_indices,
                                     packed.unsorted_indices),
            batch_first=not self.time_major, total_length=steps)
        back = packed.unsorted_indices.to(x.device)
        finals = [h.index_select(1, back) for h in out[1:]]
        return (y, tuple(finals)) if is_lstm else (y, finals[0])

    def extra_repr(self):
        return (f'{self.input_size}, {self.hidden_size}, '
                f'num_layers={self.num_layers}, direction={self.direction}')


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *args, **kwargs):
        mode = 'RNN_TANH' if activation == 'tanh' else 'RNN_RELU'
        super().__init__(mode, input_size, hidden_size, num_layers, direction,
                         time_major, dropout, *args, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *args,
                 **kwargs):
        super().__init__('LSTM', input_size, hidden_size, num_layers,
                         direction, time_major, dropout, *args, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *args,
                 **kwargs):
        super().__init__('GRU', input_size, hidden_size, num_layers,
                         direction, time_major, dropout, *args, **kwargs)


def _select(mask, new, old):
    if isinstance(new, (tuple, list)):
        return type(new)(_select(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask, new, old)


class RNN(nn.Module):
    """A cell run over time, one cell call a step (the reference's loop);
    with `sequence_length` a row's state holds and its output is zero
    past its length, in either direction."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        batch, steps = x.shape[0], x.shape[1]
        states = initial_states
        if states is None:
            states = self.cell.get_initial_states(x[:, 0], dtype=x.dtype)
        keep = None
        if sequence_length is not None:
            lens = _lengths(sequence_length, batch, steps).to(x.device)
            keep = torch.arange(steps, device=x.device)[None, :] < \
                lens[:, None]
        outputs = [None] * steps
        time_ids = range(steps - 1, -1, -1) if self.is_reverse \
            else range(steps)
        for t in time_ids:
            out, new = self.cell(x[:, t], states)
            if keep is not None:
                m = keep[:, t:t + 1]
                new = _select(m, new, states)
                out = torch.where(m, out, torch.zeros_like(out))
            states = new
            outputs[t] = out
        return torch.stack(outputs, dim=0 if self.time_major else 1), states


class BiRNN(nn.Module):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        sf, sb = (None, None) if initial_states is None else initial_states
        yf, stf = self.rnn_fw(inputs, sf, sequence_length)
        yb, stb = self.rnn_bw(inputs, sb, sequence_length)
        return torch.cat([yf, yb], dim=-1), (stf, stb)
