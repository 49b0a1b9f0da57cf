"""Linear, Embedding, Dropout, Flatten and Identity with paddle's
parameter names and layouts — counterparts of
`paddle_tpu/nn/layer/common.py`.

Parameters are created on the given `device`/`dtype` (torch factory
kwargs) with paddle's default initializers (XavierUniform weights, zero
bias), drawn from an optional `torch.Generator`.
"""
import torch
from torch import nn

from ...ops import nn_ops as F
from .. import initializer as I


def xavier_uniform_(w, generator=None):
    """paddle's XavierUniform on a 2-D weight: fan_in = shape[0],
    fan_out = shape[1] (paddle lays Linear weights out [in, out])."""
    return I.XavierUniform()(w, generator)


def refuse_param_attr(weight_attr, bias_attr):
    """Whether the layer has a bias (`bias_attr=False`: none); any other
    `weight_attr`/`bias_attr` than None is a ParamAttr, which is not
    ported yet."""
    if weight_attr is not None or bias_attr not in (None, False):
        raise NotImplementedError(
            'a ParamAttr (weight_attr / bias_attr) is not ported yet '
            '(ROADMAP Queue 1 item 9c); pass None, or bias_attr=False')
    return bias_attr is not False


class Linear(nn.Module):
    """y = x @ W + b with W of shape [in, out] (paddle layout)."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = {'device': device, 'dtype': dtype}
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = (nn.Parameter(torch.zeros(out_features, **kw))
                     if bias else None)
        xavier_uniform_(self.weight, generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f'in_features={self.in_features}, ' \
               f'out_features={self.out_features}'


class Embedding(nn.Module):
    """Lookup table [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        xavier_uniform_(self.weight, generator)

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f'{self.weight.shape[0]}, {self.weight.shape[1]}'


class Dropout(nn.Module):
    """F.dropout with the layer's p, axis and mode (common.py:64-78):
    identity at eval or p=0 in upscale_in_train mode; in training the
    keep mask comes from the bound generator (core/rng.py)."""

    def __init__(self, p=0.5, axis=None, mode='upscale_in_train'):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f'p={self.p}'


class Flatten(nn.Module):
    """Flattens axes start_axis..stop_axis into one (common.py:94-101)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Identity(nn.Module):
    """Returns its input; takes and ignores any arguments."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
