"""Linear, Embedding, Dropout, Flatten and Identity with paddle's
parameter names and layouts — counterparts of
`paddle_tpu/nn/layer/common.py` — and `ParamAttr` with the
`create_parameter` rule the layers share (`paddle_tpu/nn/layer/base.py:
19-44`, `:97-115`).

A layer's `weight_attr` / `bias_attr` is anything `ParamAttr._to_attr`
takes: None (the layer's default), a `ParamAttr`, an initializer, a
name, or `False` (no such parameter). The parameter is created on the
given `device`/`dtype` (torch factory kwargs), filled by the attr's
initializer or the layer's default (XavierUniform weights, zero bias),
drawn from the layer's optional `torch.Generator` (else the package
generator), and carries the attr as attributes the optimizers and clips
read: `optimize_attr['learning_rate']` (a multiplier of the learning
rate in the eager `step()`), `regularizer`, `need_clip`, `trainable`
(False: `requires_grad` off) and, when given, the name as `param_name`
(a torch tensor's `name` is read-only).
"""
import torch
from torch import nn

from ...ops import nn_ops as F
from .. import initializer as I


class ParamAttr:
    """Parity: fluid/param_attr.py ParamAttr."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f'a parameter attribute must be None, a ParamAttr, '
                        f'an initializer, a name or False, got {attr!r}')


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None, device=None, dtype=None,
                     generator=None):
    """The parameter `attr` describes (None when it is False), as the
    reference's `Layer.create_parameter` (base.py:97-115) makes it."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    p = nn.Parameter(torch.empty(tuple(shape), device=device, dtype=dtype),
                     requires_grad=bool(attr.trainable))
    init = attr.initializer or default_initializer or (
        I.Constant(0.0) if is_bias else I.XavierUniform())
    init(p, generator)
    p.optimize_attr = {'learning_rate': attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    p.trainable = attr.trainable
    p.is_bias = is_bias
    if attr.name is not None:
        p.param_name = attr.name       # torch's Tensor.name is read-only
    return p


def xavier_uniform_(w, generator=None):
    """paddle's XavierUniform on a 2-D weight: fan_in = shape[0],
    fan_out = shape[1] (paddle lays Linear weights out [in, out])."""
    return I.XavierUniform()(w, generator)


class Linear(nn.Module):
    """y = x @ W + b with W of shape [in, out] (paddle layout)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = create_parameter([in_features, out_features],
                                       weight_attr, **kw)
        self.bias = create_parameter([out_features], bias_attr, True, **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f'in_features={self.in_features}, ' \
               f'out_features={self.out_features}'


class Embedding(nn.Module):
    """Lookup table [num_embeddings, embedding_dim]; the `padding_idx`
    row starts at 0 and its ids look up zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], weight_attr, device=device,
            dtype=dtype, generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

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
