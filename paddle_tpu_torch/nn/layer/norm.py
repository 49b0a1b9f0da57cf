"""LayerNorm and the batch norms with paddle's parameter and buffer
names — counterparts of `paddle_tpu/nn/layer/norm.py` (:17-190). The
weight and the bias take a `ParamAttr` (`common.create_parameter`):
weight from 1 and bias from 0 unless the attr names an initializer,
none when the attr is False."""
import torch
from torch import nn

from ...ops import nn_ops as F
from .. import initializer as I
from .common import create_parameter


class _BatchNormBase(nn.Module):
    """Batch norm over the channel axis (1 for NC* layouts, the last for
    the channels-last ones): weight from 1, bias from 0 (none when its
    attr is False), and the running statistics in fp32 buffers `_mean`
    (from 0) and `_variance` (from 1), whatever the parameters' dtype.
    In training the batch statistics normalise and the buffers move in
    place (`momentum` is the share kept; `ops.nn_ops.batch_norm`), once a
    forward; in eval, or with `use_global_stats`, the buffers
    normalise."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = {'device': device, 'dtype': dtype}
        self.weight = create_parameter([num_features], weight_attr,
                                       default_initializer=I.Constant(1.0),
                                       **kw)
        self.bias = create_parameter([num_features], bias_attr, True, **kw)
        self.register_buffer('_mean', torch.zeros(
            num_features, device=device, dtype=torch.float32))
        self.register_buffer('_variance', torch.ones(
            num_features, device=device, dtype=torch.float32))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f'num_features={self._num_features}, momentum={self._momentum}'


class BatchNorm(_BatchNormBase):
    """The fluid-style BatchNorm (any rank), with an optional activation
    by name after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype=None,
                 data_layout='NCHW', in_place=False, use_global_stats=False,
                 device=None, **kwargs):
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-rank batch norm at one rank: the local batch norm, as the
    reference's outside an SPMD region (:92-95). The cross-rank moments
    come with the multi-GPU engines (ROADMAP Queue 1 item 7)."""


class LayerNorm(nn.Module):
    """Normalises over `normalized_shape` (trailing axes); weight starts
    at 1 and bias at 0, as paddle's defaults."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        kw = {'device': device, 'dtype': dtype}
        self.weight = create_parameter(self._normalized_shape, weight_attr,
                                       default_initializer=I.Constant(1.0),
                                       **kw)
        self.bias = create_parameter(self._normalized_shape, bias_attr, True,
                                     **kw)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f'normalized_shape={self._normalized_shape}'
