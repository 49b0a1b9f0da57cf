"""The 2-D convolution layer — counterpart of
`paddle_tpu/nn/layer/conv.py` (`_ConvNd`, `Conv2D`, :9-67), NCHW inputs
and [out, in/groups, kh, kw] weights. The weight starts at paddle's default,
XavierUniform with fan_in (in/groups)·prod(k) (:30-33), drawn from the
optional `generator`; the bias at 0, or none with `bias_attr=False`.
"""
import math

import torch
from torch import nn

from ...ops import nn_ops as F
from .. import initializer as I
from .common import refuse_param_attr


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, nd, device, dtype, generator):
        super().__init__()
        has_bias = refuse_param_attr(weight_attr, bias_attr)
        if padding_mode != 'zeros':
            raise NotImplementedError(
                f'padding_mode={padding_mode!r} is not ported yet (ROADMAP '
                f'Queue 1 item 9c); the port pads with zeros')
        k = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = k
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        kw = {'device': device, 'dtype': dtype}
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *k, **kw))
        I.XavierUniform(fan_in=(in_channels // groups) * math.prod(k))(
            self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels, **kw))
                     if has_bias else None)

    def _args(self):
        return (self.weight, self.bias, self._stride, self._padding,
                self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f'{self._in_channels}, {self._out_channels}, '
                f'kernel_size={self._kernel_size}, stride={self._stride}')


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 2, device, dtype, generator)

    def forward(self, x):
        return F.conv2d(x, *self._args())
