"""The convolution layers — counterparts of `paddle_tpu/nn/layer/conv.py`
(:9-134): `Conv1D`, `Conv2D`, `Conv3D` with [out, in/groups, *k] weights,
and `Conv1DTranspose`, `Conv2DTranspose`, `Conv3DTranspose` with [in,
out/groups, *k] weights, in the channels-first layout or the
channels-last one `data_format` names (the weight's layout is the same
in both). The weight starts at the reference's default, XavierUniform
with fan_in (in/groups)·prod(k) (:28-33), the bias at 0; either takes a
`ParamAttr` (`common.create_parameter`), and `bias_attr=False` drops the
bias. Parameters are drawn from the optional `generator`, else the
package generator.

`padding_mode` other than 'zeros' raises: the reference takes
'reflect', 'replicate' and 'circular' and pads with zeros all the same
(the layers drop the argument, :37-60), and the port does not copy a
silent wrong answer.
"""
import math

from torch import nn

from ...ops import nn_ops as F
from .. import initializer as I
from .common import create_parameter


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, nd, device, dtype, generator,
                 transpose=False, output_padding=0):
        super().__init__()
        if padding_mode != 'zeros':
            raise NotImplementedError(
                f'padding_mode={padding_mode!r} is refused: the reference '
                f'drops the argument and pads with zeros without saying '
                f'so; pad the input with ops.manip.pad (mode=...) and use '
                f"padding_mode='zeros'")
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
        self._output_padding = output_padding
        shape = [in_channels, out_channels // groups, *k] if transpose \
            else [out_channels, in_channels // groups, *k]
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = create_parameter(
            shape, weight_attr, default_initializer=I.XavierUniform(
                fan_in=(in_channels // groups) * math.prod(k)), **kw)
        self.bias = create_parameter([out_channels], bias_attr, True, **kw)

    def _args(self):
        return (self.weight, self.bias, self._stride, self._padding,
                self._dilation, self._groups, self._data_format)

    def _transpose_args(self, output_size):
        return dict(stride=self._stride, padding=self._padding,
                    output_padding=self._output_padding,
                    dilation=self._dilation, groups=self._groups,
                    output_size=output_size, data_format=self._data_format)

    def extra_repr(self):
        return (f'{self._in_channels}, {self._out_channels}, '
                f'kernel_size={self._kernel_size}, stride={self._stride}')


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCL',
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 1, device, dtype, generator)

    def forward(self, x):
        return F.conv1d(x, *self._args())


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


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 3, device, dtype, generator)

    def forward(self, x):
        return F.conv3d(x, *self._args())


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format='NCL',
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, 'zeros', weight_attr,
                         bias_attr, data_format, 1, device, dtype, generator,
                         transpose=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias,
                                  **self._transpose_args(output_size))


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, 'zeros', weight_attr,
                         bias_attr, data_format, 2, device, dtype, generator,
                         transpose=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias,
                                  **self._transpose_args(output_size))


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, 'zeros', weight_attr,
                         bias_attr, data_format, 3, device, dtype, generator,
                         transpose=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias,
                                  **self._transpose_args(output_size))
