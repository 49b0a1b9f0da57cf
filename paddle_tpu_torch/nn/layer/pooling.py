"""2-D pooling layers — counterparts of
`paddle_tpu/nn/layer/pooling.py` (`AvgPool2D`, `MaxPool2D`,
`AdaptiveAvgPool2D`, `AdaptiveMaxPool2D`); `ops.nn_ops` says how each
pools."""
from torch import nn

from ...ops import nn_ops as F


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format='NCHW', name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format)

    def forward(self, x):
        k, s, p, rm, cm, df = self.args
        return F.max_pool2d(x, k, s, p, return_mask=rm, ceil_mode=cm,
                            data_format=df)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format='NCHW',
                 name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format)

    def forward(self, x):
        k, s, p, cm, ex, dv, df = self.args
        return F.avg_pool2d(x, k, s, p, ceil_mode=cm, exclusive=ex,
                            divisor_override=dv, data_format=df)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format='NCHW', name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)


class AdaptiveMaxPool2D(nn.Module):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._output_size, self._return_mask)
