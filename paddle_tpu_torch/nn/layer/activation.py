"""Activation layers — counterparts of
`paddle_tpu/nn/layer/activation.py`: thin wrappers of `ops.nn_ops`."""
import torch
from torch import nn

from ...ops import nn_ops as F
from .. import initializer as I
from .common import create_parameter


def _simple(name, fn, **defaults):
    class _Act(nn.Module):
        def __init__(self, name=None, **kwargs):
            super().__init__()
            self._kwargs = {**defaults, **kwargs}

        def forward(self, x):
            return fn(x, **self._kwargs)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple('ReLU', F.relu)
ReLU6 = _simple('ReLU6', F.relu6)
Sigmoid = _simple('Sigmoid', F.sigmoid)
Tanh = _simple('Tanh', F.tanh)
GELU = _simple('GELU', F.gelu)
ELU = _simple('ELU', F.elu, alpha=1.0)
SELU = _simple('SELU', F.selu)
CELU = _simple('CELU', F.celu, alpha=1.0)
Silu = _simple('Silu', F.silu)
Swish = _simple('Swish', F.swish)
Mish = _simple('Mish', F.mish)
Hardswish = _simple('Hardswish', F.hardswish)
Hardsigmoid = _simple('Hardsigmoid', F.hardsigmoid)
Hardshrink = _simple('Hardshrink', F.hardshrink, threshold=0.5)
Hardtanh = _simple('Hardtanh', F.hardtanh, min=-1.0, max=1.0)
Softshrink = _simple('Softshrink', F.softshrink, threshold=0.5)
Softplus = _simple('Softplus', F.softplus, beta=1.0, threshold=20.0)
Softsign = _simple('Softsign', F.softsign)
Tanhshrink = _simple('Tanhshrink', F.tanhshrink)
ThresholdedReLU = _simple('ThresholdedReLU', F.thresholded_relu,
                          threshold=1.0)
LogSigmoid = _simple('LogSigmoid', F.log_sigmoid)
Maxout = _simple('Maxout', F.maxout, groups=1)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)


class PReLU(nn.Module):
    """where(x > 0, x, x·w), w starting at `init`."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format='NCHW', name=None, device=None, dtype=None):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter(
            [num_parameters], weight_attr, default_initializer=I.Constant(init),
            device=device, dtype=dtype)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Softmax(nn.Module):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self._axis)


class LogSoftmax(nn.Module):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self._axis)
