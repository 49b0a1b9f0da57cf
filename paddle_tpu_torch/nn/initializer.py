"""Weight initializers — the counterparts of
`paddle_tpu/nn/initializer.py` that the port's layers use by default:
`Constant` and `XavierUniform` (with a layer's own fan_in, as the
convolutions give it). An initializer fills a tensor in place,
`init(tensor, generator=None)`, drawing from the given `torch.Generator`
(the reference draws from its global key stream). Fans follow the
reference's `_fan_in_out` (:56-65): a 2-D weight is [in, out]; a conv
weight [out, in/groups, *k] has fan_in in·k and fan_out out·k.
"""
import math

import torch


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) >= 3:
        rf = math.prod(shape[2:])
        return shape[1] * rf, shape[0] * rf
    n = math.prod(shape) if shape else 1
    return n, n


class Constant:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.fill_(self.value)


class XavierUniform:
    """U(-a, a), a = gain·sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, tensor, generator=None):
        fi, fo = _fan_in_out(tensor.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        a = self.gain * math.sqrt(6.0 / (fi + fo))
        with torch.no_grad():
            return tensor.uniform_(-a, a, generator=generator)
