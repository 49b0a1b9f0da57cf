"""Weight-decay regularizers — counterpart of `paddle_tpu/regularizer.py`.

`L2Decay(c)` adds c * param to the gradient, `L1Decay(c)` adds
c * sign(param). A parameter carries one as its own `regularizer`
attribute, where `ParamAttr(regularizer=...)` puts it
(`nn/layer/common.py` `create_parameter`).
The optimizer's eager `step()` applies a parameter's own regularizer in
place of the optimizer's `weight_decay` (optimizer.py:219-227).

As an optimizer's `weight_decay`, `L2Decay(c)` is the float c. The
reference also takes `L1Decay(c)` there and applies it as the L2
coefficient c (optimizer.py:45-49); the port refuses it
(`optimizer.weight_decay_coeff`).
"""
import torch


class WeightDecayRegularizer:
    def __call__(self, param):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __call__(self, param):
        return self._coeff * param

    def __repr__(self):
        return f'L2Decay({self._coeff})'


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __call__(self, param):
        return self._coeff * torch.sign(param)

    def __repr__(self):
        return f'L1Decay({self._coeff})'
