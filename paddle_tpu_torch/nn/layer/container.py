"""Sequential and LayerList — counterparts of
`paddle_tpu/nn/layer/container.py` (:11-30, :40-81), with the
reference's sublayer names, so parameter and buffer names match the JAX
model's (`features.0.weight`, `layer1.0.bn1._mean`)."""
import collections

from torch import nn


class Sequential(nn.Sequential):
    """Calls its sublayers in order. Sublayers are named '0', '1', ...,
    or by the keys of one OrderedDict, or by the first item of a
    (name, layer) tuple among them."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            named = layers[0]
        else:
            named = collections.OrderedDict(
                layer if isinstance(layer, tuple) else (str(i), layer)
                for i, layer in enumerate(layers))
        super().__init__(named)


class LayerList(nn.ModuleList):
    """paddle's LayerList: sublayers named by their index."""
