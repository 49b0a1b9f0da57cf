"""LeNet — counterpart of `paddle_tpu/vision/models/lenet.py` (:5-28),
the `lenet_mnist` leg's model (`bench.py:333-360`)."""
from torch import nn

from ... import nn as pnn
from ...ops import nn_ops as F


class LeNet(nn.Module):
    """Two conv + ReLU + 2x2 max-pool stages over [N, 1, 28, 28], then
    three linears (no activation between them, as the reference)."""

    def __init__(self, num_classes=10, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_classes = num_classes
        self.features = pnn.Sequential(
            pnn.Conv2D(1, 6, 3, stride=1, padding=1, **kw), pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
            pnn.Conv2D(6, 16, 5, stride=1, padding=0, **kw), pnn.ReLU(),
            pnn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = pnn.Sequential(pnn.Linear(400, 120, **kw),
                                     pnn.Linear(120, 84, **kw),
                                     pnn.Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x
