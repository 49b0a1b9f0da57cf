"""VGG — counterpart of `paddle_tpu/vision/models/vgg.py`."""
from torch import nn

from ... import nn as pnn
from ...ops import nn_ops as F
from .resnet import _refuse_pretrained

cfgs = {
    'A': [64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'],
    'B': [64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M', 512,
          512, 'M'],
    'D': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512,
          'M', 512, 512, 512, 'M'],
    'E': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M', 512, 512,
          512, 512, 'M', 512, 512, 512, 512, 'M'],
}


def make_layers(cfg, batch_norm=False, device=None, dtype=None,
                generator=None):
    """3x3 convs (with batch norm if asked) and ReLUs, 2x2 max pools at
    each 'M'."""
    layers = []
    in_channels = 3
    for v in cfg:
        if v == 'M':
            layers.append(pnn.MaxPool2D(2, 2))
            continue
        layers.append(pnn.Conv2D(in_channels, v, 3, padding=1, device=device,
                                 dtype=dtype, generator=generator))
        if batch_norm:
            layers.append(pnn.BatchNorm2D(v, device=device, dtype=dtype))
        layers.append(pnn.ReLU())
        in_channels = v
    return pnn.Sequential(*layers)


class VGG(nn.Module):
    """`features`, a 7x7 adaptive average pool and the three-linear
    classifier with dropout 0.5."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Linear(512 * 7 * 7, 4096, **kw), pnn.ReLU(),
                pnn.Dropout(), pnn.Linear(4096, 4096, **kw), pnn.ReLU(),
                pnn.Dropout(), pnn.Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm=False, pretrained=False, device=None, dtype=None,
         generator=None, **kwargs):
    _refuse_pretrained(pretrained)
    kw = dict(device=device, dtype=dtype, generator=generator)
    return VGG(make_layers(cfgs[cfg], batch_norm, **kw), **kwargs, **kw)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('A', batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('B', batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('D', batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('E', batch_norm, pretrained, **kwargs)
