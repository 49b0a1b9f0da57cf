"""ResNet — counterpart of `paddle_tpu/vision/models/resnet.py`
(`BasicBlock`, `BottleneckBlock`, `ResNet`, `resnet18`-`resnet152`), the
`resnet50_dp_bf16` leg's model (`bench.py:362-411`). Convolutions have
no bias; every one is followed by a BatchNorm2D."""
import functools

from torch import nn

from ... import nn as pnn
from ...ops import nn_ops as F


class BasicBlock(nn.Module):
    """Two 3x3 convs with batch norm; the shortcut is `downsample(x)`
    when given. `groups`, `base_width` and `dilation` are taken and
    unused, as in the reference."""
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        norm_layer = norm_layer or functools.partial(
            pnn.BatchNorm2D, device=device, dtype=dtype)
        self.conv1 = pnn.Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                                bias_attr=False, **kw)
        self.bn1 = norm_layer(planes)
        self.relu = pnn.ReLU()
        self.conv2 = pnn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                                **kw)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    """1x1 reduce, 3x3 (strided, grouped, dilated), 1x1 expand by 4,
    each with batch norm."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        norm_layer = norm_layer or functools.partial(
            pnn.BatchNorm2D, device=device, dtype=dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = pnn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width)
        self.conv2 = pnn.Conv2D(width, width, 3, padding=dilation,
                                stride=stride, groups=groups,
                                dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width)
        self.conv3 = pnn.Conv2D(width, planes * self.expansion, 1,
                                bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = pnn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """The stem (7x7 stride-2 conv, batch norm, ReLU, 3x3 stride-2 max
    pool), four stages of `block`, the global average pool and the
    classifier."""
    LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
              101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, dtype=None,
                 generator=None):
        super().__init__()
        layers = self.LAYERS[depth]
        self._kw = dict(device=device, dtype=dtype, generator=generator)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = functools.partial(pnn.BatchNorm2D, device=device,
                                             dtype=dtype)
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = pnn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                bias_attr=False, **self._kw)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = pnn.ReLU()
        self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = pnn.Linear(512 * block.expansion, num_classes,
                                 **self._kw)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = pnn.Sequential(
                pnn.Conv2D(self.inplanes, planes * block.expansion, 1,
                           stride=stride, bias_attr=False, **self._kw),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer,
                        **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **self._kw))
        return pnn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def _refuse_pretrained(pretrained):
    """The reference takes `pretrained` and ignores it, returning random
    weights; the port refuses it (ROADMAP Queue 3)."""
    if pretrained:
        raise NotImplementedError(
            'pretrained=True: the weights need a download, which the port '
            'does not make; build from a seed and bridge or load weights')


def _resnet(block, depth, pretrained=False, **kwargs):
    _refuse_pretrained(pretrained)
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
