"""MobileNet V1 and V2 — counterpart of
`paddle_tpu/vision/models/mobilenet.py`; the depthwise convs run
`conv2d` with `groups` equal to the channels."""
from torch import nn

from ... import nn as pnn
from ...ops import nn_ops as F
from .resnet import _refuse_pretrained


class ConvBNLayer(nn.Module):
    """Conv (no bias), BatchNorm2D, then ReLU6 ('relu6'), ReLU (any
    other truthy `act`) or nothing."""

    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act='relu6', device=None, dtype=None, generator=None):
        super().__init__()
        self.conv = pnn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                               groups=groups, bias_attr=False, device=device,
                               dtype=dtype, generator=generator)
        self.bn = pnn.BatchNorm2D(out_c, device=device, dtype=dtype)
        self.act = pnn.ReLU6() if act == 'relu6' else (
            pnn.ReLU() if act else None)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_c, out_c1, out_c2, stride, scale=1.0, **kw):
        super().__init__()
        c1, c2 = int(out_c1 * scale), int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride, 1, groups=in_c, act='relu',
                              **kw)
        self.pw = ConvBNLayer(c1, c2, 1, 1, 0, act='relu', **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)
        self.conv1 = ConvBNLayer(3, s(32), 3, 2, 1, act='relu', **kw)
        cfg = [(32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
               (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2),
               (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 512, 1),
               (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 1024, 2),
               (1024, 1024, 1024, 1)]
        self.blocks = pnn.Sequential(*[
            DepthwiseSeparable(s(in_c), c1, c2, stride, scale, **kw)
            for in_c, c1, c2, stride in cfg])
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = pnn.Linear(s(1024), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, **kw))
        layers += [ConvBNLayer(hidden, hidden, 3, stride, 1, groups=hidden,
                               **kw),
                   pnn.Conv2D(hidden, oup, 1, bias_attr=False, **kw),
                   pnn.BatchNorm2D(oup, device=device, dtype=dtype)]
        self.conv = pnn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = int(32 * scale)
        features = [ConvBNLayer(3, input_channel, 3, 2, 1, **kw)]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, **kw))
                input_channel = out_c
        self.last_channel = int(1280 * max(1.0, scale))
        features.append(ConvBNLayer(input_channel, self.last_channel, 1,
                                    **kw))
        self.features = pnn.Sequential(*features)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Dropout(0.2),
                pnn.Linear(self.last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _refuse_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _refuse_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
