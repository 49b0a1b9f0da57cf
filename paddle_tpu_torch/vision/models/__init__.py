"""The vision model zoo — counterpart of `paddle_tpu/vision/models`:
LeNet, ResNet-18 to -152, VGG-11 to -19 and MobileNet V1/V2. SSD waits
for detection (ROADMAP Queue 1 item 9c).

Every model takes `device`, `dtype` and an optional `generator` for its
layers' initializers, after paddle's own arguments."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,  # noqa: F401
                        mobilenet_v2)
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
