"""Image transforms — counterpart of `paddle_tpu/vision/transforms`."""
from .transforms import (Compose, Resize, RandomCrop, CenterCrop,  # noqa: F401
                         RandomHorizontalFlip, Normalize, ToTensor,
                         Transpose, RandomResizedCrop, BrightnessTransform,
                         normalize, to_tensor, resize, hflip)
