"""Image transforms over numpy HWC arrays — counterpart of
`paddle_tpu/vision/transforms/transforms.py`, op for op: numpy in, numpy
out (a torch tensor is read back to the host first), and `to_tensor`
returns a CPU torch tensor. The random transforms draw from numpy's
global generator, as the reference's do.
"""
import numbers

import numpy as np
import torch


def _to_np(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def resize(img, size, interpolation='bilinear'):
    img = _to_np(img)
    if isinstance(size, int):
        h, w = img.shape[:2]
        if h < w:
            size = (size, int(size * w / h))
        else:
            size = (int(size * h / w), size)
    oh, ow = size
    h, w = img.shape[:2]
    ys = (np.arange(oh) * (h / oh)).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(ow) * (w / ow)).astype(np.int64).clip(0, w - 1)
    return img[ys][:, xs]


def hflip(img):
    return _to_np(img)[:, ::-1]


def normalize(img, mean, std, data_format='CHW', to_rgb=False):
    img = _to_np(img).astype(np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == 'CHW':
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    return (img - mean) / std


def to_tensor(img, data_format='CHW'):
    img = _to_np(img).astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if data_format == 'CHW':
        img = img.transpose(2, 0, 1)
    if img.max() > 1.5:
        img = img / 255.0
    return torch.from_numpy(np.ascontiguousarray(img))


class BaseTransform:
    def __call__(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class Resize(BaseTransform):
    def __init__(self, size, interpolation='bilinear', keys=None):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.padding = padding

    def __call__(self, img):
        img = _to_np(img)
        if self.padding:
            p = self.padding
            img = np.pad(img, [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2))
        h, w = img.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def __call__(self, img):
        img = _to_np(img)
        h, w = img.shape[:2]
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return img[i:i + th, j:j + tw]


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation='bilinear', keys=None):
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        img = _to_np(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target_area * ar)))
            th = int(round(np.sqrt(target_area / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = np.random.randint(0, h - th + 1)
                j = np.random.randint(0, w - tw + 1)
                return resize(img[i:i + th, j:j + tw], self.size)
        return resize(CenterCrop(min(h, w))(img), self.size)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return hflip(img)
        return _to_np(img)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format='CHW', to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std, self.data_format = mean, std, data_format

    def __call__(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class ToTensor(BaseTransform):
    def __init__(self, data_format='CHW', keys=None):
        self.data_format = data_format

    def __call__(self, img):
        return to_tensor(img, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def __call__(self, img):
        return _to_np(img).transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def __call__(self, img):
        img = _to_np(img).astype(np.float32)
        alpha = 1 + np.random.uniform(-self.value, self.value)
        return np.clip(img * alpha, 0, 255)
