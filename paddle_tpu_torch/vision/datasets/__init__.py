"""Vision datasets — counterpart of `paddle_tpu/vision/datasets`: MNIST
(and FashionMNIST), Cifar10/100, Flowers, VOC2012, DatasetFolder and
ImageFolder. MNIST reads the idx files cached under
`utils.download.DATA_HOME` (the reference's path) when they are there,
else builds the reference's deterministic synthetic set; the others are
the reference's synthetic sets. Samples are numpy arrays, byte-equal to
the reference's; nothing is downloaded."""
import gzip
import os
import struct

import numpy as np

from ...io import Dataset
from ...utils.download import DATA_HOME


class MNIST(Dataset):
    """Parity: paddle.vision.datasets.MNIST. Falls back to a deterministic
    synthetic digit set when the real files are absent (zero egress)."""

    def __init__(self, image_path=None, label_path=None, mode='train',
                 transform=None, download=True, backend='cv2'):
        self.mode = mode
        self.transform = transform
        images_file = image_path or os.path.join(
            DATA_HOME, 'mnist',
            f"{'train' if mode == 'train' else 't10k'}-images-idx3-ubyte.gz")
        labels_file = label_path or os.path.join(
            DATA_HOME, 'mnist',
            f"{'train' if mode == 'train' else 't10k'}-labels-idx1-ubyte.gz")
        if os.path.exists(images_file) and os.path.exists(labels_file):
            with gzip.open(images_file, 'rb') as f:
                magic, num, rows, cols = struct.unpack('>IIII', f.read(16))
                self.images = np.frombuffer(f.read(), np.uint8).reshape(
                    num, rows, cols)
            with gzip.open(labels_file, 'rb') as f:
                struct.unpack('>II', f.read(8))
                self.labels = np.frombuffer(f.read(), np.uint8)
        else:
            n = 2048 if mode == 'train' else 512
            rng = np.random.RandomState(42 if mode == 'train' else 7)
            self.labels = rng.randint(0, 10, n).astype(np.uint8)
            # class prototypes fixed across splits so train/test share a
            # distribution; per-split rng only adds noise
            base = np.random.RandomState(123).rand(10, 28, 28)
            self.images = np.clip(
                (base[self.labels] * 255 +
                 rng.randn(n, 28, 28) * 16), 0, 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None, :, :] / 255.0
        label = np.asarray([self.labels[idx]], dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode='train', transform=None,
                 download=True, backend='cv2'):
        self.transform = transform
        n = 1024 if mode == 'train' else 256
        rng = np.random.RandomState(0 if mode == 'train' else 1)
        self.labels = rng.randint(0, 10, n).astype(np.int64)
        self.images = rng.randint(0, 255, (n, 3, 32, 32)).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], dtype=np.int64)

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    pass


class Flowers(Dataset):
    """Parity: paddle.vision.datasets.Flowers (102 classes); synthetic
    fallback under zero egress."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode='train', transform=None, download=True,
                 backend='cv2'):
        self.transform = transform
        n = 512 if mode == 'train' else 128
        rng = np.random.RandomState(3 if mode == 'train' else 4)
        self.labels = rng.randint(0, 102, n).astype(np.int64)
        self.images = rng.randint(0, 255, (n, 3, 64, 64)).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], dtype=np.int64)

    def __len__(self):
        return len(self.labels)


class VOC2012(Dataset):
    """Parity: paddle.vision.datasets.VOC2012 (segmentation); synthetic
    image/mask pairs under zero egress."""

    def __init__(self, data_file=None, mode='train', transform=None,
                 download=True, backend='cv2'):
        self.transform = transform
        n = 128 if mode == 'train' else 32
        rng = np.random.RandomState(5 if mode == 'train' else 6)
        self.images = rng.randint(0, 255, (n, 3, 64, 64)).astype(np.uint8)
        self.masks = rng.randint(0, 21, (n, 64, 64)).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)


def _default_image_loader(path):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "ImageFolder needs PIL to decode images; pass a custom "
            "loader= (e.g. numpy .npy reader) in this environment"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.npy')


def _scan_files(root, extensions, is_valid_file):
    """Recursive sorted file discovery. `is_valid_file` receives the
    FULL path (paddle/torchvision DatasetFolder contract)."""
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            ok = (is_valid_file(path) if is_valid_file
                  else fname.lower().endswith(extensions))
            if ok:
                out.append(path)
    return out


def _load_sample(path, loader):
    """A user loader always wins; the default path decodes .npy (any
    case) with numpy and everything else with PIL."""
    if loader is not None:
        return loader(path)
    if path.lower().endswith('.npy'):
        return np.load(path)
    return _default_image_loader(path)


class DatasetFolder(Dataset):
    """Parity: paddle.vision.datasets.DatasetFolder — one class per
    subdirectory, samples discovered recursively."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader
        extensions = tuple(e.lower() for e in
                           (extensions or IMG_EXTENSIONS))
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class subdirectories under {root!r}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for path in _scan_files(os.path.join(root, c), extensions,
                                    is_valid_file):
                self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no samples with extensions {extensions} "
                             f"under {root!r}")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = _load_sample(path, self.loader)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([target], dtype=np.int64)

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """Parity: paddle.vision.datasets.ImageFolder — like DatasetFolder
    but unlabeled (flat or nested files, returns images only)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader
        extensions = tuple(e.lower() for e in
                           (extensions or IMG_EXTENSIONS))
        self.samples = _scan_files(root, extensions, is_valid_file)
        if not self.samples:
            raise ValueError(f"no images under {root!r}")

    def __getitem__(self, idx):
        img = _load_sample(self.samples[idx], self.loader)
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)
