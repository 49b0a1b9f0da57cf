"""The port's input side against `paddle_tpu`'s: `io` (datasets,
samplers, `DataLoader` at 0 and 2 workers), `paddle.save` / `load`
across the two packages, the datasets and the transforms.

- Every sampler, `random_split` and the composite datasets yield the
  reference's indices and samples under one `np.random.seed`.
- `DataLoader` at 0 and 2 worker processes yields the reference's
  batches (the reference's sampler runs in its parent whatever its
  worker count, so its in-process batches are its batches), as CPU
  tensors; `get_worker_info` is set inside a worker.
- `save` / `load`: a state dict written by either package loads in the
  other, bit for bit; the unpickler refuses a foreign global.
- MNIST, Cifar10, Flowers, VOC2012, DatasetFolder, ImageFolder and the
  text datasets are byte-equal to the reference's; so are the
  transforms' outputs on numpy images (the random ones under one seed).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import io as jio
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.text import datasets as jtext
from paddle_tpu.vision import datasets as jvds
from paddle_tpu.vision import transforms as jT
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.text import datasets as ttext
from paddle_tpu_torch.vision import datasets as tvds
from paddle_tpu_torch.vision import transforms as tT


def _np(x):
    if isinstance(x, Tensor):
        return np.asarray(x.data)
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _drawn(mod, make, seed=5):
    np.random.seed(seed)
    return list(make(mod))


SAMPLERS = {
    'sequence': lambda m: m.SequenceSampler(list(range(7))),
    'random': lambda m: m.RandomSampler(list(range(9))),
    'random_replacement': lambda m: m.RandomSampler(
        list(range(9)), replacement=True, num_samples=12),
    'weighted': lambda m: m.WeightedRandomSampler([0.1, 2, 0.5, 1, 3], 8),
    'batch_shuffle': lambda m: m.BatchSampler(list(range(10)), shuffle=True,
                                              batch_size=3),
    'batch_drop_last': lambda m: m.BatchSampler(
        sampler=m.SequenceSampler(list(range(10))), batch_size=4,
        drop_last=True),
    'distributed': lambda m: m.DistributedBatchSampler(
        list(range(11)), batch_size=2, num_replicas=3, rank=1,
        shuffle=True),
}


@pytest.mark.parametrize('name', sorted(SAMPLERS))
def test_samplers_match_reference(name):
    want = _drawn(jio, SAMPLERS[name])
    got = _drawn(tio, SAMPLERS[name])
    assert got == want
    assert len(SAMPLERS[name](tio)) == len(SAMPLERS[name](jio))


def test_datasets_and_split_match_reference():
    a = np.arange(24, dtype=np.float32).reshape(8, 3)
    b = np.arange(8, dtype=np.int64)
    for make in (lambda m: m.TensorDataset([a, b]),
                 lambda m: m.ComposeDataset([m.TensorDataset([a]),
                                             m.TensorDataset([a, b])]),
                 lambda m: m.Subset(m.TensorDataset([a, b]), [5, 1, 3])):
        jd, td = make(jio), make(tio)
        assert len(jd) == len(td)
        for i in range(len(td)):
            _same(td[i], jd[i])
    chain = lambda m: [x for x in m.ChainDataset([range(3), range(4, 6)])]
    assert chain(tio) == chain(jio)
    np.random.seed(1)
    jsplit = [s.indices for s in jio.random_split(list(range(10)), [3, 7])]
    np.random.seed(1)
    tsplit = [s.indices for s in tio.random_split(list(range(10)), [3, 7])]
    assert tsplit == jsplit


@pytest.mark.parametrize('workers', [0, 2])
def test_dataloader_batches_match_reference(workers):
    ds = tvds.MNIST(mode='test')
    np.random.seed(3)
    want = [(_np(x), _np(y)) for x, y in jio.DataLoader(
        jvds.MNIST(mode='test'), batch_size=100, shuffle=True)]
    np.random.seed(3)
    got = list(tio.DataLoader(ds, batch_size=100, shuffle=True,
                              num_workers=workers))
    assert len(got) == len(want) == 6
    for (x, y), (wx, wy) in zip(got, want):
        assert x.device.type == 'cpu' and isinstance(x, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)


class _WorkerIds(tio.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.asarray([i, -1 if info is None else info.num_workers])


def test_worker_info_and_collate():
    got = np.concatenate([b.numpy() for b in tio.DataLoader(
        _WorkerIds(), batch_size=2, num_workers=2)])
    assert got[:, 0].tolist() == [0, 1, 2, 3] and (got[:, 1] == 2).all()
    assert tio.get_worker_info() is None
    batch = tio.default_collate_fn([(1, 2.5, {'a': np.ones(2)}),
                                    (3, 0.5, {'a': np.zeros(2)})])
    assert batch[0].dtype == torch.int64 and batch[1].dtype == torch.float32
    assert batch[2]['a'].shape == (2, 2)


def test_save_load_round_trips_across_packages(tmp_path):
    rng = np.random.RandomState(0)
    sd = {'w': rng.randn(3, 4).astype(np.float32),
          'ids': rng.randint(0, 9, 5).astype(np.int64),
          'nested': {'b': rng.randn(2).astype(np.float32)}, '@step': 3}
    tpaddle.save({k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                      else v) for k, v in sd.items()},
                 str(tmp_path / 'port.pdparams'))
    back = jpaddle.load(str(tmp_path / 'port.pdparams'))
    jpaddle.save({k: (Tensor(v) if isinstance(v, np.ndarray) else v)
                  for k, v in sd.items()}, str(tmp_path / 'ref.pdparams'))
    ours = tpaddle.load(str(tmp_path / 'ref.pdparams'))
    for loaded in (back, ours):
        for k in ('w', 'ids'):
            np.testing.assert_array_equal(_np(loaded[k]), sd[k])
        np.testing.assert_array_equal(_np(loaded['nested']['b']),
                                      sd['nested']['b'])
        assert loaded['@step'] == 3
    # the reference's Tensor holds int64 as int32 (JAX without x64)
    assert isinstance(ours['w'], torch.Tensor)
    assert tpaddle.load(str(tmp_path / 'port.pdparams'))['ids'].dtype == \
        torch.int64
    bf = tpaddle.load(str(tmp_path / 'port.pdparams'), return_numpy=True)
    assert isinstance(bf['w'], np.ndarray)


def test_load_refuses_a_foreign_global(tmp_path):
    path = tmp_path / 'evil.pdparams'
    with open(path, 'wb') as f:
        pickle.dump({'x': os.path.join}, f, protocol=4)
    with pytest.raises(pickle.UnpicklingError, match='refusing'):
        tpaddle.load(str(path))


VISION = [('MNIST', {'mode': 'train'}), ('MNIST', {'mode': 'test'}),
          ('Cifar10', {}), ('Flowers', {'mode': 'test'}),
          ('VOC2012', {'mode': 'test'})]
TEXT = [('Imdb', {}), ('Imikolov', {'mode': 'test'}), ('UCIHousing', {}),
        ('WMT14', {'mode': 'test'}), ('WMT16', {}), ('Conll05st', {}),
        ('Movielens', {'mode': 'test'})]


@pytest.mark.parametrize('mod,name,kw', [(tvds, n, k) for n, k in VISION]
                         + [(ttext, n, k) for n, k in TEXT],
                         ids=[n for n, _ in VISION + TEXT])
def test_datasets_byte_equal(mod, name, kw):
    ref = (jvds if mod is tvds else jtext)
    jd, td = getattr(ref, name)(**kw), getattr(mod, name)(**kw)
    assert len(jd) == len(td)
    for i in sorted({0, 1, len(td) // 2, len(td) - 1}):
        _same(td[i], jd[i])


def test_folders_byte_equal(tmp_path):
    rng = np.random.RandomState(0)
    for c in ('cat', 'dog'):
        os.makedirs(tmp_path / c / 'sub')
        for k in range(2):
            np.save(tmp_path / c / f'{k}.npy',
                    rng.randint(0, 255, (4, 4, 3)).astype(np.uint8))
        np.save(tmp_path / c / 'sub' / 'x.npy', np.zeros((4, 4, 3)))
    for cls in ('DatasetFolder', 'ImageFolder'):
        jd = getattr(jvds, cls)(str(tmp_path))
        td = getattr(tvds, cls)(str(tmp_path))
        assert len(jd) == len(td) and [s for s in jd.samples] == td.samples
        for i in range(len(td)):
            _same(td[i], jd[i])


TRANSFORMS = [
    lambda T: T.Compose([T.Resize(20), T.CenterCrop(16)]),
    lambda T: T.Resize((12, 30)),
    lambda T: T.RandomCrop(10, padding=2),
    lambda T: T.RandomResizedCrop(14),
    lambda T: T.RandomHorizontalFlip(0.7),
    lambda T: T.Compose([T.Transpose(), T.Normalize([120.0, 110, 100],
                                                    [50.0, 60, 70])]),
    lambda T: T.BrightnessTransform(0.4),
    lambda T: T.ToTensor(),
    lambda T: lambda img: T.hflip(T.resize(img, 9)),
    lambda T: lambda img: T.to_tensor(img, data_format='HWC'),
]


@pytest.mark.parametrize('i', range(len(TRANSFORMS)))
def test_transforms_byte_equal(i):
    img = np.random.RandomState(i).randint(0, 255, (24, 32, 3)).astype(
        np.uint8)
    outs = []
    for T in (jT, tT):
        np.random.seed(i)
        outs.append([TRANSFORMS[i](T)(img) for _ in range(3)])
    for got, want in zip(outs[1], outs[0]):
        if isinstance(got, torch.Tensor):
            assert i >= 7 and got.device.type == 'cpu'
        _same(got, want)
