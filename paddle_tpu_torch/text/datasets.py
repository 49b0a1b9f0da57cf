"""Text datasets — counterpart of `paddle_tpu/text/datasets.py`: Imdb,
Imikolov, UCIHousing, WMT14/WMT16, Conll05st and Movielens, the
reference's deterministic synthetic corpora (UCIHousing reads the
cached `housing.data` under `utils.download.DATA_HOME` when it is
there), byte-equal to the reference's. Nothing is downloaded."""
import os

import numpy as np

from ..io import Dataset
from ..utils.download import DATA_HOME

_WORDS = ('the a of to and in is it you that he was for on are with as his '
          'they at be this have from or one had by word but not what all '
          'were we when your can said there use an each which she do how '
          'their if').split()


def _synth_text(seed, n):
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n):
        ln = rng.randint(8, 64)
        docs.append([int(w) for w in rng.randint(0, len(_WORDS), ln)])
    return docs


class Imdb(Dataset):
    """Sentiment classification (parity: text/datasets/imdb.py)."""

    def __init__(self, data_file=None, mode='train', cutoff=150,
                 download=True):
        self.mode = mode
        n = 512 if mode == 'train' else 128
        self.docs = _synth_text(1 if mode == 'train' else 2, n)
        rng = np.random.RandomState(3)
        # label correlated with doc parity for learnability
        self.labels = np.array([sum(d) % 2 for d in self.docs], np.int64)
        self.word_idx = {w: i for i, w in enumerate(_WORDS)}

    def __getitem__(self, idx):
        return np.asarray(self.docs[idx], np.int64), self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """N-gram LM dataset (parity: text/datasets/imikolov.py)."""

    def __init__(self, data_file=None, data_type='NGRAM', window_size=5,
                 mode='train', min_word_freq=50, download=True):
        self.window_size = window_size
        # synthetic corpus follows a noisy deterministic chain so next-word
        # prediction is learnable (w_{t+1} = 3*w_t + 1 mod V, 10% noise)
        rng = np.random.RandomState(5 if mode == 'train' else 6)
        V = len(_WORDS)
        docs = []
        for _ in range(256 if mode == 'train' else 64):
            ln = rng.randint(16, 64)
            w = int(rng.randint(0, V))
            d = [w]
            for _ in range(ln - 1):
                if rng.rand() < 0.1:
                    w = int(rng.randint(0, V))
                else:
                    w = (3 * w + 1) % V
                d.append(w)
            docs.append(d)
        self.samples = []
        for d in docs:
            for i in range(len(d) - window_size + 1):
                self.samples.append(d[i:i + window_size])
        self.word_idx = {w: i for i, w in enumerate(_WORDS)}

    def __getitem__(self, idx):
        s = self.samples[idx]
        return tuple(np.asarray([t], np.int64) for t in s)

    def __len__(self):
        return len(self.samples)


class UCIHousing(Dataset):
    """Regression dataset (parity: text/datasets/uci_housing.py)."""

    def __init__(self, data_file=None, mode='train', download=True):
        path = data_file or os.path.join(DATA_HOME, 'uci_housing',
                                         'housing.data')
        if os.path.exists(path):
            data = np.loadtxt(path).astype('float32')
        else:
            rng = np.random.RandomState(7)
            x = rng.rand(506, 13).astype('float32')
            w = rng.randn(13, 1).astype('float32')
            y = x @ w + 0.1 * rng.randn(506, 1).astype('float32')
            data = np.concatenate([x, y], 1)
        x, y = data[:, :13], data[:, 13:]
        x = (x - x.mean(0)) / (x.std(0) + 1e-6)
        split = int(len(x) * 0.8)
        if mode == 'train':
            self.x, self.y = x[:split], y[:split]
        else:
            self.x, self.y = x[split:], y[split:]

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


class WMT14(Dataset):
    """Translation pairs (parity: text/datasets/wmt14.py)."""

    def __init__(self, data_file=None, mode='train', dict_size=1000,
                 download=True):
        n = 256 if mode == 'train' else 64
        rng = np.random.RandomState(11 if mode == 'train' else 12)
        self.src, self.tgt = [], []
        for _ in range(n):
            ln = rng.randint(4, 20)
            s = rng.randint(2, dict_size, ln)
            self.src.append(s.astype(np.int64))
            self.tgt.append(((s + 1) % dict_size).astype(np.int64))

    def __getitem__(self, idx):
        src = self.src[idx]
        tgt = self.tgt[idx]
        return src, tgt[:-1], tgt[1:]

    def __len__(self):
        return len(self.src)


class Conll05st(Dataset):
    """SRL dataset shell (parity: text/datasets/conll05.py)."""

    def __init__(self, data_file=None, mode='train', download=True):
        n = 128
        rng = np.random.RandomState(13)
        self.sents = [rng.randint(0, 60, rng.randint(5, 30)).astype(np.int64)
                      for _ in range(n)]
        self.labels = [np.asarray([int(t) % 5 for t in s], np.int64)
                       for s in self.sents]

    def __getitem__(self, idx):
        return self.sents[idx], self.labels[idx]

    def __len__(self):
        return len(self.sents)


class WMT16(WMT14):
    """Parity: paddle.text.datasets.WMT16 — reference signature
    (src_dict_size, trg_dict_size, lang); same synthetic pair shape."""

    def __init__(self, data_file=None, mode='train', src_dict_size=1000,
                 trg_dict_size=1000, lang='en', download=True):
        super().__init__(data_file=data_file, mode=mode,
                         dict_size=min(src_dict_size, trg_dict_size),
                         download=download)
        self.lang = lang


class Movielens(Dataset):
    """Parity: paddle.text.datasets.Movielens — (user features, movie
    features, rating) triples; synthetic under zero egress."""

    def __init__(self, data_file=None, mode='train', test_ratio=0.1,
                 rand_seed=0):
        n = 2048 if mode == 'train' else 256
        rng = np.random.RandomState(rand_seed + (0 if mode == 'train'
                                                 else 1))
        self.user_id = rng.randint(1, 6041, n).astype(np.int64)
        self.gender = rng.randint(0, 2, n).astype(np.int64)
        self.age = rng.randint(0, 7, n).astype(np.int64)
        self.job = rng.randint(0, 21, n).astype(np.int64)
        self.movie_id = rng.randint(1, 3953, n).astype(np.int64)
        self.category = rng.randint(0, 18, (n, 3)).astype(np.int64)
        self.title = rng.randint(0, 5000, (n, 4)).astype(np.int64)
        self.rating = (rng.randint(1, 6, n)).astype(np.float32)

    def __getitem__(self, idx):
        return (self.user_id[idx], self.gender[idx], self.age[idx],
                self.job[idx], self.movie_id[idx], self.category[idx],
                self.title[idx],
                np.asarray([self.rating[idx]], np.float32))

    def __len__(self):
        return len(self.rating)
