"""Text models — counterpart of `paddle_tpu/text/models.py`: the BiLSTM
sentiment classifier of the hapi imdb example (embedding, a (bi)LSTM
stack, a masked mean-pool, a linear head) and the bag-of-embeddings
classifier. The LSTM is `nn.LSTM`: one cuDNN call for the whole stack on
the card. Both are built on the card unless the caller passes
`device='cpu'`."""
import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device


def _masked_mean(x, ids, padding_idx):
    """The mean of x [N, T, C] over the positions whose id is not the
    padding id (a row of padding only divides by 1)."""
    mask = (ids != padding_idx).to(x.dtype)
    summed = (x * mask.unsqueeze(-1)).sum(dim=1)
    return summed / torch.clamp(mask.sum(dim=1), min=1.0).unsqueeze(-1)


class LSTMSentiment(nn.Module):
    """Embedding -> LSTM (optionally bidirectional) -> masked mean-pool
    -> FC head."""

    def __init__(self, vocab_size=10000, embed_dim=64, hidden=64,
                 num_classes=2, num_layers=1, direction='forward',
                 dropout=0.0, padding_idx=0, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if dropout:
            raise NotImplementedError(
                "inter-layer RNN dropout is not applied by the LSTM stack "
                "(the reference refuses it too); pass dropout=0")
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.embedding = pnn.Embedding(vocab_size, embed_dim,
                                       padding_idx=padding_idx, **kw)
        self.lstm = pnn.LSTM(embed_dim, hidden, num_layers=num_layers,
                             direction=direction, **kw)
        n_dir = 2 if direction in ('bidirect', 'bidirectional') else 1
        self.head = pnn.Linear(hidden * n_dir, num_classes, **kw)
        self.n_dir = n_dir
        self.padding_idx = padding_idx

    def forward(self, ids):
        out, _ = self.lstm(self.embedding(ids))          # [N, T, H*dir]
        return self.head(_masked_mean(out, ids, self.padding_idx))


class BoWClassifier(nn.Module):
    """Bag-of-embeddings text classifier (the hapi bow example)."""

    def __init__(self, vocab_size=10000, embed_dim=64, num_classes=2,
                 padding_idx=0, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.embedding = pnn.Embedding(vocab_size, embed_dim,
                                       padding_idx=padding_idx, **kw)
        self.fc = pnn.Linear(embed_dim, num_classes, **kw)
        self.padding_idx = padding_idx

    def forward(self, ids):
        return self.fc(_masked_mean(self.embedding(ids), ids,
                                    self.padding_idx))
