"""DeepFM — the port's copy of `paddle_tpu/models/deepfm.py`.

Reference parity: the DeepFM topology the reference's PS configs train —
shared sparse embeddings feeding (a) a first-order linear term, (b) the
factorization-machine second-order interaction, (c) a deep MLP tower
(the CTR model family of the heterPS/pscore examples).

The FM pairwise interaction uses the sum-square trick (one reduction, no
O(F^2) loop). With `use_ps=True` the two lookups are DistributedEmbedding
layers over host tables, of widths `embed_dim` and 1 (PaddlePaddle's
intent: the reference passes `num_features` as the layer's width, so its
PS DeepFM cannot run); ids stay on the host and the dense tower runs on
the model's device.
"""
import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..ops import nn_ops as F


class DeepFM(nn.Module):
    """fields: number of sparse fields; each sample carries one feature id
    per field (the classic Criteo layout)."""

    def __init__(self, num_features=1000, fields=10, embed_dim=8,
                 hidden=(32, 16), use_ps=False, device=None, generator=None):
        super().__init__()
        self.device = resolve_device(device)
        self.fields = fields
        self.embed_dim = embed_dim
        self.use_ps = use_ps
        kw = dict(device=self.device, generator=generator)
        if use_ps:
            from ..distributed.ps.embedding import DistributedEmbedding
            self.embedding = DistributedEmbedding(embed_dim,
                                                  device=self.device)
            self.linear_embedding = DistributedEmbedding(
                1, device=self.device)
        else:
            self.embedding = pnn.Embedding(num_features, embed_dim, **kw)
            self.linear_embedding = pnn.Embedding(num_features, 1, **kw)
        self.bias = nn.Parameter(torch.zeros(1, device=self.device))
        mlp = []
        d = fields * embed_dim
        for h in hidden:
            mlp += [pnn.Linear(d, h, **kw), pnn.ReLU()]
            d = h
        mlp.append(pnn.Linear(d, 1, **kw))
        self.mlp = pnn.Sequential(*mlp)

    def forward(self, feat_ids):
        """feat_ids [N, fields] int (a host tensor with use_ps) -> logits
        [N, 1] on the model's device."""
        if not self.use_ps:
            feat_ids = feat_ids.to(self.device, non_blocking=True)
        n = feat_ids.shape[0]
        emb = self.embedding(feat_ids)                     # [N, F, D]
        first = self.linear_embedding(feat_ids).reshape(
            n, self.fields).sum(1, keepdim=True)           # [N, 1]
        s = emb.sum(1)
        second = (0.5 * (s * s - (emb * emb).sum(1))).sum(-1, keepdim=True)
        deep = self.mlp(emb.reshape(n, self.fields * self.embed_dim))
        return first + second + deep + self.bias


def deepfm_loss(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels)
