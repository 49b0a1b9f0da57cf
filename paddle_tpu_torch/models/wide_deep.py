"""Wide&Deep — the port's copy of `paddle_tpu/models/wide_deep.py`.

Reference parity: the canonical PS-mode ranking model the reference's
parameter-server stack trains (a_sync strategy + distributed_lookup_table):
the sparse side rides paddle_tpu_torch.distributed.ps (host tables, in
the sync, async or geo mode), the dense towers run on the model's device
(the card unless asked).
"""
import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..distributed.ps.embedding import DistributedEmbedding
from ..ops import nn_ops as F


class WideDeep(nn.Module):
    def __init__(self, sparse_feature_dim=16, num_sparse_slots=8,
                 dense_dim=13, hidden_sizes=(64, 32), a_sync=False,
                 sparse_lr=0.05, mode=None, geo_k=10, device=None,
                 generator=None):
        super().__init__()
        self.device = resolve_device(device)
        self.num_sparse_slots = num_sparse_slots
        self.embedding = DistributedEmbedding(
            sparse_feature_dim, optimizer='adagrad',
            learning_rate=sparse_lr, a_sync=a_sync, mode=mode, geo_k=geo_k,
            device=self.device)
        # wide part: per-feature scalar weights from a second tiny table
        self.wide_embedding = DistributedEmbedding(
            1, optimizer='sgd', learning_rate=sparse_lr, a_sync=a_sync,
            mode=mode, geo_k=geo_k, device=self.device)
        layers = []
        in_dim = dense_dim + num_sparse_slots * sparse_feature_dim
        for h in hidden_sizes:
            layers += [pnn.Linear(in_dim, h, device=self.device,
                                  generator=generator), pnn.ReLU()]
            in_dim = h
        layers.append(pnn.Linear(in_dim, 1, device=self.device,
                                 generator=generator))
        self.deep = pnn.Sequential(*layers)

    def forward(self, sparse_ids, dense_feats):
        """sparse_ids: int64 [B, num_slots] (host); dense_feats: [B,
        dense_dim], moved to the model's device here."""
        dense_feats = torch.as_tensor(dense_feats).to(
            self.device, torch.float32, non_blocking=True)
        emb = self.embedding(sparse_ids)          # B, S, D
        emb_flat = emb.reshape(emb.shape[0], emb.shape[1] * emb.shape[2])
        deep_out = self.deep(torch.cat([dense_feats, emb_flat], dim=1))
        wide = self.wide_embedding(sparse_ids)    # B, S, 1
        return deep_out + wide.sum(1)

    def loss(self, logits, labels):
        return F.binary_cross_entropy_with_logits(logits, labels)
