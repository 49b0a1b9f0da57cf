"""Megatron-style tensor-parallel layers at model-parallel world size 1 —
counterparts of `paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/mp_layers.py` (VocabParallelEmbedding, ColumnParallel-
Linear, RowParallelLinear, ParallelCrossEntropy). At world size 1 each is the dense layer,
exactly what the JAX layers compute outside an SPMD region. Sharding
over mp > 1 waits for the multi-GPU slice: passing an `mp_group` raises.
"""
import torch
from torch import nn

from .....nn.layer.common import xavier_uniform_
from .....ops import nn_ops as F


def _world_size_one(mp_group):
    if mp_group is not None:
        raise NotImplementedError(
            'model-parallel groups are not ported yet: the port runs the '
            'mp layers at world size 1')


class VocabParallelEmbedding(nn.Module):
    """The [V, D] token table (vocab split over mp ranks at mp > 1)."""

    def __init__(self, num_embeddings, embedding_dim, mp_group=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        _world_size_one(mp_group)
        self.world_size = 1
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        xavier_uniform_(self.weight, generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


class ColumnParallelLinear(nn.Module):
    """Weight [in, out] (split on out at mp > 1)."""

    def __init__(self, in_features, out_features, has_bias=None,
                 gather_output=True, mp_group=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        _world_size_one(mp_group)
        self.world_size = 1
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        kw = {'device': device, 'dtype': dtype}
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        has_bias = True if has_bias is None else has_bias
        self.bias = (nn.Parameter(torch.zeros(out_features, **kw))
                     if has_bias else None)
        xavier_uniform_(self.weight, generator)

    def forward(self, x, with_bias=True):
        """`with_bias=False` returns the pre-bias product so the caller
        can fuse the bias-add into the next op (GPTMLP feeds it to the
        bias+GELU kernel), as mp_layers.py:94."""
        return F.linear(x, self.weight, self.bias if with_bias else None)


class RowParallelLinear(nn.Module):
    """Weight [in, out] (split on in at mp > 1); bias replicated."""

    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, mp_group=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        _world_size_one(mp_group)
        self.world_size = 1
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        kw = {'device': device, 'dtype': dtype}
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = (nn.Parameter(torch.zeros(out_features, **kw))
                     if has_bias else None)
        xavier_uniform_(self.weight, generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ParallelCrossEntropy(nn.Module):
    """Vocab-parallel softmax cross entropy (mp_layers.py:168-182); at
    world size 1 the hard-label `softmax_with_cross_entropy`."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        _world_size_one(mp_group)
        self.world_size = 1
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.softmax_with_cross_entropy(input, label,
                                            ignore_index=self.ignore_index)
