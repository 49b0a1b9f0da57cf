"""BERT pretraining — counterpart of `paddle_tpu/models/bert.py`: the
encoder stack of `nn.TransformerEncoder` (GELU FFN, post-LN) under
word, position and token-type embeddings, with the MLM and NSP heads.

`BertForPretraining(..., masked_lm_labels=...)` returns the pretraining
loss: the MLM loss through `fused_linear_cross_entropy` against the
word-embedding weight (tied: the head has no weight of its own), in
`mlm_loss_chunks` row chunks, so the [B*L, vocab] logits never exist;
plus the NSP loss (`F.cross_entropy`). A 2-D `attention_mask` [B, L] (1
keeps a token) becomes the additive [B, 1, 1, L] mask (0 or -1e9),
which the attention reduces to a key bias on its flash routes.

Parameter names and layouts are the reference's (Linear weights [in,
out]), so `models.load_jax_params` bridges a JAX BERT without renaming.
Modules take `device`, `dtype` and an optional `generator` for the
initializers (Normal(0, initializer_range) embeddings; Xavier-uniform
Linear weights and zero biases as paddle's defaults).
"""
import torch
from torch import nn

from .. import nn as pnn
from ..distributed.fleet.utils.recompute import tag_tensor as _remat_tag
from ..ops import nn_ops as F


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_seq_len=512,
                 type_vocab_size=2, hidden_dropout=0.1, attn_dropout=0.1,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 mlm_loss_chunks=16):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attn_dropout = attn_dropout
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.mlm_loss_chunks = mlm_loss_chunks


def _embedding(n, config, kw, generator):
    e = pnn.Embedding(n, config.hidden_size, **kw)
    with torch.no_grad():
        e.weight.normal_(0.0, config.initializer_range, generator=generator)
    return e


class BertEmbeddings(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {'device': device, 'dtype': dtype}
        self.word_embeddings = _embedding(config.vocab_size, config, kw,
                                          generator)
        self.position_embeddings = _embedding(config.max_seq_len, config,
                                              kw, generator)
        self.token_type_embeddings = _embedding(config.type_vocab_size,
                                                config, kw, generator)
        self.layer_norm = pnn.LayerNorm(config.hidden_size,
                                        epsilon=config.layer_norm_eps, **kw)
        self.dropout = pnn.Dropout(config.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        L = input_ids.shape[-1]
        if position_ids is None:
            position_ids = torch.arange(L, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)) \
            + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(_remat_tag(x, 'embed_out')))


class BertModel(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.config = config
        kw = {'device': device, 'dtype': dtype, 'generator': generator}
        self.embeddings = BertEmbeddings(config, **kw)
        encoder_layer = pnn.TransformerEncoderLayer(
            config.hidden_size, config.num_heads, config.intermediate_size,
            dropout=config.hidden_dropout, activation='gelu',
            attn_dropout=config.attn_dropout, **kw)
        self.encoder = pnn.TransformerEncoder(encoder_layer,
                                              config.num_layers)
        self.pooler = pnn.Linear(config.hidden_size, config.hidden_size,
                                 **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None and attention_mask.dim() == 2:
            mask = attention_mask[:, None, None, :].to(torch.float32)
            attention_mask = (1.0 - mask) * -1e9 + 0.0
        x = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Module):
    """MLM + NSP heads."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {'device': device, 'dtype': dtype, 'generator': generator}
        self.bert = BertModel(config, **kw)
        self.config = config
        self.mlm_transform = pnn.Linear(config.hidden_size,
                                        config.hidden_size, **kw)
        self.mlm_norm = pnn.LayerNorm(config.hidden_size,
                                      epsilon=config.layer_norm_eps,
                                      device=device, dtype=dtype)
        self.nsp = pnn.Linear(config.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None):
        """Without labels: (mlm_logits, nsp_logits). With
        `masked_lm_labels`: the fp32 pretraining loss (MLM, plus NSP when
        `next_sentence_label` is given)."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight
        nsp_logits = self.nsp(pooled)
        if masked_lm_labels is not None:
            mlm = F.fused_linear_cross_entropy(
                h, w, masked_lm_labels, ignore_index=-100,
                chunks=self.config.mlm_loss_chunks)
            if next_sentence_label is None:
                return mlm
            return mlm + F.cross_entropy(nsp_logits, next_sentence_label)
        return torch.matmul(h, w.t()), nsp_logits


def bert_pretrain_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                       ignore_index=-100):
    mlm = F.cross_entropy(mlm_logits, mlm_labels, ignore_index=ignore_index)
    return mlm + F.cross_entropy(nsp_logits, nsp_labels)
