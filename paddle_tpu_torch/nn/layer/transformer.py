"""The transformer stack — counterpart of
`paddle_tpu/nn/layer/transformer.py`:
`MultiHeadAttention` (:49, with `Cache` / `StaticCache` for decoding),
`TransformerEncoderLayer` (:221), `TransformerEncoder` (:292),
`TransformerDecoderLayer` (:342), `TransformerDecoder` (:412) and
`Transformer` (:447), with the reference's parameter names and layouts
(Linear weights [in, out]), so `models.load_jax_params` bridges them.

Attention takes one of the reference's three routes:
  * the packed flash route (`_try_flash_blhd`): q/k/v stay in the
    projections' [B, L, nh, hd] layout and run the packed flash kernels
    (rows 8-10 of PERF.md) non-causal, with a [B, L_k] key bias when the
    mask reduces to one;
  * the BHLD flash route (`_try_flash`, with
    `FLAGS_flash_packed_mha=False`): the [B, nh, L, hd] layout on the
    biased BHLD flash kernels (rows 11-13);
  * the dense route (`core_attention`): the scaled product, the additive
    mask, softmax and attention dropout on the probabilities.
Both flash routes need what `_flash_eligible` (:129) asks: L_q == L_k,
L >= `FLAGS_flash_min_seq` and a multiple of 256, head_dim 64, 128 or
256, no `need_weights`, no active attention dropout, and a mask that is
None or reduces to a key bias. The port's flash kernels have no
head_dim 256 body (`PTT_DISPATCH_HEAD_DIM`, csrc/flash_attention.cu), so
at 256 the flash route raises NotImplementedError instead of running.
Cross-attention with L_q != L_k and 2-D (e.g. causal) masks take the
dense route, as in the reference.

The encoder layer's residual joins run `F.dropout_add` (the fused
dropout+residual kernels in training) and its FFN `F.bias_gelu` on fc1's
product before its bias (the bias+GELU kernel, erf form by default);
the remat tags `attn_out`, `mlp_fc1` and `mlp_out` mark the boundaries
where the reference tags them. The decoder layer keeps the reference's
plain dropout-then-add.

Layers take `device`, `dtype` and an optional `generator` for their
initializers; `weight_attr`/`bias_attr` (a `ParamAttr`, an initializer,
a name, or `bias_attr=False` for no bias) go to every projection, as
the reference passes them.
"""
import collections
import math

import torch
from torch import nn

from ...core import flags
from ...distributed.fleet.utils.recompute import segment as _remat_segment
from ...distributed.fleet.utils.recompute import tag_tensor as _remat_tag
from ...ops import nn_ops as F
from ...ops.kernels import flash_attention as fa
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask becomes 0 where True and -1e9 where False, in `dtype`;
    an additive mask is returned as it is (:26)."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        return torch.where(
            attn_mask, torch.zeros((), dtype=dtype, device=attn_mask.device),
            torch.full((), -1e9, dtype=dtype, device=attn_mask.device))
    return attn_mask


def _as_key_bias(attn_mask):
    """The [B|1, L_k] key bias of a [B|1, 1, 1, L_k] additive mask, else
    None (:34): a 2-D mask is [L_q, L_k] and a 3-D one broadcasts its
    leading dim over the heads, and neither is a bias per key."""
    if attn_mask.dim() == 4 and attn_mask.shape[1] == 1 \
            and attn_mask.shape[2] == 1:
        return attn_mask[:, 0, 0, :]
    return None


def _matmul(a, b):
    """a @ b with jnp's promotion of mixed dtypes; the reference's hooked
    `matmul_v2`, so amp.auto_cast reaches it."""
    return torch.matmul(*F._promoted(a, b))


class MultiHeadAttention(nn.Module):
    """Parity: nn/layer/transformer.py:49."""

    Cache = collections.namedtuple('Cache', ['k', 'v'])
    StaticCache = collections.namedtuple('StaticCache', ['k', 'v'])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _heads(self, t):
        """[B, L, E] -> [B, L, nh, hd] (a view)."""
        return t.reshape(t.shape[0], t.shape[1], self.num_heads,
                         self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self._heads(self.q_proj(query)).transpose(1, 2)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key)).transpose(1, 2)
            v = self._heads(self.v_proj(value)).transpose(1, 2)
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=2)
            v = torch.cat([cache.v, v], dim=2)
            cache = self.Cache(k, v)
        return (q, k, v) if cache is None else (q, k, v, cache)

    def gen_cache(self, key, value=None, type=Cache):
        """A StaticCache of the projected key/value (cross-attention), an
        empty Cache of [B, nh, 0, hd] (`value` None), or a Cache of the
        given tensors (:88)."""
        if type == MultiHeadAttention.StaticCache:
            k = self._heads(self.k_proj(key)).transpose(1, 2)
            v = self._heads(self.v_proj(
                value if value is not None else key)).transpose(1, 2)
            return self.StaticCache(k, v)
        if value is None:
            shape = (key.shape[0], self.num_heads, 0, self.head_dim)
            return self.Cache(key.new_zeros(shape), key.new_zeros(shape))
        return self.Cache(key, value)

    def core_attention(self, q, k, v, attn_mask=None):
        """(context [B, nh, L_q, hd], weights or None): the BHLD flash
        route when eligible, else the dense route (:109)."""
        flash = self._try_flash(q, k, v, attn_mask)
        if flash is not None:
            return flash, None
        scale = torch.tensor(self.head_dim ** -0.5, dtype=q.dtype,
                             device=q.device)
        product = _matmul(q * scale, k.transpose(-1, -2))
        if attn_mask is not None:
            attn_mask = _convert_attention_mask(attn_mask, product.dtype)
            product = torch.add(*F._promoted(product, attn_mask))
        weights = F.softmax(product)
        if self.dropout:
            weights = F.dropout(weights, self.dropout,
                                training=self.training)
        return _matmul(weights, v), weights

    def _flash_eligible(self, B, Lq, Lk, attn_mask):
        """(ok, key bias or None) for both flash routes (:129)."""
        if not flags.flag('FLAGS_use_flash_attention', True):
            return False, None
        if self.need_weights or (self.dropout and self.training):
            return False, None
        min_seq = flags.flag('FLAGS_flash_min_seq', 1024)
        min_seq = 1024 if min_seq is None else int(min_seq)
        if Lq != Lk or Lq < min_seq or Lq % 256 != 0:
            return False, None
        if self.head_dim not in (64, 128, 256):
            return False, None
        bias = None
        if attn_mask is not None:
            bias = _as_key_bias(_convert_attention_mask(attn_mask,
                                                        torch.float32))
            if bias is None:
                return False, None
            if bias.shape[0] == 1 and B > 1:
                bias = bias.expand(B, bias.shape[1])
            if bias.shape[-1] != Lk:
                return False, None
        if self.head_dim not in fa.HEAD_DIMS:
            raise NotImplementedError(
                f'MultiHeadAttention: the flash route at head_dim '
                f'{self.head_dim} needs a flash kernel body for it, which '
                f'csrc/flash_attention.cu does not have (PTT_DISPATCH_'
                f'HEAD_DIM instantiates {fa.HEAD_DIMS}); the dense route '
                f'is not taken in its place')
        return True, bias

    def _try_flash(self, q, k, v, attn_mask):
        """The BHLD route on [B, nh, L, hd]; the context or None."""
        ok, bias = self._flash_eligible(q.shape[0], q.shape[2], k.shape[2],
                                        attn_mask)
        if not ok:
            return None
        return fa.mha_flash_attention(q, k, v, key_bias=bias, causal=False)

    def _try_flash_blhd(self, q4, k4, v4, attn_mask):
        """The packed route on the projections' [B, L, nh, hd]; the
        context in that layout, or None."""
        if not flags.flag('FLAGS_flash_packed_mha', True):
            return None
        ok, bias = self._flash_eligible(q4.shape[0], q4.shape[1],
                                        k4.shape[1], attn_mask)
        if not ok:
            return None
        return fa.mha_flash_attention_blhd(q4, k4, v4, key_bias=bias,
                                           causal=False)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        if cache is None:
            q4 = self._heads(self.q_proj(query))
            k4 = self._heads(self.k_proj(key))
            v4 = self._heads(self.v_proj(value))
            ctx = self._try_flash_blhd(q4, k4, v4, attn_mask)
            if ctx is not None:
                return self.out_proj(ctx.reshape(ctx.shape[0], ctx.shape[1],
                                                 self.embed_dim))
            q, k, v = (t.transpose(1, 2) for t in (q4, k4, v4))
        else:
            q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out, weights = self.core_attention(q, k, v, attn_mask)
        out = out.transpose(1, 2)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(nn.Module):
    """Parity: nn/layer/transformer.py:221."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self._factory = dict(device=device, dtype=dtype, generator=generator)
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  **self._factory)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **self._factory)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, mode='upscale_in_train')
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout, mode='upscale_in_train')
        self.dropout2 = Dropout(dropout, mode='upscale_in_train')
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        """The block, cut at its remat boundary tags (attn_out, mlp_fc1,
        mlp_out) into four stretches run through `remat.segment`: under
        the 'attn_mlp_boundaries' policy each is a checkpoint of its own
        that keeps only its inputs (the tagged tensors and the residual
        stream), elsewhere a plain call. With a `cache`: one incremental
        step, returning (src, cache)."""
        if cache is not None:
            residual = src
            if self.normalize_before:
                src = self.norm1(src)
            a, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                  cache)
            x, u = self._mlp_in(_remat_tag(a, 'attn_out'), residual)
            return self._join_out(self._mlp_out(u), x), incremental_cache
        seg = _remat_segment
        a = seg(self._attend, src, src_mask)
        x, u = seg(self._mlp_in, a, src)
        return seg(self._join_out, seg(self._mlp_out, u), x)

    def _attend(self, src, src_mask):
        if self.normalize_before:
            src = self.norm1(src)
        return _remat_tag(self.self_attn(src, src, src, src_mask),
                          'attn_out')

    def _mlp_in(self, a, residual):
        """The attention's residual join and norms, then fc1's product
        (without its bias on the fused bias+GELU route)."""
        src = F.dropout_add(a, residual, p=self.dropout1.p,
                            training=self.training, mode=self.dropout1.mode)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        if self._fused_gelu():
            return residual, _remat_tag(F.linear(src, self.linear1.weight),
                                        'mlp_fc1')
        return residual, _remat_tag(self.linear1(src), 'mlp_fc1')

    def _mlp_out(self, u):
        if self._fused_gelu():
            h = F.bias_gelu(u, self.linear1.bias)
        else:
            h = self.activation(u)
        return _remat_tag(self.linear2(self.dropout(h)), 'mlp_out')

    def _join_out(self, m, residual):
        src = F.dropout_add(m, residual, p=self.dropout2.p,
                            training=self.training, mode=self.dropout2.mode)
        if not self.normalize_before:
            src = self.norm2(src)
        return src

    def _fused_gelu(self):
        return self.activation is F.gelu and self.linear1.bias is not None

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _layer_config(layer):
    """The constructor arguments of another layer like `layer` (:322), and
    its device, dtype and generator."""
    if isinstance(layer, TransformerEncoderLayer):
        cfg = dict(d_model=layer.self_attn.embed_dim,
                   nhead=layer.self_attn.num_heads,
                   dim_feedforward=layer.linear1.out_features,
                   dropout=layer.dropout1.p,
                   activation=layer.activation.__name__,
                   attn_dropout=layer.self_attn.dropout,
                   act_dropout=layer.dropout.p,
                   normalize_before=layer.normalize_before)
    elif isinstance(layer, TransformerDecoderLayer):
        cfg = dict(d_model=layer.self_attn.embed_dim,
                   nhead=layer.self_attn.num_heads,
                   dim_feedforward=layer.linear1.out_features,
                   dropout=layer.dropout1.p,
                   activation=layer.activation.__name__,
                   normalize_before=layer.normalize_before)
    else:
        raise TypeError(type(layer))
    return dict(cfg, **layer._factory)


class TransformerEncoder(nn.Module):
    """Parity: nn/layer/transformer.py:292. The first layer is the one
    given; the others are new layers of its configuration."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            type(encoder_layer)(**_layer_config(encoder_layer))
            for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Parity: nn/layer/transformer.py:342."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self._factory = dict(device=device, dtype=dtype, generator=generator)
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  **self._factory)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **self._factory)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **self._factory)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, mode='upscale_in_train')
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm3 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout, mode='upscale_in_train')
        self.dropout2 = Dropout(dropout, mode='upscale_in_train')
        self.dropout3 = Dropout(dropout, mode='upscale_in_train')
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            tgt, static_cache = tgt if isinstance(tgt, tuple) \
                else (tgt, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        incremental_cache = self.self_attn.gen_cache(memory)
        static_cache = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental_cache, static_cache


class TransformerDecoder(nn.Module):
    """Parity: nn/layer/transformer.py:412."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            type(decoder_layer)(**_layer_config(decoder_layer))
            for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask=tgt_mask,
                             memory_mask=memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask=tgt_mask,
                                        memory_mask=memory_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(nn.Module):
    """Parity: nn/layer/transformer.py:447."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            encoder_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **factory)
            encoder_norm = LayerNorm(d_model, device=device, dtype=dtype) \
                if normalize_before else None
            self.encoder = TransformerEncoder(encoder_layer,
                                              num_encoder_layers, encoder_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            decoder_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **factory)
            decoder_norm = LayerNorm(d_model, device=device, dtype=dtype) \
                if normalize_before else None
            self.decoder = TransformerDecoder(decoder_layer,
                                              num_decoder_layers, decoder_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] fp32: 0 on and below the diagonal, -inf above
        (:486), on the model's device."""
        device = next(self.parameters()).device
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=device).tril()
        return torch.where(keep, torch.zeros((), device=device),
                           torch.full((), -math.inf, device=device))
