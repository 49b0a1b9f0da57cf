"""GPT causal LM — counterpart of `paddle_tpu/models/gpt.py`.

Two paths are ported: serving (`GPTModel.forward_paged` over the
block-paged KV pool and `GPTForCausalLM.generate_batch` on the serving
engine) and training (the uncached `forward` of every layer and
`GPTPretrainingCriterion`, run by `jit.TrainStep`; and the pipeline
triple of `build_gpt_pipeline` with `GPTLMHead`, run by
`SpmdPipelineEngine`). The uncached forward tags the six remat
boundaries (`embed_out`, `attn_qkv`, `attn_ctx`, `attn_out`, `mlp_fc1`,
`mlp_out`) where the reference does. Attention in the
uncached forward takes the flash route (the packed flash kernels) when
`use_flash_attention` and L >= 512, the dense route otherwise
(gpt.py:173-213). In training, hidden dropout runs in the embeddings
(gpt.py:105-117) and in both residual joins of each decoder layer (the
fused dropout+residual kernels, gpt.py:378), and attention dropout on
the attention probabilities (gpt.py:168-171, 185-189): on the flash
route through the dropout-fused BHLD flash kernels, on the dense route
on the probabilities in the activations' dtype. The masks are drawn in
the reference's order: the embedding first, then per layer the
attention probabilities, the attention join and the MLP join.

Dense-cache decode (`forward(caches=..., cache_len=...)`, gpt.py:223,
:416, :459): each layer keeps a fixed-size [B, nh, max_len, hd] K/V
cache; a step writes its token's K/V at `cache_len` (in place, where the
reference donates the cache) and attends over the whole cache with
-1e9 beyond `cache_len`, the scores in fp32 and the probabilities in the
activations' dtype. `GPTForCausalLM.generate` (:512) decodes greedily or
by top-k sampling on the host (`_sample_next`, :500), on that cache or,
for `use_cache=False` or a prompt plus `max_new_tokens` beyond
`max_seq_len`, by re-running the uncached forward over a sliding window;
`generate_scan` (:584) runs the prefill and the decode loop on the
device with one host fetch at the end. The LayerNorm and bias+GELU
kernels run at the decode step's shapes.

Parameter names and layouts are paddle's, so `models/convert.py` copies
the JAX package's weights without renaming: Linear weights are [in,
out], the qkv out-dim packs (head, 3, head_dim) (gpt.py:166, `_split`
at :276), and the LM head is tied to
`gpt.embeddings.word_embeddings.weight` (gpt.py:495); GPTLMHead's is
not.
"""
import math

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..amp import uncast
from ..core import rng
from ..device import resolve_device
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from ..distributed.fleet.utils.recompute import segment as _remat_segment
from ..distributed.fleet.utils.recompute import tag_tensor as _remat_tag
from ..ops import nn_ops as F
from ..ops.kernels import flash_attention as fa
from ..ops.kernels.fused_elementwise import keep_scale
from ..ops.kernels import paged_attention as pa


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden_size=None, max_seq_len=1024,
                 hidden_dropout=0.1, attn_dropout=0.1,
                 initializer_range=0.02, layer_norm_eps=1e-5,
                 use_flash_attention=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.hidden_dropout = hidden_dropout
        self.attn_dropout = attn_dropout
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.use_flash_attention = use_flash_attention


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                     num_heads=4, max_seq_len=256, **kw)


def gpt_small(**kw):  # GPT-2 124M
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_medium(**kw):  # 350M
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt_1p3b(**kw):  # GPT-3 1.3B
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_seq_len=2048, **kw)


def _normal_(w, std, generator):
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)


class GPTEmbeddings(nn.Module):
    """Token + learned position embeddings."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {'device': device, 'dtype': dtype}
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = pnn.Embedding(
            config.max_seq_len, config.hidden_size, **kw)
        self.dropout = pnn.Dropout(config.hidden_dropout)
        _normal_(self.word_embeddings.weight, config.initializer_range,
                 generator)
        _normal_(self.position_embeddings.weight, config.initializer_range,
                 generator)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        tok = self.word_embeddings(input_ids)
        pos = self.position_embeddings(position_ids)
        return self.dropout(_remat_tag(tok + pos, 'embed_out'))


class GPTAttention(nn.Module):
    """Causal self-attention (heads sharded over mp at mp > 1)."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.world_size = 1
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.local_heads = config.num_heads // self.world_size
        self.attn_dropout_p = config.attn_dropout
        self.use_flash = config.use_flash_attention
        kw = {'device': device, 'dtype': dtype}
        self.qkv_proj = ColumnParallelLinear(
            config.hidden_size, 3 * config.hidden_size, gather_output=False,
            **kw)
        self.out_proj = RowParallelLinear(
            config.hidden_size, config.hidden_size, input_is_parallel=True,
            **kw)
        _normal_(self.qkv_proj.weight, config.initializer_range, generator)
        _normal_(self.out_proj.weight, config.initializer_range
                 / math.sqrt(2 * config.num_layers), generator)

    def forward(self, x, cache=None, cache_len=None):
        """Uncached causal self-attention over x [B, L, H] (gpt.py:151):
        the flash route at L >= 512 when use_flash_attention, the dense
        route otherwise. In training with attention dropout > 0 the
        flash route is the dropout-fused BHLD one, its keep mask drawn
        from the bound generator; at eval or dropout 0 the packed one.
        With a `cache` (k, v) [B, nh, max_len, hd]: one decode step
        (`_forward_cached`), returning (out, cache)."""
        if cache is not None:
            return self._forward_cached(x, cache, cache_len)
        return self.project_out(self.attend(self.project_qkv(x)))

    def _forward_cached(self, x, cache, cache_len):
        """x [B, L, H] at positions cache_len.. (L = 1 in a decode step):
        writes the tokens' K/V into the cache at `cache_len` and attends
        over the whole cache, keys beyond `cache_len` at -1e9 (gpt.py:223).
        Returns (out, (k_cache, v_cache)), the cache updated in place."""
        B, L, _ = x.shape
        qkv = self.qkv_proj(x)
        hd = self.head_dim
        nh = qkv.shape[-1] // (3 * hd)
        k_cache, v_cache = cache
        ctx = self._cached_attention(qkv, k_cache, v_cache, int(cache_len),
                                     B, L, nh, hd)
        return self.out_proj(ctx), (k_cache, v_cache)

    @staticmethod
    @uncast
    def _cached_attention(qkv, k_cache, v_cache, pos, B, L, nh, hd):
        """The reference's `cached_attention` op: the cache write, fp32
        scores over the whole cache, softmax, the probabilities in qkv's
        dtype against V."""
        x5 = qkv.reshape(B, L, nh, 3, hd)
        q, k, v = (t.transpose(1, 2) for t in x5.unbind(3))   # B, nh, L, hd
        k_cache[:, :, pos:pos + L] = k.to(k_cache.dtype)
        v_cache[:, :, pos:pos + L] = v.to(v_cache.dtype)
        scores = torch.matmul(q.float(), k_cache.float().transpose(-1, -2))
        scores = scores * (1.0 / math.sqrt(hd))
        idx = torch.arange(k_cache.shape[2], device=qkv.device)
        scores = torch.where(idx <= pos, scores,
                             torch.full((), -1e9, device=qkv.device))
        probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
        o = torch.matmul(probs, v_cache.to(qkv.dtype))
        return o.transpose(1, 2).reshape(B, L, nh * hd)

    # the three stretches between the remat boundary tags (gpt.py:159,
    # :219-220); the decoder layer runs each through `remat.segment`

    def project_qkv(self, x):
        return _remat_tag(self.qkv_proj(x), 'attn_qkv')

    def attend(self, qkv):
        B, L = qkv.shape[0], qkv.shape[1]
        hd = self.head_dim
        nh = qkv.shape[-1] // (3 * hd)
        dropout = self.attn_dropout_p if self.training else 0.0
        if self.use_flash and L >= 512:
            ctx = fa.causal_attention(qkv, nh, hd, dropout=dropout)
        else:
            ctx = self._dense_attention(qkv, B, L, nh, hd, dropout)
        return _remat_tag(ctx, 'attn_ctx')

    def project_out(self, ctx):
        return _remat_tag(self.out_proj(ctx), 'attn_out')

    @staticmethod
    @uncast
    def _dense_attention(qkv, B, L, nh, hd, dropout=0.0):
        """gpt.py:173-191: fp32 scores, causal mask at -1e9 (this
        route's own constant; the flash kernels use -1e30), softmax in
        fp32, probabilities cast to the activations' dtype; with
        dropout, the kept probabilities divided by 1 - p rounded to that
        dtype (as jnp divides a bf16 array by a Python float), the rest
        zeroed."""
        x5 = qkv.reshape(B, L, nh, 3, hd)
        q, k, v = (t.transpose(1, 2) for t in x5.unbind(3))  # B, nh, L, hd
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores * (1.0 / math.sqrt(hd))
        causal = torch.ones(L, L, dtype=torch.bool, device=qkv.device).tril()
        scores = torch.where(causal, scores,
                             torch.full_like(scores, -1e9))
        probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
        if dropout > 0.0:
            keep = rng.keep_mask(tuple(probs.shape), 1.0 - dropout,
                                 qkv.device)
            probs = torch.where(keep, probs / keep_scale(probs, dropout),
                                torch.zeros((), dtype=probs.dtype,
                                            device=probs.device))
        out = torch.matmul(probs, v)
        return out.transpose(1, 2).reshape(B, L, nh * hd)

    def forward_paged(self, x, kv, page_tables, seq_lens, q_lens,
                      write_index=None):
        """Serving path: x [B, T, H] (T new tokens a row, right-padded to
        q_lens); kv = (k_pages, v_pages) [num_pages, page_size,
        heads*hd] from the shared pool, or the int8 pool's 4-tuple
        (k_pages, v_pages, k_scales, v_scales): the arity selects the
        route, as gpt.py:282-299. Writes the new tokens' K/V into the
        rows' pages IN PLACE (quantized per (token, head) for an int8
        pool) and runs ragged paged attention over each row's page
        table (dequantizing int8 pages inside). `write_index` is the
        forward's shared `pa.kv_write_index`. Returns (out, kv)."""
        B, T, _ = x.shape
        qkv = self.qkv_proj(x)
        hd = self.head_dim
        nh = qkv.shape[-1] // (3 * hd)
        # out-dim layout (head, 3, hd): gpt.py:276 `_split`
        x5 = qkv.reshape(B, T, nh, 3, hd)
        q = x5[:, :, :, 0].reshape(B, T, nh * hd)
        k = x5[:, :, :, 1].reshape(B, T, nh * hd)
        v = x5[:, :, :, 2].reshape(B, T, nh * hd)
        if len(kv) == 4:
            k_pages, v_pages, k_scales, v_scales = kv
            pa.write_kv_pages_quantized(
                k_pages, v_pages, k_scales, v_scales, k, v, page_tables,
                seq_lens, q_lens, num_heads=nh, index=write_index)
        else:
            k_pages, v_pages = kv
            k_scales = v_scales = None
            pa.write_kv_pages(k_pages, v_pages, k, v, page_tables, seq_lens,
                              q_lens, index=write_index)
        ctx = pa.ragged_paged_attention(
            q, k_pages, v_pages, page_tables, seq_lens, q_lens,
            num_heads=nh, head_dim=hd, k_scales=k_scales, v_scales=v_scales)
        return self.out_proj(ctx), kv


class GPTMLP(nn.Module):
    """FFN; fc1's bias-add fuses into the GELU (the bias+GELU kernel on
    CUDA), as gpt.py:337-346."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {'device': device, 'dtype': dtype}
        self.fc1 = ColumnParallelLinear(
            config.hidden_size, config.ffn_hidden_size, gather_output=False,
            **kw)
        self.fc2 = RowParallelLinear(
            config.ffn_hidden_size, config.hidden_size,
            input_is_parallel=True, **kw)
        _normal_(self.fc1.weight, config.initializer_range, generator)
        _normal_(self.fc2.weight, config.initializer_range
                 / math.sqrt(2 * config.num_layers), generator)

    def forward(self, x):
        return self.contract(self.expand(x))

    # the two stretches between the remat boundary tags (gpt.py:340-346)

    def expand(self, x):
        """fc1's product, without its bias on the fused bias+GELU route."""
        if self.fc1.bias is not None:
            return _remat_tag(self.fc1(x, with_bias=False), 'mlp_fc1')
        return _remat_tag(self.fc1(x), 'mlp_fc1')

    def contract(self, u):
        if self.fc1.bias is not None:
            h = F.bias_gelu(u, self.fc1.bias, approximate=True)
        else:
            h = F.gelu(u, approximate=True)
        return _remat_tag(self.fc2(h), 'mlp_out')


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer block; both residual joins run through
    F.dropout_add (a plain add at eval or dropout 0)."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {'device': device, 'dtype': dtype}
        self.ln1 = pnn.LayerNorm(config.hidden_size,
                                 epsilon=config.layer_norm_eps, **kw)
        self.attn = GPTAttention(config, generator=generator, **kw)
        self.ln2 = pnn.LayerNorm(config.hidden_size,
                                 epsilon=config.layer_norm_eps, **kw)
        self.mlp = GPTMLP(config, generator=generator, **kw)
        self.hidden_dropout = config.hidden_dropout

    def _join(self, sub_out, residual):
        return F.dropout_add(sub_out, residual, p=self.hidden_dropout,
                             training=self.training)

    def forward(self, x, cache=None, cache_len=None):
        """x + attn(ln1(x)), then + mlp(ln2(.)), cut at the remat boundary
        tags into stretches run through `remat.segment`: checkpoints of
        their own under the 'attn_mlp_boundaries' policy, plain calls
        otherwise. With a `cache`: one dense-cache decode step, returning
        (x, cache)."""
        if cache is not None:
            a, new_cache = self.attn(self.ln1(x), cache=cache,
                                     cache_len=cache_len)
            x = self._join(a, x)
            x = self._join(self.mlp(self.ln2(x)), x)
            return x, new_cache
        seg = _remat_segment
        qkv = seg(self._attn_in, x)
        a = seg(self.attn.project_out, seg(self.attn.attend, qkv))
        x, u = seg(self._mlp_in, a, x)
        return self._join(seg(self.mlp.contract, u), x)

    def _attn_in(self, x):
        return self.attn.project_qkv(self.ln1(x))

    def _mlp_in(self, a, x):
        x = self._join(a, x)
        return x, self.mlp.expand(self.ln2(x))

    def forward_paged(self, x, kv, page_tables, seq_lens, q_lens,
                      write_index=None):
        a, kv = self.attn.forward_paged(self.ln1(x), kv, page_tables,
                                        seq_lens, q_lens, write_index)
        x = self._join(a, x)
        x = self._join(self.mlp(self.ln2(x)), x)
        return x, kv


class GPTModel(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.config = config
        kw = {'device': device, 'dtype': dtype}
        self.embeddings = GPTEmbeddings(config, generator=generator, **kw)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, generator=generator, **kw)
             for _ in range(config.num_layers)])
        self.final_norm = pnn.LayerNorm(config.hidden_size,
                                        epsilon=config.layer_norm_eps, **kw)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_len=None):
        """Hidden states [B, L, H] after the final norm (gpt.py:416-444,
        without sequence parallelism); with `caches` (one (k, v) a layer,
        `init_caches`), (hidden, caches) of a decode step at
        `cache_len`."""
        x = self.embeddings(input_ids, position_ids)
        if caches is not None:
            new_caches = []
            for layer, c in zip(self.layers, caches):
                x, nc = layer(x, cache=c, cache_len=cache_len)
                new_caches.append(nc)
            return self.final_norm(x), new_caches
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)

    def init_caches(self, batch, max_len, dtype=None):
        """One zero (k, v) pair [batch, nh, max_len, hd] a layer, in the
        word embedding's dtype unless `dtype` is given, on its device
        (gpt.py:459)."""
        cfg = self.config
        hd = cfg.hidden_size // cfg.num_heads
        nh = self.layers[0].attn.local_heads
        w = self.embeddings.word_embeddings.weight
        kw = dict(dtype=dtype or w.dtype, device=w.device)
        return [(torch.zeros(batch, nh, max_len, hd, **kw),
                 torch.zeros(batch, nh, max_len, hd, **kw))
                for _ in range(cfg.num_layers)]

    def forward_paged(self, input_ids, position_ids, kv_list, page_tables,
                      seq_lens, q_lens):
        """Serving forward over the paged KV pool: kv_list holds each
        layer's (k_pages, v_pages), or the int8 pool's 4-tuple, updated
        in place. page_tables / seq_lens / q_lens may live on the host
        (the engine's one-dispatch steps pass them there) or on the card
        (its fused decode windows): the K/V write index is computed from
        them once for all layers, and the kernel gets device copies.
        Returns (hidden, kv_list)."""
        dev = self.final_norm.weight.device
        T = input_ids.shape[1]
        N, ps, _ = kv_list[0][0].shape
        write_index = pa.kv_write_index(page_tables, seq_lens, q_lens, T,
                                        N, ps, device=dev)
        page_tables, seq_lens, q_lens = (
            t.to(dev, torch.int32) for t in (page_tables, seq_lens, q_lens))
        x = self.embeddings(input_ids.to(dev), position_ids.to(dev))
        for layer, kv in zip(self.layers, kv_list):
            x, _ = layer.forward_paged(x, kv, page_tables, seq_lens, q_lens,
                                       write_index)
        return self.final_norm(x), kv_list


class GPTForCausalLM(nn.Module):
    """LM head tied to the input embedding (gpt.py:495)."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config, device=device, dtype=dtype,
                            generator=generator)

    def forward(self, input_ids, position_ids=None):
        """Logits [B, L, V] in the params' dtype: the tied head
        hidden @ W_emb^T (gpt.py:481-497)."""
        hidden = self.gpt(input_ids, position_ids)
        w = self.gpt.embeddings.word_embeddings.weight
        return torch.matmul(hidden, w.t())

    # -- dense-cache and uncached decode (gpt.py:500-719) --------------------
    @staticmethod
    def _sample_next(step_logits, temperature, top_k):
        """The next token of each row from host logits [B, V] (numpy):
        the argmax of logits / temperature, or a draw from the top_k
        largest by numpy's global generator (gpt.py:500)."""
        step = step_logits / max(temperature, 1e-6)
        if top_k and top_k > 0:
            kth = np.sort(step, axis=-1)[:, -top_k][:, None]
            z = np.where(step < kth, -1e30, step)
            z = z - z.max(-1, keepdims=True)
            p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
            return np.asarray([np.random.choice(p.shape[-1], p=row)
                               for row in p])
        return step.argmax(-1)

    def _decode_step(self, tokens, pos, caches):
        """Logits [B, V] of `tokens` [B, 1] at position `pos` over the
        dense caches (updated in place)."""
        pos_ids = torch.full((1,), pos, dtype=torch.long,
                             device=tokens.device)
        h, caches = self.gpt(tokens, pos_ids, caches=caches, cache_len=pos)
        w = self.gpt.embeddings.word_embeddings.weight
        return torch.matmul(h, w.t())[:, -1, :]

    def _on(self, device):
        dev = resolve_device(device)
        self.to(dev)
        return dev

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, eos_token_id=None, use_cache=True, device=None):
        """Greedy (top_k 0) or top-k sampled decode of `input_ids` [B, L0]
        (gpt.py:512): over the dense K/V caches, or, for use_cache=False
        or L0 + max_new_tokens beyond max_seq_len, re-running the uncached
        forward over the last max_seq_len tokens each step. With
        `eos_token_id` it stops once every row has emitted it (rows that
        finished keep emitting until then). Returns the [B, L0 + new]
        token ids as a CPU tensor. Runs on `device`, the card unless the
        caller passes device='cpu' (the model is moved there)."""
        dev = self._on(device)
        ids = np.asarray(input_ids.cpu() if isinstance(
            input_ids, torch.Tensor) else input_ids)
        if use_cache and ids.shape[-1] + max_new_tokens \
                <= self.config.max_seq_len:
            return self._generate_cached(ids, max_new_tokens, temperature,
                                         top_k, eos_token_id, dev)
        done = np.zeros(ids.shape[0], bool)
        with torch.no_grad():
            for _ in range(max_new_tokens):
                window = ids[:, -self.config.max_seq_len:]
                logits = self(torch.from_numpy(
                    window.astype('int32')).to(dev))
                nxt = self._sample_next(_host(logits[:, -1, :]),
                                        temperature, top_k)
                ids = np.concatenate([ids, nxt[:, None]], axis=1)
                if eos_token_id is not None:
                    done |= (nxt == eos_token_id)
                    if done.all():
                        break
        return torch.from_numpy(ids)

    def _generate_cached(self, ids, max_new_tokens, temperature, top_k,
                         eos_token_id, dev):
        """gpt.py:664: the prompt fed token by token through the caches,
        then one decode step a new token. Greedy rows take the argmax on
        the device, and only the tokens reach the host (each step with
        `eos_token_id`, at the end without); a top-k draw fetches the
        logits each step, as the reference does."""
        ids = ids.astype('int32')
        B, L0 = ids.shape
        max_len = min(self.config.max_seq_len, L0 + max_new_tokens)
        was_training = self.training
        self.eval()
        greedy = not (top_k and top_k > 0)
        with torch.no_grad():
            caches = self.gpt.init_caches(B, max_len)
            prompt = torch.from_numpy(ids).to(dev)
            last = None
            for t in range(L0):
                last = self._decode_step(prompt[:, t:t + 1], t, caches)
            out = [prompt]
            done = np.zeros(B, bool)
            for i in range(max_new_tokens):
                pos = L0 + i
                if pos >= max_len:
                    break
                if greedy:
                    nxt = (last / max(temperature, 1e-6)).argmax(-1).to(
                        torch.int32)
                else:
                    nxt = torch.from_numpy(self._sample_next(
                        _host(last), temperature, top_k).astype('int32')
                    ).to(dev)
                out.append(nxt[:, None])
                if eos_token_id is not None:
                    done |= (_host(nxt) == eos_token_id)
                    if done.all():
                        break
                last = self._decode_step(nxt[:, None], pos, caches)
            tokens = torch.cat(out, dim=1).cpu()
        if was_training:
            self.train()
        return tokens

    def generate_scan(self, input_ids, max_new_tokens=32, temperature=1.0,
                      top_k=0, seed=0, device=None):
        """The whole generation on the device with one host fetch at the
        end (gpt.py:584): the prompt through the caches token by token,
        then max_new_tokens decode steps, greedy (top_k 0) or a top-k
        draw from a `torch.Generator` seeded from `seed` (JAX's threefry
        stream cannot be matched). Returns [B, L0 + max_new_tokens] token
        ids as a CPU tensor; raises ValueError beyond max_seq_len."""
        dev = self._on(device)
        ids = np.asarray(input_ids.cpu() if isinstance(
            input_ids, torch.Tensor) else input_ids).astype('int32')
        B, L0 = ids.shape
        max_len = L0 + max_new_tokens
        if max_len > self.config.max_seq_len:
            raise ValueError(
                f'prompt({L0}) + max_new_tokens({max_new_tokens}) exceeds '
                f'max_seq_len({self.config.max_seq_len})')
        was_training = self.training
        self.eval()
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            caches = self.gpt.init_caches(B, max_len)
            prompt = torch.from_numpy(ids).to(dev)
            for t in range(L0):
                last = self._decode_step(prompt[:, t:t + 1], t, caches)
            toks = []
            for i in range(max_new_tokens):
                scaled = last / max(temperature, 1e-6)
                if top_k and top_k > 0:
                    kth = scaled.sort(-1).values[:, -top_k][:, None]
                    scaled = torch.where(scaled < kth,
                                         torch.full_like(scaled, -1e30),
                                         scaled)
                    probs = torch.softmax(scaled.float(), dim=-1)
                    nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
                else:
                    nxt = scaled.argmax(-1)
                nxt = nxt.to(torch.int32)
                toks.append(nxt)
                if i + 1 < max_new_tokens:
                    last = self._decode_step(nxt[:, None], L0 + i, caches)
            new = torch.stack(toks, dim=1) if toks else \
                prompt.new_zeros((B, 0))
            tokens = torch.cat([prompt, new], dim=1).cpu()
        if was_training:
            self.train()
        return tokens

    def generate_batch(self, prompts, max_new_tokens=32, temperature=1.0,
                       top_k=0, eos_token_id=None, serving_config=None,
                       engine=None, device=None, **engine_kw):
        """Continuous-batching decode over the serving engine: `prompts`
        is a LIST of ragged token-id sequences. Returns the full token
        lists (prompt + generated) in submission order. The engine is
        cached on the model and reused across same-config calls; a
        different config (or device) replaces it, and the old engine is
        shut down. The engine runs on `device` — the card unless the
        caller passes device='cpu'."""
        from ..serving import ServingConfig, ServingEngine
        eng = engine
        if eng is None:
            cfg = serving_config or ServingConfig(**engine_kw)
            key = (str(device),) + tuple(sorted(
                (k, repr(v)) for k, v in vars(cfg).items()))
            engines = getattr(self, '_serving_engines', {})
            eng = engines.get(key)
            if eng is None:
                # one live engine per model: each pins a device KV pool
                for old in engines.values():
                    old.shutdown()
                eng = ServingEngine(self, cfg, device=device)
                self._serving_engines = {key: eng}
        return eng.generate(prompts, max_new_tokens=max_new_tokens,
                            eos_token_id=eos_token_id,
                            temperature=temperature, top_k=top_k)


def _host(t):
    """A device tensor as a host numpy array (bf16 widened to fp32)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class GPTPretrainingCriterion(nn.Module):
    """Softmax cross entropy with the mean over tokens (gpt.py:737-749);
    with `loss_mask`, the masked sum over the mask's sum."""

    def __init__(self, config=None):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, logits, labels, loss_mask=None):
        loss = self.ce(logits, labels)
        if loss_mask is not None:
            masked = loss.reshape(labels.shape) * loss_mask
            return masked.sum() / loss_mask.sum()
        # jnp.mean of a bf16 array sums in fp32 and rounds the mean once
        return loss.float().mean().to(loss.dtype)


# GPTLMHead's switch (gpt.py:774): above this many logits in a
# micro-batch (tokens x vocab) the head runs the chunked
# fused_linear_cross_entropy, at or below it one product and the fused
# hard cross-entropy
FUSED_HEAD_MIN_LOGITS = 2 ** 28


class GPTLMHead(nn.Module):
    """Final norm + untied LM head + criterion, the pipeline's tail
    (gpt.py:752-786): `forward(hidden, labels)` -> the micro-batch's mean
    loss. The head weight is [hidden, vocab] (ColumnParallelLinear, no
    bias)."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {'device': device, 'dtype': dtype}
        self.norm = pnn.LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps, **kw)
        self.out = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, has_bias=False,
            gather_output=False, **kw)
        _normal_(self.out.weight, config.initializer_range, generator)
        self.ce = ParallelCrossEntropy()

    def forward(self, hidden, labels):
        h = self.norm(hidden)
        n_tokens = math.prod(h.shape[:-1])
        if n_tokens * self.out.out_features > FUSED_HEAD_MIN_LOGITS:
            # the [tokens, vocab] logits are never materialised
            return F.fused_linear_cross_entropy(
                h, self.out.weight, labels, ignore_index=-100,
                transpose_y=False)
        loss = self.ce(self.out(h), labels)
        # jnp.mean of a bf16 array sums in fp32 and rounds the mean once
        return loss.float().mean().to(loss.dtype)


def build_gpt_pipeline(config, device=None, dtype=None, generator=None):
    """(embed, blocks, head) triple for SpmdPipelineEngine (gpt.py:789)."""
    kw = {'device': device, 'dtype': dtype, 'generator': generator}
    embed = GPTEmbeddings(config, **kw)
    blocks = [GPTDecoderLayer(config, **kw)
              for _ in range(config.num_layers)]
    head = GPTLMHead(config, **kw)
    return embed, blocks, head
