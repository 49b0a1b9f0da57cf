"""Ragged paged attention for the serving engine — counterpart of
`paddle_tpu/ops/pallas/paged_attention.py` (its `_ragged_paged_kernel`,
:78), dense pages only; the int8 `quantized` branch waits.

One call serves a MIXED batch: decode rows (one new token) and chunked-
prefill rows (a window of new tokens) whose K/V history lives in the
block-paged pool (`serving/kv_pool.py`). Layouts, as in the JAX module:

  q           [B, T, H*D]   new-token queries, right-padded to T per row
  k_pages     [N_pages, page_size, H*D]   the pool's per-layer tensors
  v_pages     [N_pages, page_size, H*D]
  page_tables int  [B, pages_per_seq]     pool page ids (unused slots
                                          hold any id; clamped to [0, N))
  seq_lens    int  [B]  context length INCLUDING this step's new tokens
  q_lens      int  [B]  valid new tokens this step (<= T)

Query t of row b sits at global position seq_lens[b] - q_lens[b] + t and
attends keys at positions <= its own and < seq_lens[b].

`ragged_paged_attention` launches the CUDA kernel (`csrc/
paged_attention.cu`) on CUDA tensors and runs
`ragged_paged_attention_plain` on CPU tensors. The plain version
computes exactly what the Pallas body computes, including its edge
semantics: only pages whose start lies below seq_len take part, a masked
score is -1e30, and the normaliser is max(l, 1e-30). So a query with no
visible key averages the V rows of the pages it visits (a seq_len-0 row
writes zeros), where the dense JAX route (`ragged_paged_attention_dense`)
averages every gathered slot; the two agree on every query that sees a
key. The serving engine never builds a query without one: its idle
decode slots (seq_len 1, q_len 0, page row 0) see key 0 of page 0 and
their output is ignored.

There is no backward: the JAX package has none, and the serving engine
runs under `torch.inference_mode()`. So the wrapper refuses, on any
device, a call that would need one (grad mode on and an input that
requires grad) rather than return an output that silently has no
gradient.

`write_kv_pages` scatters the step's new K/V rows into the pool IN PLACE
(`index_copy_` on the flattened pool), where the JAX function returns
new arrays; padded tokens (t >= q_len) are filtered out before the
scatter, as the JAX scatter drops them through an out-of-range index.
"""
import math

import torch

from . import _build

KERNEL = 'paged_attention'
_build.register(KERNEL)

NEG_INF = -1e30


def ragged_paged_attention_plain(q, k_pages, v_pages, page_tables,
                                 seq_lens, q_lens, *, num_heads, head_dim):
    """Plain PyTorch version of the kernel (gathers each row's pages into
    a dense [B, P*ps, H*D] context)."""
    B, T, HD = q.shape
    N, ps, _ = k_pages.shape
    P = page_tables.shape[1]
    H, D = num_heads, head_dim
    dev = q.device
    pt = page_tables.to(dev, torch.long).clamp(0, N - 1)
    seq = seq_lens.to(dev, torch.long)
    ql = q_lens.to(dev, torch.long)
    k = k_pages[pt].reshape(B, P * ps, H, D).float()
    v = v_pages[pt].reshape(B, P * ps, H, D).float()
    qf = q.reshape(B, T, H, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum('bthd,bkhd->bhtk', qf, k)
    key = torch.arange(P * ps, device=dev)
    q_pos = seq[:, None] - ql[:, None] + torch.arange(T, device=dev)[None]
    valid = (key[None, None] < seq[:, None, None]) & \
        (key[None, None] <= q_pos[:, :, None])                 # [B, T, K]
    # the keys the Pallas grid visits: pages whose start is below seq_len
    visited = (key // ps)[None] * ps < seq[:, None]            # [B, K]
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    s = torch.where(visited[:, None, None], s,
                    torch.full_like(s, -math.inf))
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)                                       # [B, H, T, K]
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum('bhtk,bkhd->bhtd', p, v) / l
    return o.transpose(1, 2).reshape(B, T, HD).to(q.dtype)


def ragged_paged_attention(q, k_pages, v_pages, page_tables, seq_lens,
                           q_lens, *, num_heads, head_dim):
    """Attention of each row's new queries over its pages; see the
    module docstring for layouts and semantics."""
    if torch.is_grad_enabled() and (q.requires_grad or k_pages.requires_grad
                                    or v_pages.requires_grad):
        raise RuntimeError(
            'ragged_paged_attention has no backward (nor has the JAX '
            'kernel): call it under torch.no_grad() or '
            'torch.inference_mode(), as the serving engine does')
    if _build.on_cpu(q, k_pages, v_pages):
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, page_tables, seq_lens, q_lens,
            num_heads=num_heads, head_dim=head_dim)
    B, T, HD = q.shape
    N, ps, HD2 = k_pages.shape
    P = page_tables.shape[1]
    if HD != num_heads * head_dim or HD2 != HD or v_pages.shape != k_pages.shape:
        raise ValueError(
            f'paged_attention: q {tuple(q.shape)}, pages '
            f'{tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not match '
            f'{num_heads} heads x {head_dim}')
    if head_dim > 256:
        raise ValueError('paged_attention: head_dim > 256 has no kernel')
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError('paged_attention: q and pages must share a dtype')
    if page_tables.shape[0] != B or seq_lens.shape != (B,) \
            or q_lens.shape != (B,):
        raise ValueError('paged_attention: page_tables/seq_lens/q_lens '
                         'must have batch size B')
    code = _build.dtype_code(q, KERNEL)
    _build.require_contiguous(KERNEL, q=q, k_pages=k_pages, v_pages=v_pages)
    # the kernel takes int32 metadata on q's device (x64 is off in JAX,
    # so the reference's tables and lengths are int32 as well)
    pt = page_tables.to(q.device, torch.int32).contiguous()
    sl = seq_lens.to(q.device, torch.int32).contiguous()
    qlen = q_lens.to(q.device, torch.int32).contiguous()
    out = torch.empty_like(q)
    _build.launch('ptt_ragged_paged_attention', KERNEL, q.device,
                  q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  pt.data_ptr(), sl.data_ptr(), qlen.data_ptr(),
                  out.data_ptr(), B, T, num_heads, head_dim, N, ps, P, code)
    return out


def _flat_slots(page_tables, seq_lens, q_lens, T, N, ps):
    """[B*T] flat pool slot per new token, N*ps (out of range) for
    padding. Token t of row b lands at global position
    seq_lens[b] - q_lens[b] + t, i.e. flat slot
    page_tables[b, pos // ps] * ps + pos % ps."""
    dev = page_tables.device
    seq = seq_lens.to(dev, torch.long)
    ql = q_lens.to(dev, torch.long)
    t = torch.arange(T, device=dev)[None]
    pos = seq[:, None] - ql[:, None] + t                       # [B, T]
    valid = t < ql[:, None]
    P = page_tables.shape[1]
    # padding positions may fall outside the table: any in-range column
    # will do, the slot is discarded below
    col = torch.where(valid, pos // ps, torch.zeros_like(pos)).clamp(0, P - 1)
    page_idx = torch.gather(page_tables.to(torch.long).clamp(0, N - 1), 1, col)
    flat = page_idx * ps + pos % ps
    flat = torch.where(valid, flat, torch.full_like(flat, N * ps))
    return flat.reshape(-1)


def kv_write_index(page_tables, seq_lens, q_lens, T, N, ps, device=None):
    """(src, dst): rows of the flattened [B*T, H*D] new K/V that are real
    tokens, and their flat pool slots — padding already filtered out, so
    an idle slot (q_len 0, page row of zeros) never reaches page 0.
    Computed once per forward on the metadata's device (the host, in the
    engine) and moved to `device`."""
    flat = _flat_slots(page_tables, seq_lens, q_lens, T, N, ps)
    src = torch.nonzero(flat < N * ps).reshape(-1)
    dst = flat[src]
    if device is not None:
        src, dst = src.to(device), dst.to(device)
    return src, dst


def write_kv_pages(k_pages, v_pages, k_new, v_new, page_tables, seq_lens,
                   q_lens, index=None):
    """Scatter this step's new K/V rows into the pool in place.

    k_new/v_new: [B, T, H*D] right-padded like q. `index` is a
    precomputed `kv_write_index` (the model computes it once per forward
    and shares it across layers). Returns the (same) page tensors."""
    N, ps, HD = k_pages.shape
    B, T, _ = k_new.shape
    if index is None:
        index = kv_write_index(page_tables, seq_lens, q_lens, T, N, ps,
                               device=k_pages.device)
    src, dst = index
    k_pages.view(N * ps, HD).index_copy_(
        0, dst, k_new.reshape(B * T, HD)[src].to(k_pages.dtype))
    v_pages.view(N * ps, HD).index_copy_(
        0, dst, v_new.reshape(B * T, HD)[src].to(v_pages.dtype))
    return k_pages, v_pages
