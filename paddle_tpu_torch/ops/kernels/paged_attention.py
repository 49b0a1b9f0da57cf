"""Ragged paged attention for the serving engine — counterpart of
`paddle_tpu/ops/pallas/paged_attention.py` (its `_ragged_paged_kernel`,
:78), over dense pages and over int8 pages (its `quantized` branch).

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
  k_scales    fp32 [N_pages, page_size, H]   int8 pages only: one
  v_scales    fp32 [N_pages, page_size, H]   abs-max scale per (slot, head)

Query t of row b sits at global position seq_lens[b] - q_lens[b] + t and
attends keys at positions <= its own and < seq_lens[b].

`ragged_paged_attention` launches the CUDA kernel (`csrc/
paged_attention.cu`) on CUDA tensors — `paged_attention` over pages in
q's dtype, `paged_attention_int8` over int8 pages, each with its own
launch counter, one count a call — and runs
`ragged_paged_attention_plain` on CPU tensors. The kernel splits each
row's keys over several CTAs (`paged_splits` chooses how many, from the
shapes alone) and merges their partial softmax states in fp32 in a
second pass, through a scratch tensor the wrapper allocates. With int8
pages both dequantize each K/V row by its (slot, head) scale before it
meets q or the probabilities, so the attention math stays fp32, as the
Pallas body does (:126-128) and the dense JAX route does after its
gather (`_dequant_gathered`, :208). The plain
version computes exactly what the Pallas body computes, including its
edge semantics: only pages whose start lies below seq_len take part, a masked
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
new arrays. The page tensors end in one sink page, which no page table
maps and so no read ever sees (the serving pool allocates it, kv_pool.py):
padded tokens (t >= q_len) are written there, where the JAX scatter drops
them through an out-of-range index, so they never reach slot 0 of page 0
and the write index needs no filtering, hence no host sync, whichever
device the metadata lives on. `write_kv_pages_quantized` is its twin for
int8 pools: each new row is quantized per (token, head) by
`quantize_kv_rows` (symmetric abs-max, scale = max(amax, 1e-30) / 127,
codes round(x / scale) clipped to ±127, half to even as `jnp.round`) and
its codes and scales land in the same flat slots.
"""
import math

import torch

from . import _build

KERNEL = 'paged_attention'
KERNEL_INT8 = 'paged_attention_int8'
_build.register(KERNEL)
_build.register(KERNEL_INT8)

NEG_INF = -1e30
TILE_KEYS = 64          # keys of a staged tile (csrc/paged_attention.cu)
CTAS_PER_SM = 8         # the grid the splits aim at


def paged_splits(B, T, H, P, page_size, sms):
    """(qb, splits, tiles_per_split) of a launch: qb queries a CTA (1 at
    decode, 8 for wider blocks), and the keys of the longest row a table
    maps (P x page_size) cut into `splits` splits of `tiles_per_split`
    tiles of TILE_KEYS keys, as many splits as give about CTAS_PER_SM
    CTAs an SM. Shapes only: the lengths live on the device, and reading
    them would cost a host sync."""
    qb = 1 if T == 1 else 8
    blocks = B * H * -(-T // qb)
    tiles = -(-P * page_size // TILE_KEYS)
    splits = max(1, min(tiles, -(-CTAS_PER_SM * sms // blocks)))
    per_split = -(-tiles // splits)
    return qb, -(-tiles // per_split), per_split


def _gathered(pages, scales, pt, H, D):
    """A row's pages gathered dense, [B, P*ps, H, D] fp32; int8 pages
    dequantized by their (slot, head) scales (`_dequant_gathered`)."""
    B, P = pt.shape
    ps = pages.shape[1]
    x = pages[pt].float().reshape(B, P * ps, H, D)
    if scales is not None:
        x = x * scales[pt].float().reshape(B, P * ps, H)[..., None]
    return x


def ragged_paged_attention_plain(q, k_pages, v_pages, page_tables,
                                 seq_lens, q_lens, *, num_heads, head_dim,
                                 k_scales=None, v_scales=None):
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
    k = _gathered(k_pages, k_scales, pt, H, D)
    v = _gathered(v_pages, v_scales, pt, H, D)
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


def _check_scales(k_pages, v_pages, k_scales, v_scales, num_heads):
    """int8 pages come with both scales, fp32 contiguous [N, ps, H], and
    scales come with int8 pages only."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError('paged_attention: pass both k_scales and '
                         'v_scales, or neither')
    int8 = k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8
    if k_scales is None:
        if int8:
            raise TypeError('paged_attention: int8 pages need their '
                            'k_scales and v_scales')
        return
    if not (k_pages.dtype == v_pages.dtype == torch.int8):
        raise TypeError('paged_attention: k_scales/v_scales come with '
                        'int8 pages only')
    want = (k_pages.shape[0], k_pages.shape[1], num_heads)
    for name, t in (('k_scales', k_scales), ('v_scales', v_scales)):
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or not t.is_contiguous():
            raise ValueError(
                f'paged_attention: {name} must be contiguous float32 '
                f'{list(want)}, got {t.dtype} {list(t.shape)}')


def ragged_paged_attention(q, k_pages, v_pages, page_tables, seq_lens,
                           q_lens, *, num_heads, head_dim, k_scales=None,
                           v_scales=None):
    """Attention of each row's new queries over its pages; int8 pages
    with their k_scales/v_scales. See the module docstring for layouts
    and semantics."""
    if torch.is_grad_enabled() and (q.requires_grad or k_pages.requires_grad
                                    or v_pages.requires_grad):
        raise RuntimeError(
            'ragged_paged_attention has no backward (nor has the JAX '
            'kernel): call it under torch.no_grad() or '
            'torch.inference_mode(), as the serving engine does')
    _check_scales(k_pages, v_pages, k_scales, v_scales, num_heads)
    quantized = k_scales is not None
    scales = (k_scales, v_scales) if quantized else ()
    if _build.on_cpu(q, k_pages, v_pages, *scales):
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, page_tables, seq_lens, q_lens,
            num_heads=num_heads, head_dim=head_dim, k_scales=k_scales,
            v_scales=v_scales)
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
    if not quantized and not (q.dtype == k_pages.dtype == v_pages.dtype):
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
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    split = paged_splits(B, T, num_heads, P, ps, sms)
    # the splits' (m, l, acc) in fp32, merged by the kernel's second pass
    part = None if split[1] == 1 else torch.empty(
        B * T * num_heads * split[1] * (head_dim + 2), dtype=torch.float32,
        device=q.device)
    tail = (out.data_ptr(), _build.ptr(part), B, T, num_heads, head_dim, N,
            ps, P, *split, code)
    if quantized:
        _build.launch('ptt_ragged_paged_attention_int8', KERNEL_INT8,
                      q.device, q.data_ptr(), k_pages.data_ptr(),
                      v_pages.data_ptr(), k_scales.data_ptr(),
                      v_scales.data_ptr(), pt.data_ptr(), sl.data_ptr(),
                      qlen.data_ptr(), *tail)
    else:
        _build.launch('ptt_ragged_paged_attention', KERNEL, q.device,
                      q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      pt.data_ptr(), sl.data_ptr(), qlen.data_ptr(), *tail)
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
    """[B*T] flat pool slot of each row of the flattened [B*T, H*D] new
    K/V, for page tensors of N pages whose last one (N - 1) is the sink
    (see the module docstring): padding goes to the sink's first slot.
    Computed once per forward on the metadata's device (the host, in
    the engine's one-dispatch steps; the card, in its fused decode
    windows) and moved to `device`."""
    dst = _flat_slots(page_tables, seq_lens, q_lens, T, N - 1, ps)
    return dst if device is None else dst.to(device)


def write_kv_pages(k_pages, v_pages, k_new, v_new, page_tables, seq_lens,
                   q_lens, index=None):
    """Scatter this step's new K/V rows into the pool in place.

    k_new/v_new: [B, T, H*D] right-padded like q; the pages end in the
    sink page. `index` is a precomputed `kv_write_index` (the model
    computes it once per forward and shares it across layers). Returns
    the (same) page tensors."""
    N, ps, HD = k_pages.shape
    B, T, _ = k_new.shape
    if index is None:
        index = kv_write_index(page_tables, seq_lens, q_lens, T, N, ps,
                               device=k_pages.device)
    k_pages.view(N * ps, HD).index_copy_(
        0, index, k_new.reshape(B * T, HD).to(k_pages.dtype))
    v_pages.view(N * ps, HD).index_copy_(
        0, index, v_new.reshape(B * T, HD).to(v_pages.dtype))
    return k_pages, v_pages


def quantize_kv_rows(x, num_heads):
    """[B, T, H*D] float -> (int8 [B, T, H*D], fp32 scales [B, T, H]):
    symmetric abs-max per (token, head), `quantize_kv_rows` (:316) of
    the JAX module op for op (fp32 division, round half to even), so a
    token's scales are final the moment it is written. Both divisions
    are tensor by tensor: torch may compute a division by a Python
    scalar as a multiply by its reciprocal, which rounds differently."""
    B, T, HD = x.shape
    D = HD // num_heads
    xf = x.float().reshape(B, T, num_heads, D)
    amax = xf.abs().amax(-1)                                   # [B, T, H]
    scale = amax.clamp_min(1e-30) / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(B, T, HD), scale


def write_kv_pages_quantized(k_pages, v_pages, k_scales, v_scales, k_new,
                             v_new, page_tables, seq_lens, q_lens, *,
                             num_heads, index=None):
    """Quantizing twin of write_kv_pages for int8 pools (JAX :331): each
    new token's K/V row is quantized per head and its codes and fp32
    scales scattered in place into the same flat slots. Returns the
    (same) four tensors."""
    N, ps, HD = k_pages.shape
    B, T, _ = k_new.shape
    H = num_heads
    if index is None:
        index = kv_write_index(page_tables, seq_lens, q_lens, T, N, ps,
                               device=k_pages.device)
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        codes, sc = quantize_kv_rows(new, H)
        pages.view(N * ps, HD).index_copy_(0, index, codes.reshape(B * T, HD))
        scales.view(N * ps, H).index_copy_(0, index, sc.reshape(B * T, H))
    return k_pages, v_pages, k_scales, v_scales
