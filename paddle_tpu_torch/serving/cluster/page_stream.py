"""KV-page streaming between pools (the prefill-to-decode handoff) —
counterpart of `paddle_tpu/serving/cluster/page_stream.py`.

Whole page rows move from a source pool's tensors into chosen pages of a
destination pool: a gather on the page axis (`index_select`) and a
scatter (`index_copy_`), chunked by `core.bucketing._chunk_spans` so the
staging copy stays bounded. On one card both are device copies; nothing
is recomputed or re-quantized, so a streamed page equals the page the
prefill wrote byte for byte. Each layer's buffer tuple is streamed
element by element, so an int8 pool's fp32 scale buffers `(k, v, ks,
vs)` travel with their int8 pages (one page id addresses all four).

The JAX version is functional and returns new arrays; this one copies
into the destination tensors in place and returns the same list. The
sink page (index num_pages, the last row) is never written: a
destination id outside [0, num_pages) raises.
"""
import torch

from ...core import monitor as _m
from ...core.bucketing import _chunk_spans


def stream_kv_pages(src_kv, dst_kv, src_pages, dst_pages, chunk_pages=0):
    """Copy page rows src_pages[i] -> dst_pages[i] in every layer buffer
    of `dst_kv`, in place; returns dst_kv. chunk_pages caps the pages one
    copy moves (0 = one copy a buffer)."""
    if len(src_pages) != len(dst_pages):
        raise ValueError(f"page list mismatch: {len(src_pages)} src "
                         f"vs {len(dst_pages)} dst")
    n = len(src_pages)
    if n == 0:
        return dst_kv
    sink = dst_kv[0][0].shape[0] - 1
    if min(dst_pages) < 0 or max(dst_pages) >= sink:
        raise ValueError(f"destination pages must lie in [0, {sink}): "
                         f"the sink page is never written")
    spans = _chunk_spans(n, 1, chunk_pages) or [(0, n)]
    device = dst_kv[0][0].device
    src_idx = torch.tensor(list(src_pages), dtype=torch.long,
                           device=src_kv[0][0].device)
    dst_idx = torch.tensor(list(dst_pages), dtype=torch.long, device=device)
    nbytes = 0
    for layer_src, layer_dst in zip(src_kv, dst_kv):
        for s, d in zip(layer_src, layer_dst):
            for st, w in spans:
                rows = s.index_select(0, src_idx[st:st + w])
                d.index_copy_(0, dst_idx[st:st + w], rows.to(device))
            nbytes += n * s[0].numel() * s.element_size()
    _m.counter('ptpu_serve_pd_streamed_pages_total',
               help='KV pages streamed prefill->decode '
                    '(lifetime)').inc(n)
    _m.counter('ptpu_serve_pd_streamed_bytes_total',
               help='device bytes streamed prefill->decode, scale '
                    'buffers included (lifetime)').inc(nbytes)
    return dst_kv
