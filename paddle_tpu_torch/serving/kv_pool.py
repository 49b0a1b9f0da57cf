"""Block-paged KV-cache pool — counterpart of `paddle_tpu/serving/kv_pool.py`.

One tensor pair per decoder layer — `[num_pages, page_size, heads *
head_dim]` — shared by every in-flight request; with `dtype='int8'` a
4-tuple per layer, int8 (k_pages, v_pages) and their fp32 (k_scales,
v_scales) `[num_pages, page_size, heads]`, one abs-max scale per (slot,
head) (kv_pool.py:192-248 in the JAX package). Sequences own pages
through per-sequence page tables; a host-side free-list allocator hands
pages out and takes them back, so KV memory is O(pages in use) rather
than O(batch * max_seq_len). The ragged paged-attention kernel reads a
row's pages straight from this layout (`ops/kernels/paged_attention.py`
has the shapes); `write_kv_pages` updates them in place.

Copy-on-write prefix caching (`prefix_cache=True`): physical pages are
REFCOUNTED, and a radix prefix index maps token blocks (page_size
tokens) to the page that already holds their K/V, keyed by
`(parent_page, tuple(block_tokens))` so a key identifies the whole token
prefix exactly. Only FULL pages are shared; a request diverging mid-page
recomputes from the last shared page boundary into a private page, so
shared pages are never written. Released pages whose content is still
indexed park in an LRU "cached" set: allocatable like free pages
(eviction drops the index subtree under them, so a recycled page id can
never satisfy a stale chain), and resurrected for free by a later
matching prompt — including a preempted request resuming.

Invariants (held by tests/test_torch_serving.py, as the JAX pool's are
by tests/test_serving.py):
  * a page's refcount equals the number of sequences mapping it;
  * free + cached + mapped partitions the pool at all times;
  * release drops every page of a sequence exactly once.

Each device tensor holds one page more than the allocator hands out:
page `num_pages`, the sink. No page table maps it, so no read ever sees
it; every step's padded K/V rows are written there
(`ops/kernels/paged_attention.py`), so the write index needs no host
sync, not even in the engine's fused decode windows, whose done mask
never leaves the card.

Not ported yet: the host-RAM tier and mp sharding.
"""
import collections
import hashlib
import math
import struct

import numpy as np
import torch


def chain_hash(parent_hash, block_tokens):
    """64-bit hash of one radix-chain link: the parent chain hash plus
    this block's tokens (blake2b, fixed little-endian packing) — the
    same function as the JAX package's, so digests agree across the two
    packages and across processes."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack('<Q', int(parent_hash) & 0xFFFFFFFFFFFFFFFF))
    h.update(np.asarray(list(block_tokens), '<i4').tobytes())
    return int.from_bytes(h.digest(), 'little')


def chain_hashes(tokens, page_size, limit=None):
    """Chain hashes of every FULL page_size-token block of `tokens`
    (capped at `limit` tokens), in chain order."""
    n = len(tokens) if limit is None else min(len(tokens),
                                              max(int(limit), 0))
    out, h = [], -1
    for i in range(n // int(page_size)):
        h = chain_hash(h, tokens[i * page_size:(i + 1) * page_size])
        out.append(h)
    return out


class PoolExhausted(RuntimeError):
    """No free pages — the scheduler's cue to stop admitting or to
    preempt a victim (engine.py)."""


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace('torch.', '')
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f'unknown KV dtype {dtype!r}')
    return dt


class KVPagePool:
    """Free-list page allocator + the paged device tensors.

    The tensors are created by `materialize(device, dtype)`, so pure
    allocator tests never allocate them. `kv[l]` is layer l's (k_pages,
    v_pages) pair, or (k_pages, v_pages, k_scales, v_scales) for an
    int8 pool.
    """

    def __init__(self, num_pages, page_size, num_layers=0, num_heads=0,
                 head_dim=0, dtype=None, prefix_cache=False):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = _torch_dtype(dtype)
        self.prefix_cache = bool(prefix_cache)
        self.kv = None                      # per layer (k, v[, ks, vs])
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._ref = {}                      # page id -> mapper count
        self._owners = {}                   # page id -> set of seq ids
        self._seq_pages = {}                # seq id -> [page ids]
        # prefix index: (parent index page | -1, block token tuple) ->
        # physical page; _cached is the LRU set of ref-0-but-indexed
        # pages (allocatable, resurrectable)
        self._index = {}
        self._page_key = {}                 # page id -> its index key
        self._children = {}                 # page id -> child page ids
        self._cached = collections.OrderedDict()
        self._registered_upto = {}          # seq id -> tokens indexed
        self.alloc_total = 0
        self.free_total = 0
        self.high_water = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0

    # -- device tensors ------------------------------------------------------
    @property
    def quantized(self):
        """True when pages store int8 + per-(slot, head) fp32 scales."""
        return self.dtype == torch.int8

    def materialize(self, device, dtype=None):
        """Create each layer's zeroed pages on `device` (and, for an int8
        pool, zeroed scales), with the sink page past the last one."""
        if self.kv is not None:
            return self.kv
        self.dtype = _torch_dtype(dtype) or self.dtype or torch.float32
        shape = (self.num_pages + 1, self.page_size,
                 self.num_heads * self.head_dim)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        if self.quantized:
            sshape = shape[:2] + (self.num_heads,)
            self.kv = [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                        zeros(sshape, torch.float32),
                        zeros(sshape, torch.float32))
                       for _ in range(self.num_layers)]
        else:
            self.kv = [(zeros(shape, self.dtype), zeros(shape, self.dtype))
                       for _ in range(self.num_layers)]
        return self.kv

    def bytes_per_token(self):
        """Device bytes one token's K+V occupies across all layers: int8
        pages cost heads*head_dim + 4*heads (the scales) per K and per V,
        dense pages heads*head_dim*itemsize (kv_pool.py:232-248)."""
        hd = self.num_heads * self.head_dim
        if self.quantized:
            per = hd + 4 * self.num_heads
        else:
            per = hd * (torch.tensor([], dtype=self.dtype).element_size()
                        if self.dtype is not None else 4)
        return 2 * per * self.num_layers

    def pool_bytes(self):
        return self.num_pages * self.page_size * self.bytes_per_token()

    def drop_arrays(self):
        """Release the device tensors (engine shutdown)."""
        self.kv = None

    # -- allocator -----------------------------------------------------------
    def pages_for(self, n_tokens):
        return max(1, math.ceil(n_tokens / self.page_size))

    @property
    def pages_in_use(self):
        """Pages mapped by at least one sequence. Cached (indexed but
        unmapped) pages are reclaimable and count as free."""
        return self.num_pages - len(self._free) - len(self._cached)

    @property
    def free_pages(self):
        """Allocatable pages: truly free + cached-evictable."""
        return len(self._free) + len(self._cached)

    @property
    def cached_pages(self):
        return len(self._cached)

    @property
    def shared_pages(self):
        """Physical pages currently mapped by more than one sequence."""
        return sum(1 for r in self._ref.values() if r > 1)

    def utilization(self):
        return self.pages_in_use / self.num_pages

    def page_table(self, seq_id):
        return list(self._seq_pages.get(seq_id, ()))

    def _evict_subtree(self, page):
        """Drop `page` and every index descendant from the prefix index,
        returning the cached (ref-0) ones to the free list. A descendant
        a live sequence still maps is only de-indexed. Iterative: chains
        grow one node per page, deeper than Python's recursion limit at
        small page sizes."""
        stack = [page]
        while stack:
            p = stack.pop()
            stack.extend(self._children.pop(p, ()))
            key = self._page_key.pop(p)
            del self._index[key]
            parent = key[0]
            if parent != -1 and parent in self._children:
                self._children[parent].discard(p)
            if p in self._cached:
                del self._cached[p]
                self._free.append(p)
                self.prefix_evictions += 1

    def _take_page(self, seq_id):
        if not self._free and self._cached:
            # evict the least-recently-used cached prefix subtree
            self._evict_subtree(next(iter(self._cached)))
        if not self._free:
            raise PoolExhausted(
                f"KV pool exhausted: {self.num_pages} pages of "
                f"{self.page_size} tokens all in use")
        page = self._free.pop()
        if page in self._ref:
            raise RuntimeError(f"page {page} double-mapped")
        self._ref[page] = 1
        self._owners[page] = {seq_id}
        self._seq_pages.setdefault(seq_id, []).append(page)
        self.alloc_total += 1
        self.high_water = max(self.high_water, self.pages_in_use)
        return page

    def _map_existing(self, page, seq_id):
        """Map an already-resident page into seq_id's table: incref a
        live page, or resurrect a cached one (ref 0 -> 1)."""
        if page in self._cached:
            del self._cached[page]
            self._ref[page] = 1
            self._owners[page] = {seq_id}
        else:
            self._ref[page] += 1
            self._owners[page].add(seq_id)
        self._seq_pages.setdefault(seq_id, []).append(page)
        self.high_water = max(self.high_water, self.pages_in_use)

    def ensure_capacity(self, seq_id, n_tokens):
        """Grow seq_id's page list to hold n_tokens. Raises PoolExhausted
        with the partial growth kept (the caller preempts and retries)."""
        need = self.pages_for(n_tokens)
        while len(self._seq_pages.get(seq_id, ())) < need:
            self._take_page(seq_id)
        return self._seq_pages[seq_id]

    def try_reserve(self, seq_id, n_tokens):
        """Grow seq_id's page list to hold n_tokens, or change nothing:
        the fused decode window's all-or-nothing reservation
        (kv_pool.py:596). A failed reservation hands its own fresh pages
        straight back (private and unindexed, as trim's are); returns
        True when the pages are held."""
        need = self.pages_for(n_tokens)
        grown = 0
        try:
            while len(self._seq_pages.get(seq_id, ())) < need:
                self._take_page(seq_id)
                grown += 1
        except PoolExhausted:
            pages = self._seq_pages.get(seq_id, [])
            for _ in range(grown):
                page = pages.pop()
                del self._ref[page]
                del self._owners[page]
                self._free.append(page)
                self.free_total += 1
            return False
        return True

    def release(self, seq_id):
        """Drop seq_id's mapping of every page it holds, exactly once per
        page. A page whose refcount reaches zero becomes reclaimable:
        indexed pages park in the cached (LRU, resurrectable) set,
        unindexed ones return to the free list. Returns the number of
        pages made reclaimable."""
        pages = self._seq_pages.pop(seq_id, [])
        self._registered_upto.pop(seq_id, None)
        reclaimed = 0
        for page in pages:
            owners = self._owners.get(page)
            if owners is None or seq_id not in owners:
                raise RuntimeError(
                    f"page {page} owned by {owners}, freed by {seq_id}")
            owners.discard(seq_id)
            self._ref[page] -= 1
            if self._ref[page] > 0:
                continue
            del self._ref[page]
            del self._owners[page]
            if page in self._page_key:
                self._cached[page] = None       # LRU newest
            else:
                self._free.append(page)
            reclaimed += 1
            self.free_total += 1
        return reclaimed

    def trim(self, seq_id, n_tokens):
        """Give back trailing private unindexed pages beyond what
        n_tokens needs. Returns the number of pages freed."""
        keep = self.pages_for(n_tokens)
        pages = self._seq_pages.get(seq_id, [])
        freed = 0
        while len(pages) > keep:
            page = pages[-1]
            if self._ref.get(page) != 1 or page in self._page_key:
                break
            pages.pop()
            del self._ref[page]
            del self._owners[page]
            self._free.append(page)
            freed += 1
            self.free_total += 1
        return freed

    # -- prefix index --------------------------------------------------------
    def _match_pages(self, tokens, limit=None):
        """Walk the index chain over full token blocks; returns the
        matched physical pages (longest indexed prefix, in order)."""
        ps = self.page_size
        n = len(tokens) if limit is None else min(len(tokens),
                                                  max(int(limit), 0))
        pages, parent = [], -1
        for i in range(n // ps):
            page = self._index.get(
                (parent, tuple(tokens[i * ps:(i + 1) * ps])))
            if page is None:
                break
            pages.append(page)
            parent = page
        return pages

    def peek_prefix(self, tokens, limit=None):
        """Non-mutating admission probe: (cached_tokens, live_pages,
        resurrect_pages). Live pages are mapped by a sibling and cost the
        page budget nothing; resurrect pages sit in the cached set and
        cost one allocatable page each (they just skip the prefill)."""
        if not self.prefix_cache:
            return 0, 0, 0
        pages = self._match_pages(tokens, limit)
        live = sum(1 for p in pages if self._ref.get(p, 0) > 0)
        return len(pages) * self.page_size, live, len(pages) - live

    def match_and_map(self, seq_id, tokens, limit=None):
        """Map the longest indexed prefix of `tokens` (full blocks,
        capped at `limit` tokens) into seq_id's page table. Returns the
        number of prefix tokens now covered — the caller skips
        prefilling them. Counted as one hit (or miss) per lookup."""
        if not self.prefix_cache:
            return 0
        if self._seq_pages.get(seq_id):
            # a prior prefill attempt grew partial pages before
            # PoolExhausted: shared pages must sit at the FRONT of the
            # table, so prefill privately
            return 0
        pages = self._match_pages(tokens, limit)
        for page in pages:
            self._map_existing(page, seq_id)
        if not pages:
            self.prefix_misses += 1
            return 0
        cached = len(pages) * self.page_size
        self.prefix_hits += 1
        self.prefix_hit_tokens += cached
        self._registered_upto[seq_id] = cached
        return cached

    def register_prefix(self, seq_id, tokens, written):
        """Index seq_id's newly completed full pages (the first `written`
        tokens of `tokens` have K/V resident). A block already indexed
        elsewhere is NOT re-registered — the chain advances through the
        canonical page — and the walk restarts at the root every call,
        so a chain broken by eviction self-heals from this sequence's own
        pages."""
        if not self.prefix_cache:
            return
        ps = self.page_size
        blocks = min(int(written), len(tokens)) // ps
        if blocks * ps <= self._registered_upto.get(seq_id, 0):
            return
        seq_pages = self._seq_pages.get(seq_id, [])
        parent = -1
        for i in range(min(blocks, len(seq_pages))):
            key = (parent, tuple(tokens[i * ps:(i + 1) * ps]))
            page = self._index.get(key)
            if page is None:
                page = seq_pages[i]
                if page in self._page_key:      # already chained
                    break                       # under another key
                self._index[key] = page
                self._page_key[page] = key
                if parent != -1:
                    self._children.setdefault(parent, set()).add(page)
            parent = page
        self._registered_upto[seq_id] = blocks * ps

    def stats(self):
        return {
            'num_pages': self.num_pages,
            'page_size': self.page_size,
            'kv_dtype': str(self.dtype or torch.float32).replace('torch.',
                                                                 ''),
            'bytes_per_token': self.bytes_per_token(),
            'pool_bytes': self.pool_bytes(),
            'pages_in_use': self.pages_in_use,
            'free_pages': self.free_pages,
            'utilization': self.utilization(),
            'high_water': self.high_water,
            'alloc_total': self.alloc_total,
            'free_total': self.free_total,
            'sequences': len(self._seq_pages),
            'prefix_cache': self.prefix_cache,
            'cached_pages': self.cached_pages,
            'shared_pages': self.shared_pages,
            'prefix_hits_total': self.prefix_hits,
            'prefix_misses_total': self.prefix_misses,
            'prefix_hit_tokens_total': self.prefix_hit_tokens,
            'prefix_evictions_total': self.prefix_evictions,
        }
