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

Weighted eviction: indexed pages remember the tenant whose request first
registered them (`register_prefix(owner=)`); while the degradation
ladder sits at stage 3 the engine installs per-tenant weights
(`set_eviction_weights`) and cached-subtree eviction starts from the
lightest tenant's LRU root instead of the global one.

Host-RAM tier (`attach_host_tier`, `host_tier.HostTier`): under pool
pressure, cached (ref-0 parked) subtrees SPILL to pinned host buffers
instead of being evicted — each spilled page's index entry re-keys onto
a negative HOST marker (`marker = -2 - host_slot`; device pages are >= 0
and the chain root is -1, so markers never collide), its children
re-parent onto the marker, and the device page returns to the free list
when the transfer lands. A matching prompt (or a preempted request
resuming) walks the same radix chain, finds the markers and RESURRECTS
the pages by a host-to-device fetch instead of re-prefilling them.
Device pages whose spill is in flight sit in `_spilling`, outside free
AND cached, so `try_reserve` and `_take_page` cannot hand them out. The
allocator runs under `_lock`: the tier's landing callback returns pages
from its transfer thread.

Invariants (held by tests/test_torch_serving.py and
tests/test_torch_serving_kvtier.py, as the JAX pool's are by
tests/test_serving.py and tests/test_serving_kvtier.py):
  * a page's refcount equals the number of sequences mapping it;
  * free + cached + mapped partitions the pool at all times;
  * release drops every page of a sequence exactly once.

Each device tensor holds one page more than the allocator hands out:
page `num_pages`, the sink. No page table maps it, so no read ever sees
it; every step's padded K/V rows are written there
(`ops/kernels/paged_attention.py`), so the write index needs no host
sync, not even in the engine's fused decode windows, whose done mask
never leaves the card.

The cluster router's hooks: `prefix_chain_hashes` publishes the chain
hash of every indexed chain (the replica's affinity digest, memoized
until the index gains or loses a chain), and `warm_prefix` fetches the
host-resident pages of a prompt's chain back into parked device pages
ahead of the request (the router's prefetch hint; free pages only).

Not ported yet: mp sharding.
"""
import collections
import hashlib
import math
import struct
import threading

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
        # prefix index: (parent index ref | -1, block token tuple) ->
        # physical page or host marker; _cached is the LRU set of
        # ref-0-but-indexed pages (allocatable, resurrectable)
        self._index = {}
        self._page_key = {}                 # page id -> its index key
        self._children = {}                 # page id -> child page ids
        self._cached = collections.OrderedDict()
        self._digest_cache = None           # (limit, hashes) memo of
                                            # prefix_chain_hashes
        self._registered_upto = {}          # seq id -> tokens indexed
        # weighted eviction: indexed page -> the tenant that first
        # registered it; tenant -> weight while the ladder is at stage 3
        self._page_tenant = {}
        self._evict_weights = None
        self._lock = threading.Lock()
        # host-RAM tier: markers (<= -2) live in _index / _page_key /
        # _children like device pages; _spilling pins device pages whose
        # spill is in flight (outside free AND cached)
        self.host_tier = None
        self._spilling = set()
        self.host_resurrect_pages = 0
        self.host_resurrect_tokens = 0
        self._pending_resurrect = None      # the engine pops it
        self.alloc_total = 0
        self.free_total = 0
        self.high_water = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0

    def attach_host_tier(self, tier):
        """Install the host-RAM tier (host_tier.HostTier) before any
        spill; the pool never builds one itself."""
        self.host_tier = tier
        return tier

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
        """Pages mapped by at least one sequence (and pages pinned by an
        in-flight spill). Cached pages are reclaimable and count as
        free."""
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

    def capacity_tokens(self, seq_id):
        """Tokens the sequence can hold without another allocation."""
        return len(self._seq_pages.get(seq_id, ())) * self.page_size

    def reclaimable_pages(self, seq_id):
        """Pages release(seq_id) would free right now (the sequence is
        their only mapper) — the admission sweep's preemption-
        feasibility estimate: a victim whose pages are all shared
        reclaims nothing."""
        with self._lock:
            return sum(1 for p in self._seq_pages.get(seq_id, ())
                       if self._ref.get(p) == 1)

    def page_table(self, seq_id):
        return list(self._seq_pages.get(seq_id, ()))

    def owned_sequences(self):
        return list(self._seq_pages)

    def _evict_subtree(self, page):
        """Drop `page` and every index descendant from the prefix index,
        returning the cached (ref-0) ones to the free list and the host
        markers' slots to the tier. A descendant a live sequence still
        maps is only de-indexed. Iterative: chains grow one node per
        page, deeper than Python's recursion limit at small page
        sizes."""
        self._digest_cache = None
        stack = [page]
        while stack:
            p = stack.pop()
            stack.extend(self._children.pop(p, ()))
            key = self._page_key.pop(p)
            del self._index[key]
            parent = key[0]
            if parent != -1 and parent in self._children:
                self._children[parent].discard(p)
            self._page_tenant.pop(p, None)
            if p <= -2:
                # host-tier node: the index entry IS the page
                if self.host_tier is not None:
                    self.host_tier.free_slot(-2 - p)
                self.prefix_evictions += 1
            elif p in self._cached:
                del self._cached[p]
                self._free.append(p)
                self.prefix_evictions += 1

    def set_eviction_weights(self, weights):
        """Install (or clear, with None) per-tenant eviction weights.
        While set, cached-subtree eviction picks the root whose owning
        tenant has the LOWEST weight (LRU order within a weight; unowned
        pages weigh 1.0) — the degradation ladder's stage-3 lever."""
        self._evict_weights = (None if weights is None
                               else {str(k): float(v)
                                     for k, v in weights.items()})

    def _pick_eviction_root(self):
        """The cached page eviction starts from: the global LRU, or under
        weighted eviction the LRU cached page of the lightest tenant."""
        if self._evict_weights is None:
            return next(iter(self._cached))
        w = self._evict_weights
        return min(self._cached,
                   key=lambda p: w.get(self._page_tenant.get(p), 1.0))

    # -- host-RAM tier -------------------------------------------------------
    def _rekey_node(self, old, new):
        """Move a radix node's identity from ref `old` to ref `new`: its
        index entry, its children's keys (they chain through the parent
        ref), the parent's child set and the tenant tag. Spill (page ->
        marker) and resurrect (marker -> page) are the same
        bookkeeping."""
        self._digest_cache = None
        key = self._page_key.pop(old)
        del self._index[key]
        self._index[key] = new
        self._page_key[new] = key
        parent = key[0]
        if parent != -1 and parent in self._children:
            self._children[parent].discard(old)
            self._children[parent].add(new)
        kids = self._children.pop(old, None)
        if kids:
            self._children[new] = kids
            for c in list(kids):
                ckey = self._page_key.pop(c)
                nkey = (new, ckey[1])
                del self._index[ckey]
                self._index[nkey] = c
                self._page_key[c] = nkey
        tn = self._page_tenant.pop(old, None)
        if tn is not None:
            self._page_tenant[new] = tn

    def _spill_landed_locked(self, pages):
        for p in pages:
            if p in self._spilling:
                self._spilling.discard(p)
                self._free.append(p)

    def _spill_landed(self, pages):
        with self._lock:
            self._spill_landed_locked(pages)

    def _spill_prepare(self, root):
        """Re-key `root`'s cached (ref-0) subtree pages onto host markers
        and pin them in `_spilling` — the index half of a spill, lock
        held by the caller. Live descendants stay on the card (only their
        chain link re-parents). Slots are all-or-nothing per subtree; a
        full tier prepares nothing and the caller evicts instead.
        Returns (device_pages, host_slots) or None. The transfer is the
        caller's: inline, or queued to the tier's thread outside the
        pool lock (the tier's bounded window must never be waited on
        while holding the lock its landing callback needs)."""
        tier = self.host_tier
        if tier is None or self.kv is None:
            return None
        cached = []
        stack = [root]
        while stack:                # parents visit before children, so
            p = stack.pop()         # a child re-keys under its parent's
            stack.extend(self._children.get(p, ()))     # marker
            if p in self._cached:
                cached.append(p)
        if not cached:
            return None
        slots = tier.alloc_slots(len(cached))
        if slots is None:
            return None
        for p, slot in zip(cached, slots):
            self._rekey_node(p, -2 - slot)
            del self._cached[p]
            self._spilling.add(p)
        return cached, slots

    def _spill_subtree(self, root):
        """Synchronous spill of `root`'s cached subtree (the exhaustion
        path of `_take_page`: the page is needed now). Lock held by the
        caller. Returns the device pages spilled."""
        prep = self._spill_prepare(root)
        if prep is None:
            return []
        pages, slots = prep
        self.host_tier.spill_sync(self.kv, pages, slots)
        self._spill_landed_locked(pages)
        return pages

    def spill_lru(self, max_pages=None, sync=False):
        """Spill LRU-parked cached subtrees until `max_pages` device
        pages are spilling (None = the whole parked set) — the engine's
        proactive spiller, called when utilization crosses the spill
        watermark so allocation seldom has to spill inline. Returns the
        pages spilled.

        Async jobs are submitted AFTER the lock is released: the tier's
        bounded in-flight window can block the producer, and the landing
        callback that unblocks it needs this lock. The pinned pages are
        not written until they land, and `self.kv` is only touched on
        the engine's thread (the one running this), so staging outside
        the lock reads exactly the rows that were pinned."""
        if self.host_tier is None:
            return 0
        n = 0
        jobs = []
        with self._lock:
            while self._cached and (max_pages is None or n < max_pages):
                prep = self._spill_prepare(self._pick_eviction_root())
                if prep is None:
                    break
                pages, slots = prep
                if sync:
                    self.host_tier.spill_sync(self.kv, pages, slots)
                    self._spill_landed_locked(pages)
                else:
                    jobs.append((pages, slots))
                n += len(pages)
        for pages, slots in jobs:
            self.host_tier.submit_spill(
                self.kv, pages, slots,
                on_landed=lambda pages=list(pages):
                    self._spill_landed(pages))
        return n

    def host_resident_pages(self):
        """Pages currently host-resident (markers in the index)."""
        with self._lock:
            return sum(1 for p in self._page_key if p <= -2)

    def pop_resurrect_stats(self):
        """Pop the pending resurrect accounting ({'pages', 'tokens'}
        fetched since the last pop, or None) — the engine turns it into
        a `resurrect` trace event."""
        with self._lock:
            r, self._pending_resurrect = self._pending_resurrect, None
        return r

    def _resurrect_locked(self, markers, seq_id):
        """Fetch host-resident `markers` back into device pages: mapped
        into seq_id's table, or parked (cached, ref 0) when seq_id is
        None (the router's warm hint, which takes free pages only and
        so never evicts). Lock held by the caller. Returns the device
        pages, aligned with `markers` (shorter when the pool ran out
        mid-chain)."""
        tier = self.host_tier
        devs, slots = [], []
        for m in markers:
            if m not in self._page_key:
                break               # destroyed under us by an eviction
            if seq_id is not None:
                try:
                    page = self._take_page(seq_id)
                except PoolExhausted:
                    break
            else:
                if not self._free:
                    break
                page = self._free.pop()
            devs.append(page)
            slots.append(-2 - m)
            self._rekey_node(m, page)
            if seq_id is None:
                self._cached[page] = None       # parked, LRU newest
        if devs:
            self.kv = tier.fetch(self.kv, slots, devs)
            for s in slots:
                tier.free_slot(s)
            self.host_resurrect_pages += len(devs)
            self.host_resurrect_tokens += len(devs) * self.page_size
            pend = self._pending_resurrect or {'pages': 0, 'tokens': 0}
            pend['pages'] += len(devs)
            pend['tokens'] += len(devs) * self.page_size
            self._pending_resurrect = pend
        return devs

    def warm_prefix(self, tokens, limit=None):
        """The router's prefetch hint: fetch the host-resident pages of
        the longest indexed chain for `tokens` back into parked device
        pages, so the request that follows prefix-hits device pages with
        no transfer of its own. Takes free pages only (a hint never
        evicts or preempts) and stops at the first page it cannot place.
        Returns the pages warmed; 0 without a host tier."""
        if self.host_tier is None or not self.prefix_cache:
            return 0
        # wait out in-flight spills of the chain's host pages before
        # taking the lock, as match_and_map does: the fetch must never
        # wait under the lock that an earlier spill job's callback needs
        with self._lock:
            slots = [-2 - p for p in self._match_pages(tokens, limit)
                     if p <= -2]
        if not slots:
            return 0
        self.host_tier.wait_landed(slots)
        with self._lock:
            refs = self._match_pages(tokens, limit)
            markers = [m for m in refs if m <= -2]
            return len(self._resurrect_locked(markers, seq_id=None))

    def _take_page(self, seq_id):
        if not self._free and self._cached:
            # host tier first: spill the LRU cached subtree inline (the
            # page is needed now and the proactive spiller didn't keep
            # up), so its prefix survives as host markers
            if self.host_tier is not None and self.kv is not None:
                self._spill_subtree(self._pick_eviction_root())
            if not self._free and self._cached:
                # evict the least-recently-used cached prefix subtree
                # (weight-ordered when eviction weights are installed)
                self._evict_subtree(self._pick_eviction_root())
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
        with self._lock:
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
        with self._lock:
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
        with self._lock:
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
        with self._lock:
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

    def reset(self):
        """Forget every mapping, index entry and host marker (the host
        slots go back to the tier, after any spill still writing them
        has landed); the device tensors stay."""
        if self.host_tier is not None:
            self.host_tier.drain()
        with self._lock:
            if self.host_tier is not None:
                for p in self._page_key:
                    if p <= -2:
                        self.host_tier.free_slot(-2 - p)
            self._spilling.clear()
            self._pending_resurrect = None
            self._free = list(range(self.num_pages - 1, -1, -1))
            self._ref.clear()
            self._owners.clear()
            self._seq_pages.clear()
            self._index.clear()
            self._page_key.clear()
            self._children.clear()
            self._cached.clear()
            self._registered_upto.clear()
            self._page_tenant.clear()
            self._digest_cache = None

    # -- prefix index --------------------------------------------------------
    def _match_pages(self, tokens, limit=None):
        """Walk the index chain over full token blocks; returns the
        matched refs (device pages, or host markers), in order."""
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
        resurrect_pages, host_pages). Live pages are mapped by a sibling
        and cost the page budget nothing; resurrect pages sit in the
        cached set and cost one allocatable page each (they just skip
        the prefill); host pages also cost one allocatable page each,
        plus a host-to-device transfer."""
        if not self.prefix_cache:
            return 0, 0, 0, 0
        with self._lock:
            pages = self._match_pages(tokens, limit)
            live = sum(1 for p in pages if self._ref.get(p, 0) > 0)
            host = sum(1 for p in pages if p <= -2)
        return (len(pages) * self.page_size, live,
                len(pages) - live - host, host)

    def match_and_map(self, seq_id, tokens, limit=None):
        """Map the longest indexed prefix of `tokens` (full blocks,
        capped at `limit` tokens) into seq_id's page table, increffing
        live pages, resurrecting cached ones and fetching host-resident
        ones back. Returns the number of prefix tokens now covered — the
        caller skips prefilling them. Counted as one hit (or miss) per
        lookup."""
        if not self.prefix_cache:
            return 0
        if self.host_tier is not None:
            # wait out in-flight spills of the chain's host pages BEFORE
            # taking the lock: the transfer thread lands jobs in order and
            # runs each job's callback (which takes this lock) before the
            # next, so a fetch waiting under the lock for a later job
            # would deadlock with an earlier job's callback. Only this
            # thread spills, so no new in-flight marker appears meanwhile.
            with self._lock:
                slots = [-2 - p for p in self._match_pages(tokens, limit)
                         if p <= -2]
            self.host_tier.wait_landed(slots)
        with self._lock:
            if self._seq_pages.get(seq_id):
                # a prior prefill attempt grew partial pages before
                # PoolExhausted: shared pages must sit at the FRONT of
                # the table, so prefill privately
                return 0
            pages = self._match_pages(tokens, limit)
            if self.host_tier is not None and any(p <= -2 for p in pages):
                mapped = self._match_and_map_tiered(seq_id, tokens, limit)
            else:
                for page in pages:
                    self._map_existing(page, seq_id)
                mapped = len(pages)
            if not mapped:
                self.prefix_misses += 1
                return 0
            cached = mapped * self.page_size
            self.prefix_hits += 1
            self.prefix_hit_tokens += cached
            self._registered_upto[seq_id] = cached
        return cached

    def _match_and_map_tiered(self, seq_id, tokens, limit=None):
        """match_and_map's path when the matched chain crosses host
        markers: walk the index LIVE block by block (resurrection re-keys
        nodes, and allocation pressure may evict or spill under us, so a
        precomputed match would go stale), mapping device pages and
        fetching each run of markers back in one transfer. Lock held by
        the caller. Returns full blocks mapped."""
        ps = self.page_size
        n = len(tokens) if limit is None else min(len(tokens),
                                                  max(int(limit), 0))
        blocks = n // ps

        def _block(j):
            return tuple(tokens[j * ps:(j + 1) * ps])

        parent, mapped, i = -1, 0, 0
        while i < blocks:
            ref = self._index.get((parent, _block(i)))
            if ref is None:
                break
            if ref <= -2:
                run, cur, j = [ref], ref, i + 1
                while j < blocks:
                    nxt = self._index.get((cur, _block(j)))
                    if nxt is None or nxt > -2:
                        break
                    run.append(nxt)
                    cur = nxt
                    j += 1
                devs = self._resurrect_locked(run, seq_id)
                mapped += len(devs)
                i += len(devs)
                if len(devs) < len(run):
                    return mapped       # the pool ran out mid-chain: the
                                        # prefix covered so far stands
                parent = devs[-1] if devs else parent
            else:
                self._map_existing(ref, seq_id)
                mapped += 1
                i += 1
                parent = ref
        return mapped

    def register_prefix(self, seq_id, tokens, written, owner=None):
        """Index seq_id's newly completed full pages (the first `written`
        tokens of `tokens` have K/V resident). A block already indexed
        elsewhere is NOT re-registered — the chain advances through the
        canonical page — and the walk restarts at the root every call,
        so a chain broken by eviction self-heals from this sequence's own
        pages. `owner` (a tenant id) tags newly indexed pages for
        weighted eviction; re-registration never re-tags."""
        if not self.prefix_cache:
            return
        ps = self.page_size
        with self._lock:
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
                    if owner is not None:
                        self._page_tenant[page] = str(owner)
                    self._digest_cache = None
                    if parent != -1:
                        self._children.setdefault(parent, set()).add(page)
                parent = page
            self._registered_upto[seq_id] = blocks * ps

    def prefix_chain_hashes(self, limit=4096):
        """The chain hash (chain_hash above) of every chain in the prefix
        index, at most `limit` of them: the affinity digest a replica
        publishes, so the cluster router can send a prompt to the
        replica that holds its prefix pages. A hash is present exactly
        when its token chain would prefix-hit here (match_and_map walks
        the same links). Memoized until the index gains or loses a
        chain: a replica's status call reads it on every router
        refresh, and re-hashing the index under the pool lock would
        stall the allocator."""
        if not self.prefix_cache:
            return []
        out = []
        with self._lock:
            memo = self._digest_cache
            if memo is not None and memo[0] == limit:
                return list(memo[1])
            stack = [(-1, key, page) for key, page in self._index.items()
                     if key[0] == -1]
            while stack and len(out) < int(limit):
                parent_hash, key, page = stack.pop()
                h = chain_hash(parent_hash, key[1])
                out.append(h)
                for child in self._children.get(page, ()):
                    ckey = self._page_key.get(child)
                    if ckey is not None:
                        stack.append((h, ckey, child))
            self._digest_cache = (limit, list(out))
        return out

    def census(self):
        """{seq_id: pages held} — who sits on the pool right now (the
        watchdog's serve_report names the page holders)."""
        with self._lock:
            return {seq: len(pages)
                    for seq, pages in self._seq_pages.items()}

    def stats(self):
        s = {
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
            'weighted_eviction': self._evict_weights is not None,
        }
        if self.host_tier is not None:
            s.update(self.host_tier.stats())
            s['tier_resurrected_pages_total'] = self.host_resurrect_pages
            s['tier_resurrected_tokens_total'] = \
                self.host_resurrect_tokens
            s['tier_spill_inflight_pages'] = len(self._spilling)
        return s
