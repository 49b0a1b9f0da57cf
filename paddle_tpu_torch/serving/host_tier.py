"""Host-RAM tier under the paged KV pool — counterpart of
`paddle_tpu/serving/host_tier.py`.

Host buffers that hold KV pages spilled out of the device pool: one per
layer tensor, shaped like the pool's but with `host_pages` rows, so a
spilled page lands in the host row its slot names and a fetch writes it
back into whichever device page the pool hands out. Int8 pools need no
special case: each layer's tensor TUPLE is mirrored element-wise, so the
fp32 scales travel with their int8 pages bit for bit (rows move as
stored; nothing re-quantizes).

The contract (the reference module's):

  * slots are allocated and freed exactly once;
  * spilled device pages stay pinned outside the pool's free and cached
    sets until their job lands and its callback returns them;
  * the in-flight window is bounded (`window` jobs): a producer that
    outruns the drain blocks on a semaphore;
  * a fetch first waits out any in-flight spill of its slots.

On a CUDA pool the host buffers are pinned (`pin_memory=True`; a failed
pinned allocation raises — there is no pageable route), allocated at the
first spill. A SPILL gathers the pages on a dedicated copy stream that
first waits on the compute stream (the pages were written there), copies
the gathered rows device-to-host with `non_blocking` — straight into the
host buffer's rows when the job's slots are consecutive, else into a
pinned staging tensor — and records a CUDA event. The gather's device
memory is allocated on the copy stream, so the caching allocator keeps it
out of other streams' hands, and the job holds the staging tensor until
its event completes. The transfer thread waits on that event — it
launches nothing — copies staged rows into their slots and then runs the
callback that unpins the device pages. A FETCH uploads the host rows
`non_blocking` on the compute stream (from the buffer's own rows when the
slots are consecutive, else from a pinned staging tensor gathered on the
host) and `index_copy_`s them into the pool there, so the next forward is
ordered after it with no host sync. PyTorch's caching host allocator
records the upload's stream event on the pinned block and does not hand
a staging tensor out again before that event completes; a freed slot's
rows are only rewritten by a later spill, whose copy stream first waits
on the compute stream that ran the upload. (`host[idx]` would give
pageable memory, and a "non-blocking" copy from pageable memory is
synchronous — every host tensor here that meets the card is pinned.)

On a CPU pool (the tests) the same code runs with plain tensors and
synchronous copies.
"""
import queue
import threading
import time

import torch

from ..core import monitor as _m


def _chunk_spans(n, chunk):
    """(start, width) spans of at most `chunk` pages over [0, n); one
    span when chunking is off (`chunk` 0) or n fits one chunk — the
    reference's `core.bucketing._chunk_spans` at one shard."""
    if not chunk or n <= chunk:
        return [(0, n)]
    return [(s, min(chunk, n - s)) for s in range(0, n, chunk)]


def _count_transfer(kind, pages, nbytes):
    if kind == 'spilled':
        _m.counter('ptpu_serve_tier_spilled_pages_total',
                   help='KV pages spilled device->host tier '
                        '(lifetime)').inc(pages)
        _m.counter('ptpu_serve_tier_spilled_bytes_total',
                   help='bytes spilled device->host tier, scale '
                        'buffers included (lifetime)').inc(nbytes)
    else:
        _m.counter('ptpu_serve_tier_fetched_pages_total',
                   help='KV pages fetched host->device tier '
                        '(lifetime)').inc(pages)
        _m.counter('ptpu_serve_tier_fetched_bytes_total',
                   help='bytes fetched host->device tier, scale '
                        'buffers included (lifetime)').inc(nbytes)


def _runs(pages, slots, spans):
    """Per span: the lowest slot when the span's slots are consecutive
    (ascending or descending), else None; and `pages` with each such
    span put in ascending-slot order. A span with consecutive slots moves
    straight between the card and host[lo:lo + width], without staging."""
    runs, ordered = [], []
    for st, w in spans:
        sl, seg = list(slots[st:st + w]), list(pages[st:st + w])
        lo = min(sl)
        if sl == list(range(lo, lo + w)):
            runs.append(lo)
        elif sl == list(range(lo + w - 1, lo - 1, -1)):
            runs.append(lo)
            seg.reverse()
        else:
            runs.append(None)
        ordered += seg
    return runs, ordered


def _index(values, device):
    """An int64 index tensor on `device`, uploaded from pinned memory
    without a host sync when the device is a card."""
    idx = torch.tensor(list(values), dtype=torch.int64)
    if device.type != 'cuda':
        return idx
    return idx.pin_memory().to(device, non_blocking=True)


class HostTier:
    """Slot allocator + host buffers + the transfer thread.

    `host_pages` is the tier's capacity in pages; the buffers are
    allocated at the first spill (mirroring the pool's layer shapes), so
    a tier that never spills costs no host memory and launches
    nothing."""

    def __init__(self, host_pages, chunk_pages=0, window=2):
        if host_pages <= 0:
            raise ValueError("host_pages must be positive")
        self.host_pages = int(host_pages)
        self.chunk_pages = int(chunk_pages)
        self.window = max(int(window), 1)
        self._free = list(range(self.host_pages - 1, -1, -1))
        self._buffers = None            # [layer][tensor] host tensors
        self._copy_stream = None
        self._landed = {}               # slot -> Event (in-flight spill)
        self._jobs = queue.Queue()
        self._slots_sem = threading.Semaphore(self.window)
        self._thread = None
        self._lock = threading.Lock()
        self.spilled_pages = 0
        self.spilled_bytes = 0
        self.fetched_pages = 0
        self.fetched_bytes = 0
        self.spill_jobs = 0
        self._wall_s = 0.0              # un-drained transfer wall — the
                                        # engine folds it into the
                                        # ledger's page_stream component

    # -- slots ---------------------------------------------------------------
    @property
    def used_slots(self):
        return self.host_pages - len(self._free)

    @property
    def free_slots(self):
        return len(self._free)

    def alloc_slots(self, n):
        """Take n host slots, or None when the tier lacks room (the pool
        then evicts on the card instead)."""
        with self._lock:
            if len(self._free) < n:
                return None
            return [self._free.pop() for _ in range(n)]

    def free_slot(self, slot):
        with self._lock:
            self._landed.pop(slot, None)
            self._free.append(slot)

    # -- buffers -------------------------------------------------------------
    def _ensure_buffers(self, kv):
        if self._buffers is not None:
            return
        self._buffers = [
            [torch.empty((self.host_pages,) + tuple(b.shape[1:]),
                         dtype=b.dtype, pin_memory=b.is_cuda)
             for b in layer]
            for layer in kv]

    @staticmethod
    def _page_bytes(buf):
        return buf[0].numel() * buf.element_size()

    def _stream_for(self, device):
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=device)
        return self._copy_stream

    # -- spill (device -> host) ----------------------------------------------
    def _stage(self, kv, device_pages, slots):
        """Gather the pages' rows off the pool into fresh tensors (chunk
        by chunk) — never views of live pages. On a card the gather and
        the device-to-host copy run on the copy stream behind the
        compute stream's writes, straight into the host buffer's rows
        when a chunk's slots are consecutive and into pinned staging
        otherwise; the returned event marks their end, and nothing here
        waits for it. Returns (chunks, spans, event): chunks[l][b] lists
        one (rows, landed) pair a span."""
        n = len(device_pages)
        spans = _chunk_spans(n, self.chunk_pages)
        dev = kv[0][0].device
        if dev.type != 'cuda':
            idx = _index(device_pages, dev)
            return [[[(b.index_select(0, idx[st:st + w]), False)
                      for st, w in spans] for b in layer] for layer in kv], \
                spans, None
        runs, ordered = _runs(device_pages, slots, spans)
        stream = self._stream_for(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            idx = _index(ordered, dev)
            staged = []
            for li, layer in enumerate(kv):
                bufs = []
                for bi, b in enumerate(layer):
                    chunks = []
                    for (st, w), s0 in zip(spans, runs):
                        if s0 is None:
                            dst = torch.empty((w,) + tuple(b.shape[1:]),
                                              dtype=b.dtype, pin_memory=True)
                        else:
                            dst = self._buffers[li][bi][s0:s0 + w]
                        dst.copy_(b.index_select(0, idx[st:st + w]),
                                  non_blocking=True)
                        chunks.append((dst, s0 is not None))
                    bufs.append(chunks)
                staged.append(bufs)
            event = torch.cuda.Event()
            event.record(stream)
        return staged, spans, event

    def _land(self, staged, spans, slots, event):
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        nbytes = 0
        for li, layer in enumerate(staged):
            for bi, chunks in enumerate(layer):
                host = self._buffers[li][bi]
                for (st, w), (rows, landed) in zip(spans, chunks):
                    if not landed:
                        host.index_copy_(0, torch.tensor(
                            slots[st:st + w], dtype=torch.int64), rows)
                nbytes += len(slots) * self._page_bytes(host)
        dt = time.perf_counter() - t0
        with self._lock:
            self.spilled_pages += len(slots)
            self.spilled_bytes += nbytes
            self.spill_jobs += 1
            self._wall_s += dt
            for s in slots:
                ev = self._landed.get(s)
                if ev is not None:
                    ev.set()
        _count_transfer('spilled', len(slots), nbytes)

    def _worker(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            staged, spans, slots, event, on_landed = job
            try:
                self._land(staged, spans, slots, event)
            finally:
                # release the window BEFORE the callback: the producer
                # may be blocked on the semaphore while holding the pool
                # lock (submit_spill runs under it), and on_landed needs
                # that same lock — callback-first would deadlock the pair
                self._slots_sem.release()
                if on_landed is not None:
                    on_landed()

    def _mark_inflight(self, slots):
        with self._lock:
            for s in slots:
                self._landed[s] = threading.Event()

    def submit_spill(self, kv, device_pages, slots, on_landed=None):
        """Queue an async spill of `device_pages` into host `slots`.
        Blocks only when `window` jobs are already in flight. `on_landed`
        runs on the transfer thread after the rows are in the host
        buffers — the pool uses it to unpin the device pages."""
        self._ensure_buffers(kv)
        self._mark_inflight(slots)
        self._slots_sem.acquire()
        staged, spans, event = self._stage(kv, device_pages, slots)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name='kvtier-spill', daemon=True)
            self._thread.start()
        self._jobs.put((staged, spans, slots, event, on_landed))

    def spill_sync(self, kv, device_pages, slots):
        """Inline spill — the exhaustion fallback when the pool needs a
        free page now. The same staging and landing, on the caller's
        thread."""
        self._ensure_buffers(kv)
        self._mark_inflight(slots)
        staged, spans, event = self._stage(kv, device_pages, slots)
        self._land(staged, spans, slots, event)

    def wait_landed(self, slots):
        """Block until every slot's in-flight spill (if any) has landed
        — a resurrect racing a spill reads landed rows."""
        for s in list(slots):
            with self._lock:
                ev = self._landed.get(s)
            if ev is not None:
                ev.wait()

    # -- fetch (host -> device) ----------------------------------------------
    def fetch(self, kv, slots, device_pages):
        """Write host rows `slots[i]` into device pages `device_pages[i]`
        of every layer tensor, in place, after waiting out in-flight
        spills of those slots. On a card the upload and the scatter are
        queued on the compute stream and nothing waits for them. Returns
        `kv`."""
        self.wait_landed(slots)
        n = len(slots)
        dev = kv[0][0].device
        pinned = dev.type == 'cuda'
        src_idx = torch.tensor(list(slots), dtype=torch.int64)
        spans = _chunk_spans(n, self.chunk_pages)
        if pinned:
            runs, ordered = _runs(device_pages, slots, spans)
        else:
            runs, ordered = [None] * len(spans), device_pages
        dst_idx = _index(ordered, dev)
        t0 = time.perf_counter()
        nbytes = 0
        for li, layer in enumerate(kv):
            for bi, d in enumerate(layer):
                host = self._buffers[li][bi]
                for (st, w), s0 in zip(spans, runs):
                    if s0 is not None:      # consecutive slots: a view of
                        rows = host[s0:s0 + w]          # the pinned buffer
                    else:
                        rows = torch.empty((w,) + tuple(host.shape[1:]),
                                           dtype=host.dtype,
                                           pin_memory=pinned)
                        torch.index_select(host, 0, src_idx[st:st + w],
                                           out=rows)
                    d.index_copy_(0, dst_idx[st:st + w],
                                  rows.to(dev, non_blocking=pinned))
                nbytes += n * self._page_bytes(host)
        dt = time.perf_counter() - t0
        with self._lock:
            self.fetched_pages += n
            self.fetched_bytes += nbytes
            self._wall_s += dt
        _count_transfer('fetched', n, nbytes)
        return kv

    # -- accounting ----------------------------------------------------------
    def take_wall(self):
        """Pop the accumulated transfer wall (spill + fetch seconds) —
        the engine adds it to the ledger's page_stream component once a
        step."""
        with self._lock:
            w, self._wall_s = self._wall_s, 0.0
        return w

    def drain(self):
        """Block until every queued spill has landed (tests, shutdown)."""
        with self._lock:
            pending = [ev for ev in self._landed.values()
                       if not ev.is_set()]
        for ev in pending:
            ev.wait()

    def stats(self):
        with self._lock:
            return {
                'tier_host_pages': self.host_pages,
                'tier_host_used_pages': self.used_slots,
                'tier_spilled_pages_total': self.spilled_pages,
                'tier_spilled_bytes_total': self.spilled_bytes,
                'tier_fetched_pages_total': self.fetched_pages,
                'tier_fetched_bytes_total': self.fetched_bytes,
                'tier_spill_jobs_total': self.spill_jobs,
            }

    def shutdown(self):
        self.drain()
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join(timeout=5)
            self._thread = None
        self._buffers = None
