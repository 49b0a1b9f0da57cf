"""DeviceLoader — counterpart of `paddle_tpu/io/device_loader.py`:
background-thread input prefetch onto the card.

Wraps any iterable of host batches. A staging thread copies each batch
into a reusable ring of depth+1 pinned host buffers and queues its
host-to-device copy, `non_blocking=True`, on a copy stream of its own,
recording an event behind it. So batch t+1's transfer overlaps step t's
compute, and the training loop never pays the transfer in the host gap
between dispatches (the companion of the engines' windowed dispatch,
core/async_step.py).

Stream safety, in the caching allocator's terms:

  * the consumer's stream waits on a batch's event before the batch is
    handed out, so no kernel reads it before its copy landed;
  * each device tensor of the batch is marked `record_stream` on the
    consumer's stream: it was allocated on the copy stream, and without
    the mark the allocator could hand its memory to the next copy while
    a step still reads it;
  * a ring slot's pinned buffers are overwritten only after the event of
    the copy that read them has completed (free in steady state, depth+1
    batches later; it waits on the staging thread, never the loop).

On the CPU the ring holds plain buffers and each batch is copied out of
its slot, so a later wrap of the ring never changes a batch already
handed out. The engine passed as `engine=` names the device (its
`.device`); otherwise `device=`, the card by default.

Gauges: ptpu_host_prefetch_depth, ptpu_host_prefetch_stalls_total (the
consumer arrived before a batch was staged) and
ptpu_host_prefetch_h2d_bytes_total; `stats()` carries the same counters
and the ring reuse count, as the reference's.
"""
import queue as _queue
import threading
import time

import numpy as np
import torch

from ..core import async_step as _async
from ..device import resolve_device


class DeviceLoader:
    """Iterate device-resident batches prefetched from `loader`.

    Each yielded item is a tuple of tensors on the device (a non-tuple
    upstream batch yields a 1-tuple). Re-iterable: every `__iter__`
    starts a fresh staging thread over `iter(loader)`. `close()` stops
    an in-flight one.
    """

    def __init__(self, loader, engine=None, device=None, depth=None):
        self.loader = loader
        self.engine = engine
        if engine is not None and getattr(engine, 'device', None) is not None:
            self.device = torch.device(engine.device)
        else:
            self.device = resolve_device(device)
        self._cuda = self.device.type == 'cuda'
        if self._cuda and self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        self.depth = _async.resolve_prefetch_depth(depth)
        self._ring = [None] * (self.depth + 1)   # slot -> [host buffers]
        self._ring_pending = [None] * (self.depth + 1)  # slot -> event
        self._ring_i = 0
        self._copy_stream = None
        self._stop = threading.Event()   # the CURRENT iteration's event
        self._producer = None            # the CURRENT staging thread
        self._stats = {'batches': 0, 'stalls': 0, 'h2d_bytes': 0,
                       'ring_reuses': 0}
        self._publish_depth()
        _async.note_prefetch(loaders=1, depth=self.depth)

    # -- staging + transfer ---------------------------------------------------
    @staticmethod
    def _host_arrays(batch):
        items = batch if isinstance(batch, (tuple, list)) else (batch,)
        out = []
        for b in items:
            if not isinstance(b, torch.Tensor):
                b = torch.from_numpy(np.ascontiguousarray(np.asarray(b)))
            out.append(b.detach().cpu())
        return out

    def _stage(self, arrays):
        """Copy the batch into this slot's reusable staging buffers
        (allocated on first use or a shape change only), after the
        slot's previous copy to the card has completed."""
        i = self._ring_i
        pending = self._ring_pending[i]
        if pending is not None:
            self._ring_pending[i] = None
            pending.synchronize()
        slot = self._ring[i]
        if slot is None or len(slot) != len(arrays) or any(
                buf.shape != a.shape or buf.dtype != a.dtype
                for buf, a in zip(slot, arrays)):
            slot = [torch.empty(a.shape, dtype=a.dtype,
                                pin_memory=self._cuda) for a in arrays]
            self._ring[i] = slot
        else:
            self._stats['ring_reuses'] += 1
            _async.note_prefetch(ring_reuses=1)
        for buf, a in zip(slot, arrays):
            buf.copy_(a)
        self._ring_i = (i + 1) % len(self._ring)
        return slot, i

    def _transfer(self, staged, slot_idx=None):
        """(device tensors, the copy's event or None). On the card the
        copies are queued on the copy stream; on the CPU each batch is
        copied out of the ring."""
        nbytes = sum(buf.numel() * buf.element_size() for buf in staged)
        event = None
        # This runs on the staging thread. A tuple is built from a list,
        # never from a generator: CPython resizes the tuple it builds
        # from a generator in place, and raises SystemError when another
        # reference to it exists, as a memory census's gc.get_objects()
        # on the main thread holds one (core/memory.py `_live_tensors`)
        if self._cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                out = tuple([buf.to(self.device, non_blocking=True)
                             for buf in staged])
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            if slot_idx is not None:
                self._ring_pending[slot_idx] = event
        else:
            out = tuple([buf.clone() for buf in staged])
        self._stats['h2d_bytes'] += nbytes
        self._stats['batches'] += 1
        _async.note_prefetch(batches=1, h2d_bytes=nbytes)
        self._h2d_counter().inc(nbytes)
        return out, event

    def _hand_over(self, item):
        """The batch for the consumer's stream: wait on its copy and mark
        its tensors in use there."""
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    # -- iteration ------------------------------------------------------------
    def __iter__(self):
        # one stop event PER iteration: a new iteration (or close())
        # signals the previous staging thread and joins it, so two never
        # share the ring
        self._stop.set()
        prev = self._producer
        if prev is not None and prev.is_alive():
            prev.join(timeout=5)
        stop = self._stop = threading.Event()
        q = _queue.Queue(maxsize=self.depth)
        sentinel = object()
        err = []

        def put_stop_aware(item):
            """A put with a timeout, so a staging thread blocked on a
            full queue still notices the stop signal."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except _queue.Full:
                    continue

        def producer():
            try:
                if self._cuda:
                    torch.cuda.set_device(self.device.index)
                for batch in self.loader:
                    if stop.is_set():
                        return
                    staged, slot_idx = self._stage(self._host_arrays(batch))
                    put_stop_aware(self._transfer(staged, slot_idx))
            except Exception as e:          # surfaced on the consumer side
                err.append(e)
            finally:
                put_stop_aware(sentinel)
        t = self._producer = threading.Thread(
            target=producer, daemon=True, name='ptpu-device-prefetch')
        t.start()
        stall_counter = self._stall_counter()
        first_get = True
        try:
            while True:
                # the first get of an iteration always finds an empty
                # queue: startup latency, not a prefetch stall
                stalled = q.empty() and t.is_alive() and not first_get
                first_get = False
                t0 = time.perf_counter()
                while True:
                    try:
                        item = q.get(timeout=0.2)
                        break
                    except _queue.Empty:
                        if stop.is_set() or not t.is_alive():
                            item = sentinel
                            break
                # the queue wait is a transfer in flight on the staging
                # thread: blocked time for the next dispatch, not host gap
                _async.note_external_blocked(time.perf_counter() - t0)
                if item is sentinel:
                    break
                if stalled:
                    self._stats['stalls'] += 1
                    _async.note_prefetch(stalls=1)
                    stall_counter.inc(1)
                yield self._hand_over(item)
            if err:
                raise err[0]
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            t.join(timeout=5)

    def __len__(self):
        return len(self.loader)

    def close(self):
        self._stop.set()

    def stats(self):
        return dict(self._stats, depth=self.depth)

    # -- metrics --------------------------------------------------------------
    def _publish_depth(self):
        from ..core.monitor import gauge
        gauge('ptpu_host_prefetch_depth',
              help='DeviceLoader prefetch ring depth').set(self.depth)

    @staticmethod
    def _stall_counter():
        from ..core.monitor import counter
        return counter('ptpu_host_prefetch_stalls_total',
                       help='consumer waits on an empty prefetch queue')

    @staticmethod
    def _h2d_counter():
        from ..core.monitor import counter
        return counter('ptpu_host_prefetch_h2d_bytes_total',
                       help='bytes staged host-to-device by DeviceLoader')
