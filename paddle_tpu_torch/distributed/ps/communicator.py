"""Async PS communicator: trainer compute decoupled from PS RPCs — the
port's copy of `paddle_tpu/distributed/ps/communicator.py`.

Reference parity: fluid/distributed/service/communicator.h:197
(AsyncCommunicator: background send/recv threads and bounded queues, so
the trainer never blocks on the wire) and communicator.cc's batch-merged
push. The communicator pairs

  * a pull prefetcher: `pull_ahead(feed)` walks the id stream in a worker
    thread and keeps up to `depth` pulled (and, with `device_put`,
    uploaded) embedding batches ready, and
  * a push drainer: `push_async(ids, grads, lr)` queues the gradient, a
    tensor on the card included; the worker reads it back and sends it,
    so the card never waits for the wire, and the read-back of step t
    overlaps the compute of step t+1.

Streams, for tensors on the card:

  * `push_async` records an event on the caller's current stream behind
    the gradient and keeps a reference to it; the push thread's copy
    stream waits on that event before the read-back. The caller must not
    write into the tensor after handing it over (the reference's arrays
    are immutable).
  * `device_put` runs in the prefetch thread on a copy stream of the
    communicator's own (a pinned source and `non_blocking=True` let the
    upload of batch t+1 overlap step t), and an event is recorded behind
    it; the consumer's stream waits on that event before the batch is
    handed out, and each tensor of the batch is marked `record_stream` on
    the consumer's stream (the pattern of `io/device_loader.py`).

Staleness contract, as the reference's async mode: a pull issued at step
t+depth may miss pushes still queued from steps < t; `flush()` is the
communicator's barrier (reference Communicator::Clean and the sync-mode
fences).
"""
import queue
import threading
import time

import numpy as np
import torch

from .service import host_array

__all__ = ['AsyncCommunicator']


class _Stop:
    pass


def _tensors(x):
    """The tensors on the card among x (one value, a tuple or a list)."""
    items = x if isinstance(x, (tuple, list)) else (x,)
    return [t for t in items if isinstance(t, torch.Tensor) and t.is_cuda]


class AsyncCommunicator:
    def __init__(self, client, table_id, dim, depth=2, device_put=None):
        """client: a PsClient (thread-safe), or anything with its pull and
        push. depth: the most pulled batches and unsent pushes in flight.
        device_put: an optional fn(np_rows) -> tensor run inside the
        prefetch thread, so the upload of batch t+1 overlaps the compute
        of batch t."""
        self.client = client
        self.table_id = int(table_id)
        self.dim = int(dim)
        self.depth = int(depth)
        self._device_put = device_put
        self._copy_stream = None          # the prefetch thread's uploads
        self._push_q = queue.Queue(self.depth)
        self._push_err = None
        self._push_thread = threading.Thread(target=self._push_loop,
                                             daemon=True)
        self._push_thread.start()
        self._pull_thread = None
        self._cur_pull = None     # (stop event, thread, queue) of the active
                                  # pull: cancellation is per generation, so
                                  # a stale abandoned iterator cannot kill a
                                  # newer pull

    # -- pull side ------------------------------------------------------------
    def _upload(self, rows):
        """device_put(rows) and the event behind it (None off the card)."""
        if not torch.cuda.is_available():
            return self._device_put(rows), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream()
        with torch.cuda.stream(self._copy_stream):
            out = self._device_put(rows)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return out, event

    @staticmethod
    def _hand_over(rows, event):
        if event is not None:
            for t in _tensors(rows):
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(event)
                t.record_stream(stream)
        return rows

    def pull_ahead(self, id_batches):
        """Start prefetching: `id_batches` is an iterable of int64 id
        arrays. Returns an iterator of (ids, rows) in order, at most
        `depth` batches ahead of the consumer."""
        if self._pull_thread is not None:
            raise RuntimeError('pull_ahead already active; exhaust, '
                               'close() or cancel_pull() the previous '
                               'iterator first')
        out = queue.Queue(self.depth)     # per pull: never shared across
        stop = threading.Event()          # generations

        def _put(item):
            """Bounded put that gives up when the consumer cancelled: an
            abandoned iterator must not wedge this thread on a full
            queue."""
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def loop():
            try:
                for ids in id_batches:
                    if stop.is_set():
                        return
                    # the shape is the client's contract (PsClient.pull
                    # flattens; a chunk adapter may keep [K, rows])
                    ids = host_array(ids, np.int64)
                    rows = self.client.pull(self.table_id, ids, self.dim)
                    event = None
                    if self._device_put is not None:
                        rows, event = self._upload(rows)
                    if not _put((ids, rows, event)):
                        return
            except Exception as e:           # surfaced at the consumer
                _put(e)
            finally:
                _put(_Stop)

        t = threading.Thread(target=loop, daemon=True)
        self._pull_thread = t
        self._cur_pull = (stop, t, out)
        t.start()

        def results():
            try:
                while True:
                    item = out.get()
                    if item is _Stop:
                        return
                    if isinstance(item, Exception):
                        raise item
                    ids, rows, event = item
                    yield ids, self._hand_over(rows, event)
            finally:
                # normal exhaustion, an error, or an abandoned iterator
                # (GeneratorExit lands here) all release this pull's
                # producer; a newer generation is untouched
                self._cancel_generation(stop, t, out)

        return results()

    def _cancel_generation(self, stop, t, out):
        """Stop one pull generation's producer and release its slot (only if
        it still owns the slot). Idempotent. Bounded wait: a producer stuck
        in an in-flight client.pull() (dead server, partition) cannot be
        interrupted; after the deadline the daemon thread is abandoned (it
        checks `stop` again before any further put)."""
        stop.set()
        deadline = time.time() + 10.0
        while t.is_alive() and time.time() < deadline:
            try:                     # unblock a producer stuck on put()
                out.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        if self._pull_thread is t:
            self._pull_thread = None
            self._cur_pull = None

    def cancel_pull(self):
        """Cancel the active pull_ahead (if any) so a new one can start.
        Idempotent."""
        cur = self._cur_pull
        if cur is not None:
            self._cancel_generation(*cur)

    # -- push side ------------------------------------------------------------
    def push_async(self, ids, grads, lr):
        """Queue a gradient push and return at once. `grads` (and `ids`) may
        be tensors on the card: the push thread reads them back after the
        work queued before this call on the caller's stream. Raises any
        error of an earlier push (at most depth pushes late, never
        silent)."""
        if self._push_err is not None:
            err, self._push_err = self._push_err, None
            raise err
        event = None
        on_card = _tensors([ids, grads])
        if on_card:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(on_card[0].device))
        self._push_q.put((ids, grads, float(lr), event))

    def _push_loop(self):
        copy_stream = None
        while True:
            item = self._push_q.get()
            if item is _Stop:
                return
            ids, grads, lr, event = item
            try:
                if event is not None:
                    if copy_stream is None:
                        copy_stream = torch.cuda.Stream(
                            _tensors([ids, grads])[0].device)
                    copy_stream.wait_event(event)
                    with torch.cuda.stream(copy_stream):
                        ids = host_array(ids, np.int64)
                        grads = host_array(grads, np.float32)
                else:
                    ids = host_array(ids, np.int64)
                    grads = host_array(grads, np.float32)
                self.client.push(self.table_id, ids, grads, lr)
            except Exception as e:           # noqa: BLE001
                self._push_err = e
                try:
                    from ..fleet.utils import log_util
                    log_util.log_json(
                        'ps_push_failed', level='error',
                        logger_name='ps', table=self.table_id,
                        rows=int(np.size(ids)) if isinstance(
                            ids, np.ndarray) else None, error=repr(e))
                except Exception:            # noqa: BLE001 — logging only
                    pass
            finally:
                self._push_q.task_done()

    def flush(self):
        """Barrier: wait until every queued push has landed on the servers
        (the reference's sync-mode fence). Re-raises a push error."""
        self._push_q.join()
        if self._push_err is not None:
            err, self._push_err = self._push_err, None
            raise err

    def stop(self):
        """Graceful close: cancel any in-flight prefetch, fence the queued
        pushes (re-raising a queued push error after the threads are
        released, so an error cannot leave the communicator wedged)."""
        self.cancel_pull()
        err = None
        try:
            self.flush()
        except Exception as e:       # noqa: BLE001 — re-raised below
            err = e
        self._push_q.put(_Stop)
        self._push_thread.join(timeout=10)
        if err is not None:
            raise err

    close = stop

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.stop()
        return False
