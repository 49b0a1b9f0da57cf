"""Distributed sparse embedding — the host-side parameter-server coupling;
the port's copy of `paddle_tpu/distributed/ps/embedding.py`.

Reference parity: operators/pscore distributed_lookup_table + push_sparse
bridging the graph to the PS (N32), over CommonSparseTable (N30). The
unbounded sparse table lives in HOST memory (csrc/sparse_table.cc, or a
PsServer's copy of it); each forward pulls the batch's rows into one
buffer, which goes to the layer's device through pinned memory, and the
row gradients come back through autograd into a push.

Two layers a device: ids, pulls and pushes live on the host; rows and
their gradients live on the layer's device (the card unless asked).

The push rides a `torch.autograd.Function` whose backward runs on
autograd's device thread. The Function's only input that needs a
gradient is the layer's zero-size anchor, so its backward always fires
when the loss's graph reaches the rows, and returns no gradient for it.

  * sync (and geo) mode: the backward reads the row gradients back and
    pushes them before it returns, so a push lands before the next
    forward's pull.
  * async mode (`a_sync=True`): the backward copies the row gradients
    into a pinned host buffer behind an event on its stream and hands
    both to the global AsyncCommunicator, whose thread waits on the
    event and pushes; backward never waits on the table. `flush()` is
    the barrier.
  * geo mode: a GeoCommunicator trains a local mirror and ships weight
    deltas to the base table every `geo_k` pushes.
"""
import queue as _queue
import threading

import numpy as np
import torch
from torch import nn

from ...core.native import NativeSparseTable
from ...device import resolve_device

__all__ = ['AsyncCommunicator', 'DistributedEmbedding', 'GeoCommunicator',
           'global_communicator']


def _host_rows(grads):
    """A push's gradient rows as a host float32 array."""
    if isinstance(grads, torch.Tensor):
        return grads.detach().to('cpu', torch.float32).numpy()
    return grads


class AsyncCommunicator:
    """Parity: distributed C++ Communicator:197 — background send queue for
    async sparse-grad push (a_sync mode). A push may carry a CUDA event:
    the send thread waits on it before it reads the gradient. An error of
    a push is raised by the next `send` or `flush`."""

    def __init__(self, send_queue_size=16):
        self._q = _queue.Queue(maxsize=send_queue_size)
        self._running = False
        self._thread = None
        self._err = None

    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            table, ids, grads, lr, event = item
            try:
                if event is not None:
                    event.synchronize()
                table.push(ids, _host_rows(grads), lr)
            except Exception as e:       # noqa: BLE001 — raised by flush
                self._err = e
            finally:
                self._q.task_done()

    def _raise(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def send(self, table, ids, grads, lr, event=None):
        self._raise()
        if not self._running:
            if event is not None:
                event.synchronize()
            table.push(ids, _host_rows(grads), lr)
            return
        self._q.put((table, ids, grads, lr, event))

    def flush(self):
        if self._running:
            self._q.join()
        self._raise()

    def stop(self):
        if self._running:
            self._q.put(None)
            self._running = False
            if self._thread is not None:
                self._thread.join()
                self._thread = None
        self._raise()


_global_communicator = AsyncCommunicator()


def global_communicator():
    return _global_communicator


class GeoCommunicator:
    """Geo-SGD async mode (parity: SparseGeoTable +
    service/communicator.h GeoCommunicator): the worker trains a LOCAL
    native mirror at full speed; every k steps the accumulated WEIGHT
    DELTAS (not gradients) push to the server, which sums deltas from all
    workers, and fresh rows pull back into the mirror. The server table
    must use the 'sgd' accessor (delta applied via lr=-1 — the reference's
    geo SUM-table semantics).
    """

    def __init__(self, remote_table, dim, k_steps=10):
        self.remote = remote_table
        self.dim = dim
        self.k = max(1, int(k_steps))
        self.local = NativeSparseTable(dim, optimizer='sgd')
        self.base = {}          # id -> row at last sync
        self.touched = set()
        self._step = 0

    def _ensure(self, flat):
        """Materialize server rows for any not-yet-mirrored ids
        (O(batch): membership tests against the base dict)."""
        unseen = sorted({int(i) for i in flat} - self.base.keys())
        if unseen:
            unseen = np.asarray(unseen, np.int64)
            rows = self.remote.pull(unseen)
            self.local.set(unseen, rows)
            for j, i in enumerate(unseen):
                self.base[int(i)] = rows[j].copy()

    def pull(self, ids):
        flat = np.ascontiguousarray(ids, np.int64).reshape(-1)
        self._ensure(flat)
        return self.local.pull(flat)

    def push(self, ids, grads, lr):
        flat = np.ascontiguousarray(ids, np.int64).reshape(-1)
        self._ensure(flat)   # push without prior pull still needs a base
        self.local.push(flat, grads, lr)
        self.touched.update(int(i) for i in flat)
        self._step += 1
        if self._step % self.k == 0:
            self.sync()

    def sync(self):
        if not self.touched:
            return
        ids = np.array(sorted(self.touched), np.int64)
        delta = self.local.pull(ids) - np.stack(
            [self.base[int(i)] for i in ids])
        self.remote.push(ids, delta, -1.0)   # server: w += delta
        fresh = self.remote.pull(ids)
        self.local.set(ids, fresh)
        for j, i in enumerate(ids):
            self.base[int(i)] = fresh[j].copy()
        self.touched.clear()

    def save(self, path):
        self.sync()
        self.remote.save(path)

    def load(self, path):
        """Reload the base table and invalidate the mirror (rows re-pull
        lazily on next touch)."""
        self.remote.load(path)
        self.local = NativeSparseTable(self.dim, optimizer='sgd')
        self.base.clear()
        self.touched.clear()
        self._step = 0

    def __len__(self):
        return len(self.remote)


class _RemoteTable:
    """PsClient adapter with the NativeSparseTable surface."""

    def __init__(self, client, table_id, dim):
        self.client = client
        self.table_id = table_id
        self.dim = dim

    def pull(self, ids):
        return self.client.pull(self.table_id, ids, self.dim)

    def push(self, ids, grads, lr):
        self.client.push(self.table_id, ids, grads, lr)

    def save(self, path):
        self.client.save(self.table_id, path)

    def load(self, path):
        raise NotImplementedError("load via the server side")

    def __len__(self):
        return self.client.table_size(self.table_id)


class _Lookup(torch.autograd.Function):
    """The pulled rows as a function of the layer's anchor: forward pulls
    and uploads, backward pushes the row gradients and returns none."""

    @staticmethod
    def forward(ctx, anchor, layer, flat, shape):
        ctx.layer, ctx.flat = layer, flat
        return layer._pull(flat, shape)

    @staticmethod
    def backward(ctx, grad):
        ctx.layer._push(ctx.flat, grad)
        return None, None, None, None


class DistributedEmbedding(nn.Module):
    """Sparse embedding backed by the host PS table.

    Forward pulls rows for the batch ids (a host int tensor or array; a
    tensor on the card is read back) and returns them on the layer's
    device; backward routes the row gradients into a push (sync, async
    through the global communicator, or geo). The table is unbounded —
    features materialize on first touch (reference accessor semantics)."""

    def __init__(self, embedding_dim, optimizer='adagrad', learning_rate=0.01,
                 init_range=0.05, num_shards=16, seed=0, a_sync=False,
                 endpoints=None, table_id=0, mode=None, geo_k=10, name=None,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.embedding_dim = embedding_dim
        if mode is None:
            mode = 'async' if a_sync else 'sync'
        if mode not in ('sync', 'async', 'geo'):
            raise ValueError(f"bad PS mode {mode!r}")
        if endpoints:
            # remote PS mode (parity: distributed_lookup_table →
            # BrpcPsClient): pull/push go to the server fleet
            from .service import PsClient
            self.table = _RemoteTable(PsClient(endpoints), table_id,
                                      embedding_dim)
        else:
            # geo deltas apply to the base table via sgd/lr=-1; the
            # accessor there must be 'sgd' (server-side: configure the
            # server's table with optimizer='sgd' for geo workers)
            self.table = NativeSparseTable(
                embedding_dim, num_shards=num_shards,
                optimizer='sgd' if mode == 'geo' else optimizer,
                init_range=init_range, seed=seed)
        if mode == 'geo':
            self.table = GeoCommunicator(self.table, embedding_dim,
                                         k_steps=geo_k)
        self.learning_rate = learning_rate
        self.mode = mode
        self.a_sync = mode == 'async'
        # not a parameter: the optimizer never sees it, the bridge never
        # names it; it only makes the lookup's backward run
        self._anchor = torch.empty(0, requires_grad=True)
        if self.a_sync:
            _global_communicator.start()

    def _pull(self, flat, shape):
        rows = torch.from_numpy(self.table.pull(flat)).reshape(
            shape + (self.embedding_dim,))
        if self.device.type == 'cuda':
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        return rows

    def _push(self, flat, grad):
        grad = grad.detach().reshape(-1, self.embedding_dim)
        lr = self.learning_rate
        if not self.a_sync:
            self.table.push(flat, _host_rows(grad), lr)
            return
        if grad.is_cuda:
            host = torch.empty(grad.shape, dtype=torch.float32,
                               pin_memory=True)
            host.copy_(grad, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = grad.to(torch.float32, copy=True), None
        _global_communicator.send(self.table, flat, host, lr, event)

    def forward(self, ids):
        """ids: int [...] (host tensor or array); returns [..., dim] float32
        on the layer's device."""
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        ids_np = np.asarray(ids).astype(np.int64)
        flat = ids_np.reshape(-1)
        if torch.is_grad_enabled():
            return _Lookup.apply(self._anchor, self, flat, ids_np.shape)
        return self._pull(flat, ids_np.shape)

    def flush(self):
        _global_communicator.flush()

    def save(self, path):
        self.table.save(path)

    def load(self, path):
        self.table.load(path)

    def __len__(self):
        return len(self.table)
