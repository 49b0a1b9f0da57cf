"""Parameter-server service: remote pull/push over TCP — the port's copy of
`paddle_tpu/distributed/ps/service.py`, on the same wire byte for byte, so
a client of either package talks to a server of the other.

Reference parity: paddle/fluid/distributed/service — BrpcPsServer /
BrpcPsClient and the PsService RPC surface. The table math stays in host
C++ (`core/native.py`, csrc/sparse_table.cc) on the server, and rows stay
host numpy on the wire: the card enters only at the communicator and in
the caller's dense step. Workers shard feature ids across servers by the
hash `_shard` gives, the same in both packages.

Wire protocol (little-endian):
  u8 op ('P' pull, 'U' push, 'S' save, 'L' load, 'N' size, 'K' shrink,
         'Q' shutdown, 'H' heartbeat, 'd' dense pull, 'e' dense push,
         'I' dense set)
  u32 table_id ('H' and 'Q' have none)
  P: u32 n, u32 dim, i64[n] ids         -> u8 ok, f32[n*dim] rows
  U: 16s client_uuid, u64 seq, u32 n, u32 dim, f32 lr, i64[n] ids,
     f32[n*dim] grads                   -> u8 ok
  S/L: u32 len, path bytes              -> u8 ok
  N: -> u8 ok, i64 size
  K: f32 threshold                      -> u8 ok, i64 rows dropped
  d: -> u8 ok, u32 size, f32[size]
  e: 16s client_uuid, u64 seq, f32 lr, u32 size, f32[size] grads -> u8 ok
  I: u32 size, f32[size] values         -> u8 ok
  H: -> u8 ok

Every response leads with a status byte: 0x01 ok, 0x00 application error
followed by u32 len + utf-8 message. Application errors (bad path, missing
table, wrong table kind, dim mismatch) reach the caller as PsError; they
are not transport failures and are not retried.

Pushes are not idempotent, so they carry a (client_uuid, seq) tag: a retry
after a lost ack replays the same tag and the server skips the re-apply
(at most once for the replayed request) while still acking. With a state
directory the marks persist as `applied.log` records `'<16sQ'`.

Fault tolerance: PsClient remembers endpoints and reconnects with retry on
any transport error, so a killed-and-relaunched server (reloading its
table snapshot) resumes serving the same workers; an optional heartbeat
thread tracks per-server liveness.

`pull` and `push` take numpy arrays, anything `np.ascontiguousarray`
takes, and torch tensors; a tensor on the card is read back to the host
first (a blocking copy on the current stream).
"""
import os
import socket
import struct
import threading
import time
import uuid as _uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...core.monitor import stat_add
from ...core.native import (NativeDenseTable, NativeSparseTable,
                            NativeSsdSparseTable)

__all__ = ['PsError', 'PsServer', 'PsClient', 'host_array']


def host_array(x, dtype):
    """A contiguous host numpy array of `dtype` from x; a torch tensor
    (on the card or not) is read back first."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype)


def _read_n(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError('peer closed')
        got += k
    return bytes(buf)


class PsError(RuntimeError):
    """Server-side application error (bad path, missing table, dim
    mismatch): reaches the caller, never retried."""


def _read_status(sock):
    if _read_n(sock, 1) == b'\x01':
        return
    (ln,) = struct.unpack('<I', _read_n(sock, 4))
    raise PsError(_read_n(sock, ln).decode())


class PsServer:
    """Parity: BrpcPsServer — hosts tables, serves pull/push.

    `state_dir`: when set, the push replay-dedup high-water mark (client
    uuid -> last applied seq) persists to `<state_dir>/applied.log` and is
    recovered (compacted) on construction, so at-most-once holds across a
    server restart: an un-acked push applied before a crash does not
    re-apply when the reconnecting client replays it.

    Durability order: marks buffer in memory and reach the disk only at
    `checkpoint()`, after the table data they refer to is flushed. A
    recovered mark therefore never dedups a replay whose data was lost;
    the converse window (a crash between the table flush and the mark
    flush inside one checkpoint) re-applies that window's pushes.

    The socket binds in the constructor and listens in `start()`: a
    relaunched server adds and loads its tables before `start()`, so no
    client request meets a server without them."""

    _APPLIED_REC = struct.Struct('<16sQ')

    def __init__(self, host='0.0.0.0', port=0, state_dir=None):
        self.tables = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._running = False
        self._conns = []
        self._conns_lock = threading.Lock()
        self._applied = {}          # client uuid -> last applied push seq
        self._applied_log = None
        self._applied_lock = threading.Lock()
        self._applied_pending = []
        self._die_after_apply = 0   # test hook: crash before the ack
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
            path = os.path.join(state_dir, 'applied.log')
            self._recover_applied(path, compact=True)
            self._applied_log = open(path, 'ab')

    def _recover_applied(self, path, compact=False):
        rec = self._APPLIED_REC
        try:
            with open(path, 'rb') as f:
                data = f.read()
        except FileNotFoundError:
            return
        n = len(data) // rec.size       # a crash-truncated tail is dropped
        for i in range(n):
            uuid, seq = rec.unpack_from(data, i * rec.size)
            self._applied[uuid] = seq
        if compact and n > len(self._applied):
            # the log is append-only; rewrite it as the last record per
            # uuid so it stays O(live clients), not O(pushes ever)
            tmp = path + '.tmp'
            with open(tmp, 'wb') as f:
                for u, q in self._applied.items():
                    f.write(rec.pack(u, q))
            os.replace(tmp, path)

    def _mark_applied(self, uuid, seq):
        self._applied[uuid] = seq
        if self._applied_log is not None:
            with self._applied_lock:
                self._applied_pending.append(
                    self._APPLIED_REC.pack(uuid, seq))

    def flush_applied(self):
        """Make the buffered dedup marks durable. Call only after the table
        data they refer to is durable (see checkpoint())."""
        with self._applied_lock:
            if self._applied_log is None:
                return
            pending, self._applied_pending = self._applied_pending, []
            if pending:
                self._applied_log.write(b''.join(pending))
                self._applied_log.flush()

    def checkpoint(self):
        """Durable point: flush table data first, then the marks that refer
        to it."""
        for t in self.tables.values():
            if hasattr(t, 'flush'):
                t.flush()
        self.flush_applied()

    def add_table(self, table_id, dim, optimizer='adagrad', init_range=0.05,
                  num_shards=16, seed=0, beta1=0.9, beta2=0.999, eps=1e-8,
                  ssd_path=None, mem_budget_rows=1 << 20, shard_num=None):
        """Parity: a table config from the_one_ps proto (TableParameter:
        embedx dim, shard_num, per-table optimizer hypers, SSD spill)."""
        if shard_num is not None:     # the ps.proto spelling
            num_shards = shard_num
        if ssd_path:
            self.tables[table_id] = NativeSsdSparseTable(
                dim, ssd_path, num_shards=num_shards, optimizer=optimizer,
                init_range=init_range, seed=seed, beta1=beta1, beta2=beta2,
                eps=eps, mem_budget_rows=mem_budget_rows)
        else:
            self.tables[table_id] = NativeSparseTable(
                dim, num_shards=num_shards, optimizer=optimizer,
                init_range=init_range, seed=seed, beta1=beta1, beta2=beta2,
                eps=eps)
        return self.tables[table_id]

    def add_dense_table(self, table_id, size, optimizer='sgd'):
        """Parity: CommonDenseTable config."""
        self.tables[table_id] = NativeDenseTable(size, optimizer=optimizer)
        return self.tables[table_id]

    def start(self):
        self._running = True
        self._sock.listen(64)
        self._accept_thread = threading.Thread(target=self._accept,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def _accept(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _table(self, tid, dense=None):
        t = self.tables.get(tid)
        if t is None:
            raise KeyError(f'no table {tid} on this server')
        is_dense = isinstance(t, NativeDenseTable)
        if dense is not None and dense != is_dense:
            raise TypeError(f"table {tid} is "
                            f"{'dense' if is_dense else 'sparse'}")
        return t

    def _push_once(self, conn, uuid, seq, apply):
        """Apply a tagged push unless its tag was applied already; True
        when the test hook crashed the server before the ack."""
        if self._applied.get(uuid) != seq:      # replay dedup
            apply()
            self._mark_applied(uuid, seq)
        if self._die_after_apply > 0:
            self._die_after_apply -= 1
            self._crash()
            return True
        conn.sendall(b'\x01')
        return False

    def _serve(self, conn):
        def ok(payload=b''):
            conn.sendall(b'\x01' + payload)

        def fail(e):
            msg = f'{type(e).__name__}: {e}'.encode()[:65535]
            conn.sendall(b'\x00' + struct.pack('<I', len(msg)) + msg)

        try:
            while True:
                op = _read_n(conn, 1)
                if op == b'Q':
                    ok()
                    self.stop()
                    return
                if op == b'H':
                    ok()
                    continue
                (tid,) = struct.unpack('<I', _read_n(conn, 4))
                try:
                    # each branch reads its whole request before any table
                    # lookup or apply, so an application error never
                    # desyncs the stream
                    if op == b'd':
                        rows = self._table(tid, dense=True).pull()
                        ok(struct.pack('<I', len(rows)) + rows.tobytes())
                    elif op == b'e':
                        uuid = _read_n(conn, 16)
                        (seq,) = struct.unpack('<Q', _read_n(conn, 8))
                        lr, n = struct.unpack('<fI', _read_n(conn, 8))
                        g = np.frombuffer(_read_n(conn, 4 * n), np.float32)
                        table = self._table(tid, dense=True)
                        if self._push_once(conn, uuid, seq,
                                           lambda: table.push(g, lr)):
                            return
                    elif op == b'I':
                        (n,) = struct.unpack('<I', _read_n(conn, 4))
                        vals = np.frombuffer(_read_n(conn, 4 * n),
                                             np.float32)
                        self._table(tid, dense=True).set(vals)
                        ok()
                    elif op == b'P':
                        n, dim = struct.unpack('<II', _read_n(conn, 8))
                        ids = np.frombuffer(_read_n(conn, 8 * n), np.int64)
                        table = self._table(tid, dense=False)
                        if table.dim != dim:
                            raise ValueError(
                                f'table {tid} dim {table.dim} != {dim}')
                        ok(table.pull(ids).tobytes())
                    elif op == b'U':
                        uuid = _read_n(conn, 16)
                        (seq,) = struct.unpack('<Q', _read_n(conn, 8))
                        n, dim, lr = struct.unpack('<IIf',
                                                   _read_n(conn, 12))
                        ids = np.frombuffer(_read_n(conn, 8 * n), np.int64)
                        grads = np.frombuffer(
                            _read_n(conn, 4 * n * dim),
                            np.float32).reshape(n, dim)
                        table = self._table(tid, dense=False)
                        if table.dim != dim:
                            raise ValueError(
                                f'table {tid} dim {table.dim} != {dim}')
                        if self._push_once(conn, uuid, seq,
                                           lambda: table.push(ids, grads,
                                                              lr)):
                            return
                    elif op in (b'S', b'L'):
                        (ln,) = struct.unpack('<I', _read_n(conn, 4))
                        path = _read_n(conn, ln).decode()
                        table = self._table(tid)
                        if op == b'S':
                            table.save(path)
                            # the data is durable now: advance the mark log
                            # and snapshot the high-water map beside the
                            # table, so a restore resumes at-most-once
                            self.flush_applied()
                            rec = self._APPLIED_REC
                            with open(path + '.applied', 'wb') as f:
                                for u, q in list(self._applied.items()):
                                    f.write(rec.pack(u, q))
                        else:
                            table.load(path)
                            self._recover_applied(path + '.applied')
                        ok()
                    elif op == b'N':
                        ok(struct.pack('<q', len(self._table(tid))))
                    elif op == b'K':
                        (thr,) = struct.unpack('<f', _read_n(conn, 4))
                        n = self._table(tid, dense=False).shrink(thr)
                        ok(struct.pack('<q', int(n)))
                    else:
                        return
                except ConnectionError:
                    raise
                except Exception as e:   # application error, not transport
                    fail(e)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()
            with self._conns_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass

    def run(self):
        """Blocking serve (parity: fleet.run_server)."""
        self.start()
        self._accept_thread.join()

    def _crash(self):
        """Test hook: die without acking the in-flight push: the push is
        applied and made durable by a checkpoint, the client never saw the
        ack and replays it against the restarted server."""
        self.checkpoint()
        self.stop()

    def stop(self):
        self._running = False
        with self._applied_lock:
            if self._applied_log is not None:
                self._applied_log.close()
                self._applied_log = None
        try:   # wake the blocked accept so the listener dies too
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:         # drop live worker connections too: a stop
            try:                # is an outage, not a drain
                c.shutdown(socket.SHUT_RDWR)   # wakes the blocked recv
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class PsClient:
    """Parity: BrpcPsClient — shards requests across servers by id hash.

    Transport errors trigger a transparent reconnect with retry (up to
    `retry_timeout` seconds), so a relaunched server resumes serving the
    same client; `start_heartbeat` tracks per-server liveness. `timeout`
    bounds each connect and each socket read or write."""

    def __init__(self, endpoints, timeout=60, retry_timeout=30):
        self.endpoints = list(endpoints)
        self._timeout = timeout
        self._retry_timeout = retry_timeout
        self._socks = [None] * len(self.endpoints)
        self._locks = [threading.Lock() for _ in self.endpoints]
        self.n_servers = len(self.endpoints)
        self.alive = [True] * self.n_servers
        self._uuid = _uuid.uuid4().bytes    # push replay-dedup identity
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._hb_thread = None
        self._hb_stop = threading.Event()
        for s in range(self.n_servers):
            self._connect(s)
        # shard requests fan out concurrently (the reference BrpcPsClient
        # issues parallel RPCs; serial round trips would scale latency
        # with the server count)
        self._pool = ThreadPoolExecutor(max_workers=min(self.n_servers, 16)) \
            if self.n_servers > 1 else None

    def _open(self, s):
        host, port = self.endpoints[s].rsplit(':', 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _connect(self, s):
        self._socks[s] = self._open(s)
        return self._socks[s]

    def _rpc(self, s, fn):
        """Run `fn(sock)` under the server's lock, reconnecting with retry
        on transport errors (fn must be a whole request, replayable on a
        fresh connection)."""
        deadline = time.monotonic() + self._retry_timeout
        with self._locks[s]:
            while True:
                try:
                    if self._socks[s] is None:
                        self._connect(s)
                    out = fn(self._socks[s])
                    self.alive[s] = True
                    return out
                except (ConnectionError, OSError):
                    try:
                        if self._socks[s] is not None:
                            self._socks[s].close()
                    except OSError:
                        pass
                    self._socks[s] = None
                    self.alive[s] = False
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.2)

    # -- heartbeat (parity: brpc keepalive / Communicator heartbeats) -------
    def start_heartbeat(self, interval=1.0):
        if self._hb_thread is not None:
            return

        def beat(s):
            used = None
            try:
                with self._locks[s]:
                    need_connect = self._socks[s] is None
                if need_connect:
                    # connect outside the lock: a blackholed host would
                    # otherwise stall every rpc behind the connect timeout
                    fresh = self._open(s)
                    with self._locks[s]:
                        if self._socks[s] is None:
                            self._socks[s] = fresh
                        else:   # an _rpc beat us to it
                            fresh.close()
                with self._locks[s]:
                    used = self._socks[s]
                    if used is None:
                        return
                    used.sendall(b'H')
                    _read_n(used, 1)
                self.alive[s] = True
            except (ConnectionError, OSError):
                self.alive[s] = False
                with self._locks[s]:
                    # tear down only the socket this beat failed on; a
                    # concurrent _rpc may have reconnected already
                    if used is not None and self._socks[s] is used:
                        try:
                            used.close()
                        except OSError:
                            pass
                        self._socks[s] = None

        def loop():
            while not self._hb_stop.wait(interval):
                for s in range(self.n_servers):
                    beat(s)
        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self):
        if self._hb_thread is not None:
            self._hb_stop.set()
            self._hb_thread.join()
            self._hb_thread = None
            self._hb_stop.clear()

    def _shard(self, ids):
        return (ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
                >> np.uint64(33)) % np.uint64(self.n_servers)

    def _fanout(self, fn, shard_ids):
        if self._pool is None or len(shard_ids) <= 1:
            for s in shard_ids:
                fn(s)
            return
        list(self._pool.map(fn, shard_ids))

    def _next_tag(self):
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        return self._uuid + struct.pack('<Q', seq)

    def pull(self, table_id, ids, dim):
        ids = host_array(ids, np.int64).reshape(-1)
        stat_add('STAT_ps_client_pull_ids', len(ids))
        out = np.empty((len(ids), dim), np.float32)
        shards = self._shard(ids)

        def one(s):
            mask = shards == s
            if not mask.any():
                return
            sub = ids[mask]

            def req(sock):
                sock.sendall(b'P' + struct.pack('<III', table_id,
                                                len(sub), dim)
                             + sub.tobytes())
                _read_status(sock)
                return np.frombuffer(_read_n(sock, 4 * len(sub) * dim),
                                     np.float32).reshape(len(sub), dim)
            out[mask] = self._rpc(s, req)
        self._fanout(one, range(self.n_servers))
        return out

    def push(self, table_id, ids, grads, lr):
        ids = host_array(ids, np.int64).reshape(-1)
        stat_add('STAT_ps_client_push_ids', len(ids))
        grads = host_array(grads, np.float32)
        shards = self._shard(ids)
        tag = self._next_tag()

        def one(s):
            mask = shards == s
            if not mask.any():
                return
            sub = ids[mask]
            sub_g = grads[mask]

            def req(sock):
                sock.sendall(b'U' + struct.pack('<I', table_id) + tag
                             + struct.pack('<IIf', len(sub),
                                           grads.shape[1], lr)
                             + sub.tobytes() + sub_g.tobytes())
                _read_status(sock)
            self._rpc(s, req)
        self._fanout(one, range(self.n_servers))

    def save(self, table_id, path):
        for s in range(self.n_servers):
            p = f'{path}.part{s}'.encode()

            def req(sock, _p=p):
                sock.sendall(b'S' + struct.pack('<II', table_id, len(_p))
                             + _p)
                _read_status(sock)
            self._rpc(s, req)

    def table_size(self, table_id):
        def req(sock):
            sock.sendall(b'N' + struct.pack('<I', table_id))
            _read_status(sock)
            return struct.unpack('<q', _read_n(sock, 8))[0]
        return sum(self._rpc(s, req) for s in range(self.n_servers))

    def shrink(self, table_id, threshold):
        """Drop rows with L2 norm below threshold on every server (parity:
        fleet.shrink for stale features). Returns the rows dropped."""
        def req(sock):
            sock.sendall(b'K' + struct.pack('<If', table_id,
                                            float(threshold)))
            _read_status(sock)
            return struct.unpack('<q', _read_n(sock, 8))[0]
        return sum(self._rpc(s, req) for s in range(self.n_servers))

    # -- dense tables (one table lives on server table_id % n_servers) ------
    def _dense_server(self, table_id):
        return table_id % self.n_servers

    def dense_init(self, table_id, values):
        vals = host_array(values, np.float32).reshape(-1)

        def req(sock):
            sock.sendall(b'I' + struct.pack('<II', table_id, len(vals))
                         + vals.tobytes())
            _read_status(sock)
        self._rpc(self._dense_server(table_id), req)

    def dense_pull(self, table_id):
        def req(sock):
            sock.sendall(b'd' + struct.pack('<I', table_id))
            _read_status(sock)
            (n,) = struct.unpack('<I', _read_n(sock, 4))
            return np.frombuffer(_read_n(sock, 4 * n), np.float32)
        return self._rpc(self._dense_server(table_id), req)

    def dense_save(self, table_id, path):
        """A dense table lives on one server (table_id % n_servers), so its
        save targets only that server."""
        p = f'{path}.part{self._dense_server(table_id)}'.encode()

        def req(sock):
            sock.sendall(b'S' + struct.pack('<II', table_id, len(p)) + p)
            _read_status(sock)
        self._rpc(self._dense_server(table_id), req)

    def dense_push(self, table_id, grad, lr):
        g = host_array(grad, np.float32).reshape(-1)
        tag = self._next_tag()

        def req(sock):
            sock.sendall(b'e' + struct.pack('<I', table_id) + tag
                         + struct.pack('<fI', lr, len(g)) + g.tobytes())
            _read_status(sock)
        self._rpc(self._dense_server(table_id), req)

    def shutdown(self):
        """Stop every server (the 'Q' op)."""
        self.stop_heartbeat()
        for s in range(self.n_servers):
            try:
                with self._locks[s]:
                    if self._socks[s] is not None:
                        self._socks[s].sendall(b'Q')
                        _read_n(self._socks[s], 1)
            except (ConnectionError, OSError):
                pass

    def close(self):
        self.stop_heartbeat()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        for s in self._socks:
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass
