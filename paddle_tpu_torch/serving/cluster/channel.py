"""Length-prefixed JSON control channel between the router and worker
replicas — counterpart of `paddle_tpu/serving/cluster/channel.py`, on
the same wire: a little-endian uint32 length, then that many bytes of
JSON, at most MAX_MSG.

The cluster's control plane only: submissions, token polls, status
probes, drains and the `metrics` federation op. KV pages never cross
this socket. One request per message, strictly ordered per connection;
the client serializes its calls under a lock.

What a call raises, and what the router makes of it
(router.py `_CHANNEL_ERRORS`):
  * ConnectionError (the worker is gone) and socket.timeout (it did not
    answer in time), both OSErrors: a channel fault, the router drains;
  * ValueError: a frame over MAX_MSG, sent or received; the message is
    at fault, not the replica, so it reaches the caller;
  * RuntimeError: the worker's handler raised and replied {'error':
    repr}; an engine error, which reaches the caller.
"""
import json
import socket
import struct
import threading

_HDR = struct.Struct('<I')
MAX_MSG = 64 * 1024 * 1024


def send_msg(sock, obj):
    data = json.dumps(obj).encode()
    if len(data) > MAX_MSG:
        raise ValueError(f"control message of {len(data)} bytes "
                         f"exceeds the {MAX_MSG} cap")
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock, n):
    buf = b''
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("control channel closed")
        buf += chunk
    return buf


def recv_msg(sock):
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if n > MAX_MSG:
        raise ValueError(f"control frame of {n} bytes exceeds cap")
    return json.loads(_recv_exact(sock, n).decode())


class ControlServer:
    """An accept loop and a handler thread a connection. `handler(msg)`
    returns the reply dict; an exception becomes an {'error': repr}
    reply, so a bad request cannot kill the worker's control plane."""

    def __init__(self, handler, host='127.0.0.1', port=0):
        self.handler = handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread = None
        self._conns = set()
        self._conns_lock = threading.Lock()

    def start(self):
        self._thread = threading.Thread(target=self._accept_loop,
                                        name='cluster-control', daemon=True)
        self._thread.start()
        return self

    def _accept_loop(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        with self._conns_lock:
            self._conns.add(conn)
        try:
            with conn:
                self._serve(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _serve(self, conn):
        while not self._stop.is_set():
            try:
                msg = recv_msg(conn)
            except (ConnectionError, OSError, ValueError):
                return
            try:
                reply = self.handler(msg) or {}
            except Exception as e:          # noqa: BLE001
                reply = {'error': repr(e)[:500]}
            try:
                send_msg(conn, reply)
            except OSError:
                return

    def close(self):
        """Stop accepting and drop every open connection, so a stopped
        worker reads as gone (ConnectionError) on its clients' next
        call."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class ControlClient:
    """One persistent connection; `call()` is request/response with a
    per-call timeout (socket.timeout propagates: the router reads it as
    'replica unresponsive').

    Frames carry no request ids, so a connection that failed in the
    middle of a call is out of step: a late reply to the timed-out
    request would be read as the next call's. Any send or receive
    failure therefore drops the connection, and the next call dials
    afresh."""

    def __init__(self, host, port, timeout=10.0):
        self._addr = (host, int(port))
        self._lock = threading.Lock()
        self._timeout = timeout
        self._sock = socket.create_connection(self._addr, timeout=timeout)

    def call(self, msg, timeout=None):
        with self._lock:
            if self._sock is None:
                self._sock = socket.create_connection(
                    self._addr, timeout=timeout or self._timeout)
            try:
                self._sock.settimeout(timeout or self._timeout)
                send_msg(self._sock, msg)
                reply = recv_msg(self._sock)
            except (OSError, ValueError):
                # out of step or dead: never reuse this connection
                try:
                    self._sock.close()
                finally:
                    self._sock = None
                raise
        if isinstance(reply, dict) and reply.get('error'):
            raise RuntimeError(f"replica error: {reply['error']}")
        return reply

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
