"""Host spans and the chrome-trace writer — the subset of
`paddle_tpu/profiler.py` the serving engine needs: `RecordEvent` and
`_write_chrome_trace`, the writer behind `export_chrome_tracing` (:244,
:286-366 there).

`RecordEvent(name, event_type=..., **args)` marks one nested span. It
always opens a `torch.profiler.record_function` range, so the engine's
`serve::*` phases show by name in a `torch.profiler` trace beside the
kernels they launched. Between `start_profiler()` and `stop_profiler()`
it also appends the span (start, duration, thread, parent, args) to a
bounded in-process buffer, `_buffer`, which the request tracer's chrome
export reads; outside that window the buffer is untouched.

The rest of the reference profiler (the v2 `Profiler` scheduler, step
telemetry, the native recorder) is not ported.
"""
import collections
import json
import os
import threading
import time

import torch

_PID = os.getpid()


class _SpanBuffer:
    """Ring buffer of completed spans (thread-safe)."""

    def __init__(self, capacity=200000):
        self._spans = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._next_id = 0

    def new_id(self):
        with self._lock:
            self._next_id += 1
            return self._next_id

    def append(self, span):
        with self._lock:
            self._spans.append(span)

    def snapshot(self):
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()

    def __len__(self):
        with self._lock:
            return len(self._spans)


_buffer = _SpanBuffer()
_tls = threading.local()                 # per-thread open-span stack
_recording = False


def start_profiler():
    """Record RecordEvent spans into the buffer from now on."""
    global _recording
    _recording = True


def stop_profiler():
    global _recording
    _recording = False


def reset_profiler():
    _buffer.clear()


def _now_us():
    return time.perf_counter_ns() // 1000


def _stack():
    st = getattr(_tls, 'stack', None)
    if st is None:
        st = _tls.stack = []
    return st


class RecordEvent:
    """A nested, thread-aware span marker (paddle.profiler.RecordEvent).
    Extra kwargs become the span's chrome-trace `args`. Usable as a
    context manager or through begin()/end()."""

    __slots__ = ('name', 'event_type', 'args', '_start', '_id', '_range')

    def __init__(self, name, event_type=None, **kwargs):
        self.name = name
        self.event_type = event_type
        self.args = kwargs or None
        self._start = None
        self._id = None
        self._range = None

    def begin(self):
        self._range = torch.autograd.profiler.record_function(self.name)
        self._range.__enter__()
        if not _recording:
            return
        self._start = _now_us()
        self._id = _buffer.new_id()
        _stack().append(self._id)

    def end(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._start is None:
            return
        end_us = _now_us()
        st = _stack()
        if st and st[-1] == self._id:
            st.pop()
        parent = st[-1] if st else 0
        t = threading.current_thread()
        _buffer.append({
            'name': self.name, 'cat': self.event_type or 'python',
            'ts': self._start, 'dur': end_us - self._start,
            'tid': t.ident or 0, 'tname': t.name,
            'id': self._id, 'parent': parent, 'depth': len(st),
            'args': self.args,
        })
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *a):
        self.end()
        return False


def _chrome_events(spans):
    # spans may carry an explicit 'pid'/'pname' (synthetic track groups:
    # the request tracer puts each request on its own virtual thread of
    # a 'serving requests' pseudo-process beside the host's spans)
    events = []
    threads = {}
    procs = {_PID: 'paddle_tpu_torch host'}
    for s in spans:
        pid = s.get('pid', _PID)
        if s.get('pname'):
            procs[pid] = s['pname']
        elif pid not in procs:
            procs[pid] = f'paddle_tpu_torch pid {pid}'
        threads.setdefault((pid, s.get('tid', 0)), s.get('tname', ''))
        ev = {'name': s['name'], 'ph': 'X', 'pid': pid,
              'tid': s.get('tid', 0), 'ts': s['ts'], 'dur': s['dur'],
              'cat': s.get('cat') or 'python'}
        args = dict(s.get('args') or {})
        if s.get('parent'):
            args['parent_id'] = s['parent']
        if s.get('depth') is not None:
            args['depth'] = s['depth']
        if args:
            ev['args'] = {k: _jsonable(v) for k, v in args.items()}
        events.append(ev)
    for pid, pname in procs.items():
        events.append({'name': 'process_name', 'ph': 'M', 'pid': pid,
                       'args': {'name': pname}})
    for (pid, tid), tname in threads.items():
        events.append({'name': 'thread_name', 'ph': 'M', 'pid': pid,
                       'tid': tid, 'args': {'name': tname or str(tid)}})
    return events


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


def _write_chrome_trace(path, spans, metadata=None):
    doc = {'traceEvents': _chrome_events(spans)}
    if metadata:
        doc['metadata'] = metadata
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, 'w') as f:
        json.dump(doc, f)
    return path
