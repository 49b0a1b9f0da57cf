"""Profiler and step telemetry — counterpart of `paddle_tpu/profiler.py`.

`RecordEvent(name, event_type=..., **args)` marks one nested span. It
always opens a `torch.profiler.record_function` range, so the engine's
`serve::*` phases show by name in a `torch.profiler` trace beside the
kernels they launched. Between `start_profiler()` and `stop_profiler()`, and inside a
`Profiler`'s RECORD windows, it also appends the span (start, duration,
thread, parent, args) to a bounded in-process buffer, `_buffer`, which
the request tracer's chrome export reads; outside them the buffer is
untouched.

`Profiler` is paddle 2.x's: a scheduler (`make_scheduler`, its torch-
style aliases too) drives CLOSED / READY / RECORD windows over the span
buffer, `on_trace_ready` handlers run at each window's end
(`export_chrome_tracing_handler`), and `ProfilerResult` exports chrome
or JSON. With `ProfilerTarget.GPU` among its targets, each RECORD window
is also a `torch.profiler.profile` over the CPU and CUDA activities,
whose chrome trace the export merges. Only one `torch.profiler.profile`
may run at a time: nothing else here opens one.

`StepTelemetry` is the rolling step reporter; its `snapshot()` has the
reference's keys, read from what the port publishes: `pallas` is the
kernel wrappers' launch counts (`ops/kernels/_build.routes_snapshot`),
`remat` the remat census, `host` the gap monitors and prefetch totals,
`ledger` the step ledgers, `comm` (with `comm_overlap`) the comm model,
`numerics` and `serve` theirs. The reference's
`compile_with_telemetry` and XLA cost analysis have no counterpart (the
port compiles no program a step): `compiles_total` and
`compile_seconds_total` count the kernel library's one nvcc build, and
`compile_cache` is None. The native recorder is not ported.
"""
import collections
import contextlib
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

    def drain(self):
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def clear(self):
        with self._lock:
            self._spans.clear()

    def __len__(self):
        with self._lock:
            return len(self._spans)


_buffer = _SpanBuffer()
_tls = threading.local()                 # per-thread open-span stack
_recording = False                       # start/stop_profiler
_tracer_depth = 0                        # Profiler RECORD windows


def _tracing_on():
    return _recording or _tracer_depth > 0


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
        if not _tracing_on():
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


def _device_chrome_events(trace_dir):
    """The events of the torch.profiler chrome trace a Profiler window
    wrote under `trace_dir` (empty when there is none)."""
    if not trace_dir:
        return []
    path = os.path.join(trace_dir, 'torch_trace.json')
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    return list(doc.get('traceEvents') or [])


# ---------------------------------------------------------------------------
# scheduler (paddle 2.x make_scheduler, torch aliases accepted)
# ---------------------------------------------------------------------------
class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3       # last RECORD step of a cycle


def make_scheduler(*, closed=None, ready=None, record=None, repeat=0,
                   skip_first=0, wait=None, warmup=None, active=None):
    """Parity: paddle.profiler.make_scheduler(closed, ready, record,
    repeat, skip_first); torch-style wait/warmup/active aliases map to
    closed/ready/record. Returns fn(step) -> ProfilerState."""
    closed = wait if closed is None else closed
    ready = warmup if ready is None else ready
    record = active if record is None else record
    closed = int(closed or 0)
    ready = int(ready or 0)
    record = int(record)
    if record <= 0:
        raise ValueError("record (active) must be >= 1")
    if closed < 0 or ready < 0 or skip_first < 0 or repeat < 0:
        raise ValueError("scheduler windows must be non-negative")
    cycle = closed + ready + record

    def scheduler(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat and step >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = step % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    scheduler._cycle = (skip_first, closed, ready, record, repeat)
    return scheduler


def _default_scheduler(_step):
    return ProfilerState.RECORD


class ProfilerTarget:
    CPU = 'cpu'
    GPU = 'gpu'
    TPU = 'tpu'
    CUSTOM_DEVICE = 'custom_device'


def export_chrome_tracing_handler(dir_name, worker_name=None):
    """Parity: paddle.profiler.export_chrome_tracing(dir_name): an
    on_trace_ready handler writing one chrome-trace file per collected
    window into `dir_name`."""
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof):
        worker = worker_name or f'host_{_PID}'
        lo, hi = prof.profiler_result.step_range
        path = os.path.join(dir_name,
                            f'{worker}_steps_{lo}_{hi}.paddle_trace.json')
        prof.profiler_result.export_chrome_tracing(path)
        return path
    return handler


class ProfilerResult:
    """Spans collected for one RECORD window, plus metadata."""

    def __init__(self, spans, step_range=(0, 0), device_trace_dir=None):
        self.spans = spans
        self.step_range = tuple(step_range)
        self.device_trace_dir = device_trace_dir

    def events(self):
        return list(self.spans)

    def _metadata(self):
        md = {'step_range': list(self.step_range),
              'schema': 'paddle_tpu_torch.profiler/1'}
        if self.device_trace_dir:
            md['device_trace_dir'] = self.device_trace_dir
        return md

    def export_chrome_tracing(self, path):
        doc = {'traceEvents': _chrome_events(self.spans)
               + _device_chrome_events(self.device_trace_dir),
               'metadata': self._metadata()}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, 'w') as f:
            json.dump(doc, f)
        return path

    def export_json(self, path):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, 'w') as f:
            json.dump({'metadata': self._metadata(),
                       'spans': [dict(s, args=_jsonable(s.get('args')))
                                 for s in self.spans]}, f)
        return path

    def summary(self, top=20):
        agg = {}
        for s in self.spans:
            a = agg.setdefault(s['name'], [0, 0])
            a[0] += 1
            a[1] += s['dur']
        rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
        lines = ['name\tcalls\ttotal_ms\tavg_us']
        for name, (c, tot) in rows:
            lines.append(f'{name}\t{c}\t{tot / 1000.0:.3f}\t{tot / c:.1f}')
        return '\n'.join(lines) + '\n'


class Profiler:
    """Parity: paddle.profiler.Profiler (2.x): scheduler-driven RECORD
    windows over the span buffer, on_trace_ready handlers, chrome/JSON
    export. With ProfilerTarget.GPU among `targets` each RECORD window
    is also a torch.profiler.profile (CPU and CUDA activities)."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False, device_trace_dir=None):
        self.timer_only = timer_only
        self.targets = list(targets) if targets else [ProfilerTarget.CPU]
        if scheduler is None:
            self._scheduler = _default_scheduler
        elif callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            start, end = scheduler
            if end <= start:
                raise ValueError("scheduler (start, end) needs end > start")
            self._scheduler = make_scheduler(closed=max(int(start), 0),
                                             record=int(end) - int(start),
                                             repeat=1)
        else:
            raise TypeError(f"bad scheduler {scheduler!r}")
        self.on_trace_ready = on_trace_ready
        self.profiler_result = None
        self._record_shapes = bool(record_shapes)
        self._profile_memory = bool(profile_memory)
        self._with_flops = bool(with_flops)
        self._device_trace_dir = device_trace_dir
        self._device_prof = None
        self.current_state = ProfilerState.CLOSED
        self._step_num = 0
        self._window_start = 0
        self._running = False

    # -- device bracket ------------------------------------------------------
    def _wants_device(self):
        return ProfilerTarget.GPU in self.targets and \
            torch.cuda.is_available()

    def _device_begin(self):
        if not self._wants_device() or self._device_prof is not None:
            return
        import tempfile
        from torch.profiler import ProfilerActivity, profile
        self._device_trace_dir = (self._device_trace_dir or tempfile.mkdtemp(
            prefix='paddle_tpu_torch_trace_'))
        self._device_prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=self._record_shapes,
            profile_memory=self._profile_memory,
            with_flops=self._with_flops)
        self._device_prof.__enter__()

    def _device_end(self):
        prof, self._device_prof = self._device_prof, None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        os.makedirs(self._device_trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self._device_trace_dir, 'torch_trace.json'))
        self.device_profile = prof

    # -- state machine -------------------------------------------------------
    def _tracer_enable(self):
        global _tracer_depth
        _tracer_depth += 1

    def _tracer_disable(self):
        global _tracer_depth
        _tracer_depth = max(0, _tracer_depth - 1)

    def _transition(self, new_state):
        old = self.current_state
        rec = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if old not in rec and new_state in rec:
            _buffer.drain()          # discard warm-up spans
            self._window_start = self._step_num
            self._tracer_enable()
            self._device_begin()
        if old == ProfilerState.RECORD_AND_RETURN or \
                (old in rec and new_state not in rec):
            self._device_end()
            self._tracer_disable()
            self._collect()
            if new_state in rec:     # back-to-back windows (repeat)
                self._window_start = self._step_num
                self._tracer_enable()
                self._device_begin()
        self.current_state = new_state

    def _collect(self):
        self.profiler_result = ProfilerResult(
            _buffer.drain(),
            step_range=(self._window_start, self._step_num),
            device_trace_dir=(self._device_trace_dir
                              if self._wants_device() else None))
        if self.on_trace_ready is not None and not self.timer_only:
            self.on_trace_ready(self)

    def start(self):
        if self._running:
            return
        self._running = True
        self._step_num = 0
        self._transition(self._scheduler(0))

    def step(self, num_samples=None):
        """Advance one iteration; drives the scheduler state machine."""
        if not self._running:
            raise RuntimeError("Profiler.step() before start()")
        self._step_num += 1
        new_state = self._scheduler(self._step_num)
        if new_state != self.current_state or \
                self.current_state == ProfilerState.RECORD_AND_RETURN:
            self._transition(new_state)

    def stop(self):
        if not self._running:
            return
        rec = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if self.current_state in rec:
            self._device_end()
            self._tracer_disable()
            self._collect()
        self.current_state = ProfilerState.CLOSED
        self._running = False

    # -- results -------------------------------------------------------------
    def export(self, path, format='json'):
        if self.profiler_result is None:
            raise RuntimeError("no collected window to export — run a "
                               "RECORD window (or call stop()) first")
        chrome = format in ('chrome', 'chrome_trace', 'chrometracing') \
            or path.endswith(('.trace.json', '.chrome.json'))
        if chrome:
            return self.profiler_result.export_chrome_tracing(path)
        return self.profiler_result.export_json(path)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit='ms'):
        if self.profiler_result is not None:
            return self.profiler_result.summary()
        return ProfilerResult(_buffer.snapshot()).summary()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()
        return False


def device_memory_stats():
    """The card's allocator view: bytes in use, the peak since the
    allocator's last reset, and the card's memory (None without a card).
    Reads host-side counters: no call waits on the card."""
    if not torch.cuda.is_available():
        return None
    dev = torch.cuda.current_device()
    return {'bytes_in_use': int(torch.cuda.memory_allocated(dev)),
            'peak_bytes_in_use': int(torch.cuda.max_memory_allocated(dev)),
            'bytes_limit':
                int(torch.cuda.get_device_properties(dev).total_memory)}


# ---------------------------------------------------------------------------
# step telemetry reporter
# ---------------------------------------------------------------------------
class StepTelemetry:
    """Rolling-window step reporter: examples/sec, tokens/sec, step
    latency, compile totals, device memory. Publishes gauges on every
    end_step (with `publish`); snapshot() returns the JSON-ready dict a
    run's record carries. It opens no torch.profiler.profile."""

    def __init__(self, window=20, publish=True):
        self.window = int(window)
        self.publish = publish
        self._durs = collections.deque(maxlen=self.window)
        self._examples = collections.deque(maxlen=self.window)
        self._tokens = collections.deque(maxlen=self.window)
        self._t0 = None
        self.steps = 0

    def begin_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, examples=None, tokens=None):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.steps += 1
        self._durs.append(dt)
        self._examples.append(0 if examples is None else int(examples))
        self._tokens.append(0 if tokens is None else int(tokens))
        if self.publish:
            self._publish()

    @contextlib.contextmanager
    def step(self, examples=None, tokens=None):
        self.begin_step()
        try:
            yield
        finally:
            self.end_step(examples=examples, tokens=tokens)

    # -- derived rates -------------------------------------------------------
    def _rate(self, counts):
        total_t = sum(self._durs)
        if not total_t:
            return 0.0
        return sum(counts) / total_t

    def examples_per_sec(self):
        return self._rate(self._examples)

    def tokens_per_sec(self):
        return self._rate(self._tokens)

    def avg_step_ms(self):
        return (sum(self._durs) / len(self._durs) * 1000.0) \
            if self._durs else 0.0

    def _publish(self):
        from .core import monitor as _monitor
        g = _monitor.gauge
        g('ptpu_examples_per_sec',
          help='rolling-window training throughput').set(
              self.examples_per_sec())
        if any(self._tokens):
            g('ptpu_tokens_per_sec',
              help='rolling-window token throughput').set(
                  self.tokens_per_sec())
        g('ptpu_step_ms', help='rolling mean step latency').set(
            self.avg_step_ms())
        g('ptpu_steps_total', help='telemetry steps observed').set(
            self.steps)
        mem = device_memory_stats()
        if mem and mem.get('bytes_in_use') is not None:
            g('ptpu_device_bytes_in_use',
              help='live device memory (the CUDA caching allocator)').set(
                  mem['bytes_in_use'])
        # history sampling rides the publish cadence (a no-op unless
        # MetricsRegistry.enable_history() opted in)
        _monitor.metrics().history_tick()

    def snapshot(self):
        from .core import monitor as _monitor
        reg = _monitor.metrics()

        def _counter_total(name):
            m = reg.get(name)
            if m is None:
                return 0.0
            return sum(c.value() for c in m._series().values())
        stats = _monitor.get_stats()
        snap = {
            'steps': self.steps,
            'avg_step_ms': self.avg_step_ms(),
            'examples_per_sec': self.examples_per_sec(),
            'tokens_per_sec': self.tokens_per_sec(),
            'compile_seconds_total':
                _counter_total('ptpu_compile_seconds_total'),
            'compiles_total': _counter_total('ptpu_compiles_total'),
            'compile_cache_hits':
                int(stats.get('STAT_executor_cache_hit', 0)),
            'compile_cache_misses':
                int(stats.get('STAT_executor_cache_miss', 0)),
            'device_memory': device_memory_stats(),
            'compile_cache': None,
        }
        try:
            from .core import numerics as _numerics
            snap['numerics'] = _numerics.snapshot()
        except Exception:
            snap['numerics'] = None
        try:
            from .core import bucketing as _bucketing
            snap['comm'] = _bucketing.comm_snapshot() or None
        except Exception:
            snap['comm'] = None
        try:
            from .serving import metrics as _sm
            snap['serve'] = _sm.serve_snapshot() or None
        except Exception:
            snap['serve'] = None
        try:
            from .ops.kernels import _build
            snap['pallas'] = _build.routes_snapshot()
        except Exception:
            snap['pallas'] = None
        try:
            from .core import async_step as _async_step
            host = _async_step.host_snapshot()
            snap['host'] = host if (host.get('sites')
                                    or host['prefetch']['batches']) \
                else None
        except Exception:
            snap['host'] = None
        try:
            from .distributed.fleet.utils.recompute import (
                snapshot as _remat_snapshot)
            from .core import memory as _mem
            remat = _remat_snapshot()
            acts = _mem.activation_bytes()
            if remat is not None or acts:
                remat = dict(remat or {})
                remat['activation_bytes'] = acts or None
            snap['remat'] = remat
        except Exception:
            snap['remat'] = None
        try:
            snap['pipeline'] = None
            if reg.get('ptpu_pp_ticks') is not None:
                from .distributed.fleet.meta_parallel.spmd_pipeline \
                    import pipeline_snapshot
                snap['pipeline'] = pipeline_snapshot()
        except Exception:
            snap['pipeline'] = None
        try:
            from .core.ledger import ledger_snapshot
            snap['ledger'] = ledger_snapshot()
        except Exception:
            snap['ledger'] = None
        return snap


__all__ = [
    'RecordEvent', 'Profiler', 'ProfilerState', 'ProfilerTarget',
    'ProfilerResult', 'make_scheduler', 'export_chrome_tracing_handler',
    'start_profiler', 'stop_profiler', 'reset_profiler',
    'device_memory_stats', 'StepTelemetry',
]
