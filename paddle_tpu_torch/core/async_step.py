"""Asynchronous train steps — counterpart of
`paddle_tpu/core/async_step.py`: `resolve_dispatch_window` and
`resolve_prefetch_depth` (:56-70), `HostGapMonitor` (:114), the prefetch
totals and `host_snapshot` (:280-326), `AsyncResult` (:328-418),
`AsyncDispatchMixin` (:421-447) and `DispatchWindow` (:450-479).

A step's work is queued on the card's stream when `train_step` returns;
its `AsyncResult` holds the loss and the found-inf flag as device
tensors and a CUDA event recorded after the step's last launch. `wait()`
synchronises on that event (not a transfer), attributes the wait to the
engine's gap monitor (a wait on the NEWEST dispatched step gates the
card: host gap; a wait on an older one has queued runway behind it:
blocked), and then runs the step's deferred drain work (numerics taps,
a GradScaler's found-inf accounting) once, in drain order; if that work
raises, a later wait retries it. `result()` is the one host fetch of the
loss. On the CPU the step has finished when it returns, and there is no
event.

`HostGapMonitor` keeps rolling per-step dispatch timestamps for one
engine site and derives the host gap and the `host_bound_fraction`
(gating wait / step interval); the serving engine's gating wait is its
host fetch of chosen ids. `AsyncDispatchMixin.flush` drains an engine's
window at a deliberate barrier and publishes the monitor's gauges and
the engine's step ledger there, never in the dispatch loop. A
`DeviceLoader` (io/device_loader.py) reports its prefetch totals here.
"""
import collections
import os
import threading
import time

import torch

DEFAULT_DISPATCH_WINDOW = 2
DEFAULT_PREFETCH_DEPTH = 2


def _env_int(name, default):
    v = os.environ.get(name)
    if v is None or v == '':
        return default
    try:
        return int(v)
    except ValueError:
        return default


def resolve_dispatch_window(window=None):
    """In-flight dispatch window: the kwarg, then `PTPU_DISPATCH_WINDOW`,
    then 2; clamped to at least 1."""
    if window is None:
        window = _env_int('PTPU_DISPATCH_WINDOW', DEFAULT_DISPATCH_WINDOW)
    return max(int(window), 1)


def resolve_prefetch_depth(depth=None):
    """DeviceLoader prefetch depth: the kwarg, then
    `PTPU_DEVICE_PREFETCH`, then 2; clamped to at least 1."""
    if depth is None:
        depth = _env_int('PTPU_DEVICE_PREFETCH', DEFAULT_PREFETCH_DEPTH)
    return max(int(depth), 1)


class AsyncResult:
    """One dispatched train step: the fp32 loss on the device, no host
    fetch."""

    __slots__ = ('loss', 'step', 'found_inf', '_event', '_drained',
                 '_host_loss', '_staged', '_on_drain', '_taps',
                 '_monitor', '_counted', '_seq')

    def __init__(self, loss, step, staged=(), found_inf=None,
                 on_drain=None, taps=None, monitor=None):
        """`staged`: host buffers the step's copies read, kept until the
        step drains; `found_inf`: the step's device flag (a nonfinite
        gradient skipped its update); `on_drain(result)`: run once when
        the step drains; `taps`: the step's numerics taps (device);
        `monitor`: the engine's HostGapMonitor, which the wait reports
        to."""
        self.loss = loss
        self.step = step
        self.found_inf = found_inf
        self._on_drain = on_drain
        self._taps = taps
        self._monitor = monitor
        self._counted = False
        # while this is still the NEWEST dispatched step, a wait on it is
        # the synchronous discipline (no queued runway): host gap
        self._seq = monitor.dispatched_total if monitor is not None \
            else None
        self._event = None
        if loss.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        self._drained = False
        self._host_loss = None
        self._staged = staged

    @property
    def taps(self):
        return self._taps

    def done(self):
        """Whether the step was drained (waited on), as the reference's."""
        return self._drained

    def wait(self):
        """Block until the card finished this step, then run its drain
        work once (retried by a later wait if it raised)."""
        if self._drained:
            return self
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        if self._monitor is not None and not self._counted:
            self._counted = True
            dt = time.perf_counter() - t0
            if self._seq != self._monitor.dispatched_total:
                self._monitor.note_blocked(dt)
            else:
                self._monitor.note_gating(dt)
            self._monitor.step_ready()
        self._staged = ()
        cb = self._on_drain
        if cb is not None:
            cb(self)
            self._on_drain = None
        self._drained = True
        return self

    def result(self):
        """The loss as a host float: the one host fetch."""
        if self._host_loss is None:
            self.wait()
            self._host_loss = float(self.loss)
        return self._host_loss

    def __float__(self):
        return self.result()

    def __repr__(self):
        state = 'drained' if self._drained else 'in-flight'
        return f'AsyncResult(step={self.step}, {state})'


class AsyncDispatchMixin:
    """The window-drain surface of the train engines (each owns a
    `_inflight` DispatchWindow, a `_gap` HostGapMonitor and a `_ledger`
    StepLedger)."""

    def flush(self):
        """Drain the in-flight window: the deferred per-step work runs
        here, then the gap monitor's gauges and the step ledger publish.
        The flush's waits are a deliberate barrier, excluded from the
        next dispatch's host-gap sample. Returns the drained results."""
        drained = self._inflight.flush()
        self._gap.drain_point()
        self._gap.publish()
        led = getattr(self, '_ledger', None)
        if led is not None:
            try:
                led.publish()
            except Exception:
                pass
        return drained

    def host_gap_snapshot(self):
        return self._gap.snapshot()


class DispatchWindow:
    """Bounded FIFO of in-flight AsyncResults: `push` waits on the oldest
    past `size`; drain order is submission order."""

    def __init__(self, size):
        self.size = max(int(size), 1)
        self._q = collections.deque()

    def __len__(self):
        return len(self._q)

    def push(self, result):
        self._q.append(result)
        while len(self._q) > self.size:
            self._q[0].wait()
            self._q.popleft()
        return result

    def flush(self):
        drained = []
        while self._q:
            self._q[0].wait()
            drained.append(self._q.popleft())
        return drained

    def clear(self):
        self._q.clear()


# ---------------------------------------------------------------------------
# host-gap observability
# ---------------------------------------------------------------------------
_monitors = {}          # site -> HostGapMonitor (latest per site wins)
_monitors_lock = threading.Lock()

# blocked-on-progress time reported by code that doesn't know which
# engine dispatches next on this thread (a loader's consumer-side queue
# wait: the transfer is in flight on the producer thread — a prefetch
# stall, not host gap). The next dispatch_begin on the same thread
# consumes it.
_tls = threading.local()


def note_external_blocked(seconds):
    _tls.blocked = getattr(_tls, 'blocked', 0.0) + max(float(seconds),
                                                       0.0)


def _take_external_blocked():
    v = getattr(_tls, 'blocked', 0.0)
    _tls.blocked = 0.0
    return v


class HostGapMonitor:
    """Rolling per-step dispatch timestamps for one engine site.

    The inter-dispatch span (dispatch_end(i) → dispatch_begin(i+1))
    decomposes into three attributed parts:

    * GATING time (`host_gap_seconds`): blocking waits on the NEWEST
      dispatched step — the synchronous discipline's fetch. Nothing is
      queued behind that step, so the device runs dry for the wait's
      tail plus all host work after it; this is exactly the
      serialization windowed dispatch eliminates, and it is measured
      from attributed call durations, so it stays deterministic even
      on a shared/1-core host where wall residue is scheduler noise.
    * BLOCKED time (`blocked_wait_seconds`): waits on OLDER steps (the
      windowed drain — newer steps remain enqueued as runway) and
      loader queue waits (the transfer is in flight on the producer
      thread). The
      device is busy throughout — not host gap.
    * RESIDUE (`host_residue_seconds`): the unattributed wall
      remainder — genuine per-step host work (batch feeds, python
      overhead) on a quiet multi-core host; on a shared single core it
      also absorbs OS starvation.

    step_i  = dispatch_begin(i+1) - dispatch_begin(i): the wall interval
              between submissions.
    host_bound_fraction = sum(gating) / sum(step intervals) over the
    rolling window — ~1.0 means every step serializes behind a host
    fetch (host-bound discipline), ~0.0 means the host always has the
    next step enqueued before the device needs it.
    """

    def __init__(self, site, window=64, clock=time.perf_counter):
        self.site = site
        self._clock = clock
        self._gaps = collections.deque(maxlen=window)       # gating
        self._residues = collections.deque(maxlen=window)
        self._intervals = collections.deque(maxlen=window)
        self._depths = collections.deque(maxlen=window)
        self._blocked = collections.deque(maxlen=window)
        self._blocked_since_end = 0.0
        self._gating_since_end = 0.0
        self._last_begin = None
        self._last_end = None
        self.steps = 0
        self.drained = 0
        self.dispatched_total = 0   # monotonic — AsyncResults key off it
        with _monitors_lock:
            _monitors[site] = self

    def reset(self):
        self._gaps.clear()
        self._residues.clear()
        self._intervals.clear()
        self._depths.clear()
        self._blocked.clear()
        self._blocked_since_end = 0.0
        self._gating_since_end = 0.0
        self._last_begin = None
        self._last_end = None
        self.steps = 0
        self.drained = 0

    def dispatch_begin(self):
        now = self._clock()
        blocked = self._blocked_since_end + _take_external_blocked()
        gating = self._gating_since_end
        if self._last_end is not None:
            raw = max(now - self._last_end, 0.0)
            self._gaps.append(gating)
            self._residues.append(max(raw - gating - blocked, 0.0))
            self._blocked.append(blocked)
        if self._last_begin is not None:
            self._intervals.append(max(now - self._last_begin, 0.0))
        self._last_begin = now
        return now

    def dispatch_end(self, depth=1):
        self._last_end = self._clock()
        self._blocked_since_end = 0.0
        self._gating_since_end = 0.0
        self._depths.append(int(depth))
        self.steps += 1
        self.dispatched_total += 1

    def note_blocked(self, seconds):
        """The host just spent `seconds` blocked on device progress the
        device had queued runway behind (windowed drain) — busy device,
        not host gap."""
        self._blocked_since_end += max(float(seconds), 0.0)

    def note_gating(self, seconds):
        """The host just spent `seconds` blocked on the NEWEST
        dispatched step (synchronous-discipline fetch): the device's
        queue is empty behind it — starvation exposure, counted as
        host gap."""
        self._gating_since_end += max(float(seconds), 0.0)

    def drain_point(self):
        """An explicit drain barrier (engine.flush / trial end): the
        waits it performed are deliberate, not inter-step host gap —
        consume the pending attributions so they can't leak into the
        NEXT dispatch's gap sample."""
        self._gating_since_end = 0.0
        self._blocked_since_end = 0.0
        _take_external_blocked()

    def step_ready(self):
        self.drained += 1

    # -- derived --------------------------------------------------------------
    def host_gap_seconds(self):
        return (sum(self._gaps) / len(self._gaps)) if self._gaps else 0.0

    def host_bound_fraction(self):
        total = sum(self._intervals)
        if not total:
            return None
        gaps = list(self._gaps)[-len(self._intervals):]
        return min(sum(gaps) / total, 1.0)

    def snapshot(self):
        depths = list(self._depths)
        return {
            'steps': self.steps,
            'drained': self.drained,
            'host_gap_seconds': self.host_gap_seconds(),
            'host_gap_seconds_max': max(self._gaps) if self._gaps else 0.0,
            'host_residue_seconds':
                (sum(self._residues) / len(self._residues))
                if self._residues else 0.0,
            'blocked_wait_seconds':
                (sum(self._blocked) / len(self._blocked))
                if self._blocked else 0.0,
            'step_interval_seconds':
                (sum(self._intervals) / len(self._intervals))
                if self._intervals else 0.0,
            'host_bound_fraction': self.host_bound_fraction(),
            'dispatch_depth_mean':
                (sum(depths) / len(depths)) if depths else 0.0,
            'dispatch_depth_max': max(depths) if depths else 0,
        }

    def publish(self):
        """Push the rolling view into core.monitor (the engines call
        this from flush(), never from the dispatch hot path)."""
        from . import monitor as _m
        snap = self.snapshot()
        _m.gauge('ptpu_host_gap_seconds',
                 help='rolling mean host gap between step dispatches',
                 labelnames=('site',)).set(snap['host_gap_seconds'],
                                           site=self.site)
        _m.gauge('ptpu_host_dispatch_depth',
                 help='rolling mean in-flight dispatched steps',
                 labelnames=('site',)).set(snap['dispatch_depth_mean'],
                                           site=self.site)
        if snap['host_bound_fraction'] is not None:
            _m.gauge('ptpu_host_bound_fraction',
                     help='host gap / step interval over the rolling '
                          'window (1.0 = host-bound)',
                     labelnames=('site',)).set(
                         snap['host_bound_fraction'], site=self.site)
        return snap


# ---------------------------------------------------------------------------
# prefetch totals (DeviceLoader reports here; StepTelemetry reads)
# ---------------------------------------------------------------------------
_prefetch = {'loaders': 0, 'batches': 0, 'stalls': 0, 'h2d_bytes': 0,
             'depth': None, 'ring_reuses': 0}
_prefetch_lock = threading.Lock()


def note_prefetch(loaders=0, batches=0, stalls=0, h2d_bytes=0,
                  depth=None, ring_reuses=0):
    with _prefetch_lock:
        _prefetch['loaders'] += loaders
        _prefetch['batches'] += batches
        _prefetch['stalls'] += stalls
        _prefetch['h2d_bytes'] += h2d_bytes
        _prefetch['ring_reuses'] += ring_reuses
        if depth is not None:
            _prefetch['depth'] = depth


def reset_prefetch_totals():
    with _prefetch_lock:
        _prefetch.update(loaders=0, batches=0, stalls=0, h2d_bytes=0,
                         depth=None, ring_reuses=0)


def host_snapshot():
    """The StepTelemetry.snapshot()['host'] payload: per-site dispatch
    gap/depth views and the DeviceLoader prefetch totals."""
    with _monitors_lock:
        sites = {site: mon.snapshot() for site, mon in _monitors.items()}
    with _prefetch_lock:
        prefetch = dict(_prefetch)
    return {'sites': sites, 'prefetch': prefetch}


def unregister_monitor(monitor):
    """Drop a shut-down engine's monitor from the registry (only if it
    is still the registered one for its site) so telemetry stops
    reporting a dead engine's rolling stats."""
    with _monitors_lock:
        if _monitors.get(monitor.site) is monitor:
            del _monitors[monitor.site]
