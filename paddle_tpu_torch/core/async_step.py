"""Asynchronous train steps — the subset of `paddle_tpu/core/async_step.py`
that the engines' `train_step` needs: `resolve_dispatch_window`
(:56-62), `AsyncResult` (:328-418), `AsyncDispatchMixin.flush` and
`DispatchWindow` (:421-483); an engine's `flush` drains its window.

A step's work is queued on the card's stream when `train_step` returns;
its `AsyncResult` holds the loss and the found-inf flag as device
tensors and a CUDA event recorded after the step's last launch. `wait()`
synchronises on that event (not a transfer) and then runs the step's
deferred drain work once (a GradScaler's found-inf accounting, applied
in drain order, :199-217 of paddle_tpu/amp); `result()` is the one host
fetch of the loss. On the CPU the step has finished when it returns,
and there is no event.

`HostGapMonitor` (:114 there) keeps rolling per-step dispatch
timestamps for one engine site and derives the host gap and the
`host_bound_fraction` (gating wait / step interval) the serving ledger
reports; the serving engine's gating wait is the time it spends in its
host fetch of chosen ids. `unregister_monitor` drops a shut-down
engine's monitor from the site registry.
"""
import collections
import os
import threading
import time

import torch

DEFAULT_DISPATCH_WINDOW = 2


def resolve_dispatch_window(window=None):
    """In-flight dispatch window: the kwarg, then `PTPU_DISPATCH_WINDOW`,
    then 2; clamped to at least 1."""
    if window is None:
        env = os.environ.get('PTPU_DISPATCH_WINDOW')
        try:
            window = int(env) if env else DEFAULT_DISPATCH_WINDOW
        except ValueError:
            window = DEFAULT_DISPATCH_WINDOW
    return max(int(window), 1)


class AsyncResult:
    """One dispatched train step: the fp32 loss on the device, no host
    fetch."""

    __slots__ = ('loss', 'step', 'found_inf', '_event', '_drained',
                 '_host_loss', '_staged', '_on_drain')

    def __init__(self, loss, step, staged=(), found_inf=None,
                 on_drain=None):
        """`staged`: host buffers the step's copies read, kept until the
        step drains; `found_inf`: the step's device flag (a nonfinite
        gradient skipped its update); `on_drain(result)`: run once when
        the step drains."""
        self.loss = loss
        self.step = step
        self.found_inf = found_inf
        self._on_drain = on_drain
        self._event = None
        if loss.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        self._drained = False
        self._host_loss = None
        self._staged = staged

    def done(self):
        """Whether the step was drained (waited on), as the reference's."""
        return self._drained

    def wait(self):
        """Block until the card finished this step."""
        if not self._drained:
            if self._event is not None:
                self._event.synchronize()
            self._drained = True
            self._staged = ()
            if self._on_drain is not None:
                drain, self._on_drain = self._on_drain, None
                drain(self)
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


def unregister_monitor(monitor):
    """Drop a shut-down engine's monitor from the registry (only if it
    is still the registered one for its site) so telemetry stops
    reporting a dead engine's rolling stats."""
    with _monitors_lock:
        if _monitors.get(monitor.site) is monitor:
            del _monitors[monitor.site]
