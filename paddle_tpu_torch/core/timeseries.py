"""Metric history rings — counterpart of `paddle_tpu/core/timeseries.py`.

Every subsystem publishes point-in-time `ptpu_*` gauges; this module
keeps their HISTORY. `MetricHistory` is an opt-in sampler over a
`MetricsRegistry` (monitor.MetricsRegistry.enable_history): each
`sample()` appends one `(t, value)` point per counter/gauge series
(histograms contribute their `_count`/`_sum` streams) into a bounded
per-series ring, so memory is O(series x capacity).

Cadence: callers piggyback `tick()` on the cadences that already exist
— the serving engine's metric publish and the profiler's step-telemetry
publish — plus an optional low-rate background thread
(`start_background`) for idle processes. Sampling reads only the
host-side floats the publishers already wrote: no device work and no
host sync.

Derived views (`rate`, `delta`, `ewma`, `window`, `sustained`) are what
the alert rules (core/alerts.py) consume. `export()` is the downsampled
JSON block a run's record carries; `sparkline()` renders a ring.

The clock is injectable (defaults to monitor's, which tests swap via
monitor.set_time_fn) so fire -> sustain -> clear walks are
deterministic.
"""
import collections
import threading

from . import monitor as _mon

_SPARK_BARS = '▁▂▃▄▅▆▇█'


def series_key(name, labels=()):
    """Canonical string key for one series: `name` or
    `name{k="v",...}` with labels sorted by name — stable across
    processes, parseable by the health_dump renderer."""
    if not labels:
        return name
    inner = ','.join(f'{k}="{v}"' for k, v in sorted(labels))
    return name + '{' + inner + '}'


def sparkline(values, width=24):
    """Unicode sparkline of a value sequence, downsampled to `width`
    columns (empty string for no data; flat series render mid-bar)."""
    vals = [float(v) for v in values]
    if not vals:
        return ''
    if len(vals) > width:
        stride = len(vals) / float(width)
        vals = [vals[min(int(i * stride), len(vals) - 1)]
                for i in range(width - 1)] + [vals[-1]]
    lo, hi = min(vals), max(vals)
    if hi - lo <= 1e-12:
        return _SPARK_BARS[3] * len(vals)
    span = hi - lo
    return ''.join(
        _SPARK_BARS[min(int((v - lo) / span * 8), 7)] for v in vals)


class _Ring:
    """One bounded (t, value) history. Appends and reads are guarded
    by the owning MetricHistory's lock."""

    __slots__ = ('points', 'kind')

    def __init__(self, capacity, kind):
        self.points = collections.deque(maxlen=capacity)
        self.kind = kind


class MetricHistory:
    """Per-series ring-buffer history over one MetricsRegistry.

    `sample()` walks the registry; `tick()` is the piggyback entry
    (rate-limited by `min_interval_s`, then runs attached
    AlertManagers). All views take (name, labels=None); with labels
    None a single-series metric resolves implicitly and a multi-series
    one must be addressed by its labels dict.
    """

    def __init__(self, registry, capacity=240, min_interval_s=0.0,
                 clock=None):
        self.registry = registry
        self.capacity = int(capacity)
        if self.capacity < 2:
            raise ValueError("history needs capacity >= 2")
        self.min_interval_s = float(min_interval_s)
        self._clock = clock or _mon.now
        self._lock = threading.Lock()
        self._rings = {}            # (name, labelkey) -> _Ring
        self._epoch = registry.epoch
        self._samples = 0
        self._last_sample_t = None
        self._managers = []         # AlertManagers run by tick()
        self._bg = None
        self._bg_stop = None

    # -- sampling ------------------------------------------------------------
    def sample(self, now=None):
        """Record one point per series. O(live series); reads only the
        host-side values the publishers already wrote."""
        t = self._clock() if now is None else now
        if self.registry.epoch != self._epoch:
            self.clear()
        rows = []                   # gather outside our lock
        for m in self.registry.metrics_list():
            for key, child in m._series().items():
                if m.kind == 'histogram':
                    v = child.value()
                    rows.append(((m.name + '_count', key), 'counter',
                                 float(v['count'])))
                    rows.append(((m.name + '_sum', key), 'counter',
                                 float(v['sum'])))
                else:
                    rows.append(((m.name, key), m.kind,
                                 float(child.value())))
        with self._lock:
            for (name, key), kind, v in rows:
                ring = self._rings.get((name, key))
                if ring is None:
                    ring = self._rings[(name, key)] = _Ring(
                        self.capacity, kind)
                ring.points.append((t, v))
            self._samples += 1
            self._last_sample_t = t
            n_series = len(self._rings)
            n_points = sum(len(r.points) for r in self._rings.values())
        # self-observability (next sample picks these up): how much
        # the time axis itself costs
        self.registry.counter(
            'ptpu_ts_samples_total',
            help='history sampler passes over the registry').inc()
        self.registry.gauge(
            'ptpu_ts_series_tracked',
            help='series with a live history ring').set(n_series)
        self.registry.gauge(
            'ptpu_ts_points_retained',
            help='(t, value) points currently held across all '
                 'rings').set(n_points)
        self.registry.gauge(
            'ptpu_ts_ring_capacity',
            help='per-series ring capacity (memory bound = series x '
                 'capacity points)').set(self.capacity)
        return t

    def tick(self):
        """Rate-limited sample + alert evaluation — the piggyback
        entry for existing publish cadences. Returns the alert
        transitions this pass produced (empty when quiet)."""
        t = self._clock()
        if (self._last_sample_t is None
                or t - self._last_sample_t >= self.min_interval_s):
            self.sample(now=t)
        events = []
        for mgr in list(self._managers):
            events.extend(mgr.evaluate(now=t) or ())
        return events

    def attach(self, manager):
        if manager not in self._managers:
            self._managers.append(manager)

    def detach(self, manager):
        if manager in self._managers:
            self._managers.remove(manager)

    def clear(self):
        with self._lock:
            self._rings.clear()
        self._epoch = self.registry.epoch
        self._last_sample_t = None

    # -- background tick (idle processes without a publish cadence) ----------
    def start_background(self, interval_s=5.0):
        """Low-rate daemon tick for processes with no natural publish
        cadence. Idempotent; `stop_background()` joins it."""
        if self._bg is not None:
            return self._bg
        self._bg_stop = threading.Event()

        def _loop():
            while not self._bg_stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:           # noqa: BLE001
                    pass                    # observability never kills

        self._bg = threading.Thread(target=_loop, name='metric-history',
                                    daemon=True)
        self._bg.start()
        return self._bg

    def stop_background(self):
        if self._bg is None:
            return
        self._bg_stop.set()
        self._bg.join(timeout=5)
        self._bg = None
        self._bg_stop = None

    # -- series access -------------------------------------------------------
    def series_names(self):
        with self._lock:
            return sorted({name for name, _k in self._rings})

    def label_keys(self, name):
        with self._lock:
            return sorted(k for n, k in self._rings if n == name)

    def points(self, name, labels=None):
        """The (t, value) list for one series (oldest first); [] when
        the series has no ring yet."""
        ring = self._resolve(name, labels)
        if ring is None:
            return []
        with self._lock:
            return list(ring.points)

    def iter_series(self, name):
        """[(raw_label_key_tuple, points), ...] for every series of
        `name` — the rules engine evaluates label-agnostic rules over
        all of a metric's series (worst series wins)."""
        with self._lock:
            return [(k, list(r.points))
                    for (n, k), r in sorted(self._rings.items())
                    if n == name]

    def _resolve(self, name, labels):
        with self._lock:
            if labels is not None:
                key = tuple(str(v) for _k, v in sorted(labels.items()))
                return self._rings.get((name, key))
            hits = [(k, r) for (n, k), r in self._rings.items()
                    if n == name]
        if not hits:
            return None
        if len(hits) > 1:
            raise ValueError(
                f"{name} has {len(hits)} labeled series — pass "
                f"labels= (keys: {[k for k, _r in hits]})")
        return hits[0][1]

    # -- derived views -------------------------------------------------------
    def last(self, name, labels=None):
        pts = self.points(name, labels)
        return pts[-1][1] if pts else None

    def delta(self, name, window_s, labels=None, now=None):
        """value(now) - value(entering the trailing window). None
        until two points exist. For counters this is the windowed
        increment; for gauges the net movement."""
        pts = self.points(name, labels)
        if len(pts) < 2:
            return None
        t = (self._clock() if now is None else now)
        t0 = t - float(window_s)
        base = None
        for pt, pv in pts:
            if pt <= t0:
                base = pv
            else:
                break
        if base is None:
            base = pts[0][1]
        return pts[-1][1] - base

    def rate(self, name, window_s, labels=None, now=None):
        """Per-second slope over the trailing window (delta over the
        ACTUAL covered span, not the nominal window). None until two
        points exist or the span is zero."""
        pts = self.points(name, labels)
        if len(pts) < 2:
            return None
        t = (self._clock() if now is None else now)
        t0 = t - float(window_s)
        base_t, base_v = pts[0]
        for pt, pv in pts:
            if pt <= t0:
                base_t, base_v = pt, pv
            else:
                break
        span = pts[-1][0] - base_t
        if span <= 0:
            return None
        return (pts[-1][1] - base_v) / span

    def ewma(self, name, tau_s, labels=None):
        """Time-weighted exponential moving average over the whole
        ring (alpha per step = 1 - exp(-dt/tau)): the trend baseline
        the decode-throughput-drop rule compares against."""
        import math
        pts = self.points(name, labels)
        if not pts:
            return None
        acc = pts[0][1]
        for (t0, _v0), (t1, v1) in zip(pts, pts[1:]):
            dt = max(t1 - t0, 0.0)
            alpha = 1.0 - math.exp(-dt / max(float(tau_s), 1e-9))
            acc += alpha * (v1 - acc)
        return acc

    def window(self, name, window_s, labels=None, now=None):
        """mean/min/max/n over the trailing window (None-able)."""
        pts = self.points(name, labels)
        t = (self._clock() if now is None else now)
        t0 = t - float(window_s)
        vals = [v for pt, v in pts if pt >= t0]
        if not vals:
            return {'mean': None, 'min': None, 'max': None, 'n': 0}
        return {'mean': sum(vals) / len(vals), 'min': min(vals),
                'max': max(vals), 'n': len(vals)}

    def sustained(self, name, pred, for_s, labels=None, now=None):
        """True iff `pred(value)` held for the ENTIRE trailing `for_s`
        window: every sample inside the window satisfies it, the value
        held entering the window satisfies it, and the ring actually
        covers the window (no vacuous truth on a series younger than
        the sustain bound)."""
        pts = self.points(name, labels)
        if not pts:
            return False
        t = (self._clock() if now is None else now)
        t0 = t - float(for_s)
        entering = None
        covered = False
        for pt, pv in pts:
            if pt <= t0:
                entering = pv
                covered = True
            elif not pred(pv):
                return False
        if not covered:
            return False
        return pred(entering)

    def age_s(self, name, labels=None, now=None):
        """Seconds since this series was last SAMPLED (ring view; the
        registry's per-child `age_s` is the publish-side stamp)."""
        pts = self.points(name, labels)
        if not pts:
            return None
        return (self._clock() if now is None else now) - pts[-1][0]

    # -- export / rendering --------------------------------------------------
    def export(self, max_points=32, names=None):
        """Downsampled JSON-ready dump: {series_key: {kind, t: [...],
        v: [...], last, min, max}} — the block bench legs record and
        health_dump sparklines render. Timestamps are relative to the
        newest sample (small, diff-friendly numbers)."""
        with self._lock:
            items = sorted(self._rings.items())
            snap = [((n, k), r.kind, list(r.points)) for (n, k), r
                    in items]
        label_names = self._export_label_names()
        out = {}
        for (name, key), kind, pts in snap:
            if names is not None and name not in names:
                continue
            if not pts:
                continue
            if len(pts) > max_points:
                stride = len(pts) / float(max_points)
                pts = [pts[min(int(i * stride), len(pts) - 1)]
                       for i in range(max_points - 1)] + [pts[-1]]
            t_end = pts[-1][0]
            vals = [v for _t, v in pts]
            lnames = label_names.get(name, ())
            out[series_key(name, tuple(zip(lnames, key)))] = {
                'kind': kind,
                't': [round(t - t_end, 3) for t, _v in pts],
                'v': [round(v, 6) for v in vals],
                'last': vals[-1], 'min': min(vals), 'max': max(vals),
            }
        return out

    def _export_label_names(self):
        """metric name -> labelnames, for rendering label keys in
        export(). Histogram-derived `_count`/`_sum` series inherit the
        parent metric's labelnames."""
        names = {}
        for m in self.registry.metrics_list():
            names[m.name] = m.labelnames
            if m.kind == 'histogram':
                names[m.name + '_count'] = m.labelnames
                names[m.name + '_sum'] = m.labelnames
        return names

    def sparkline(self, name, labels=None, width=24):
        return sparkline([v for _t, v in self.points(name, labels)],
                         width=width)

    def snapshot(self):
        """Sampler health view (health_dump / bench): counts only,
        never the raw rings."""
        with self._lock:
            return {
                'capacity': self.capacity,
                'samples': self._samples,
                'series': len(self._rings),
                'points': sum(len(r.points)
                              for r in self._rings.values()),
                'last_sample_t': self._last_sample_t,
            }
