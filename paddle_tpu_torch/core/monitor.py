"""Runtime stats + metrics registry — counterpart of
`paddle_tpu/core/monitor.py`.

The legacy int/float `StatRegistry` (platform/monitor.h parity) and the
typed metrics layer beside it: `Counter` / `Gauge` / `Histogram` with
label support and a bucket-interpolated `percentile`, a Prometheus
text-exposition renderer, a JSON snapshot and an embeddable /metrics
HTTP endpoint (`MetricsServer`, started only when a caller asks). The
serving engine (`serving/metrics.py`, `serving/ledger.py`) and the host
tier publish here. Every observation stamps `last_update` from the
injectable clock `set_time_fn` swaps.

`enable_history` attaches a `core/timeseries.MetricHistory` to the
registry; `history_tick` is the piggyback hook the publish cadences call
(serving metrics publish, `StepTelemetry`), a no-op until then.
"""
import json
import threading
import time

# ---------------------------------------------------------------------------
# monotonic time source for staleness stamps
# ---------------------------------------------------------------------------
# Injectable so staleness tests run on a deterministic clock: every
# Counter/Gauge/Histogram observation stamps `last_update` from here.
_time_fn = time.monotonic


def set_time_fn(fn):
    """Swap the monotonic clock behind staleness stamps (None restores
    time.monotonic). Returns the previous fn
    so tests can restore it."""
    global _time_fn
    prev = _time_fn
    _time_fn = fn or time.monotonic
    return prev


def now():
    return _time_fn()


# ---------------------------------------------------------------------------
# legacy int/float stats (platform/monitor.h parity) — API unchanged
# ---------------------------------------------------------------------------
class Stat:
    __slots__ = ('name', '_value', '_lock')

    def __init__(self, name, value=0):
        self.name = name
        self._value = value
        self._lock = threading.Lock()

    def add(self, delta=1):
        with self._lock:
            self._value += delta
            return self._value

    def set(self, value):
        with self._lock:
            self._value = value

    def get(self):
        with self._lock:
            return self._value


class StatRegistry:
    """Parity: platform/monitor.h StatRegistry (singleton per value
    type; here one registry holds both int and float stats)."""

    def __init__(self):
        self._stats = {}
        self._lock = threading.Lock()

    def stat(self, name):
        with self._lock:
            s = self._stats.get(name)
            if s is None:
                s = self._stats[name] = Stat(name)
            return s

    def add(self, name, delta=1):
        return self.stat(name).add(delta)

    def set(self, name, value):
        self.stat(name).set(value)

    def get(self, name, default=0):
        with self._lock:
            s = self._stats.get(name)
        return s.get() if s is not None else default

    def snapshot(self):
        with self._lock:
            stats = list(self._stats.values())
        return {s.name: s.get() for s in stats}

    def reset(self):
        with self._lock:
            self._stats.clear()


_registry = StatRegistry()


def registry():
    return _registry


def stat_add(name, delta=1):
    return _registry.add(name, delta)


def stat_set(name, value):
    _registry.set(name, value)


def get_int_stats():
    """Parity: core.get_int_stats — integer-valued snapshot."""
    return {k: int(v) for k, v in _registry.snapshot().items()
            if isinstance(v, (int, bool))}


def get_stats():
    return _registry.snapshot()


# ---------------------------------------------------------------------------
# typed metrics: Counter / Gauge / Histogram with labels
# ---------------------------------------------------------------------------
DEFAULT_BUCKETS = (.0001, .0005, .001, .005, .01, .025, .05, .1, .25, .5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float('inf'))


def _label_key(labelnames, labels):
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class Metric:
    """One named metric; label-less use goes through the () label set."""

    kind = 'untyped'

    def __init__(self, name, help='', labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children = {}
        self._lock = threading.Lock()

    def _child(self, labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = self._children[key] = self._new_child()
            return c

    def labels(self, **labels):
        return self._child(labels)

    def _series(self):
        with self._lock:
            return dict(self._children)


class _CounterChild:
    __slots__ = ('_value', '_lock', 'last_update')

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()
        self.last_update = None     # monotonic stamp of the last publish

    def inc(self, value=1):
        if value < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += value
            self.last_update = _time_fn()
            return self._value

    def value(self):
        with self._lock:
            return self._value

    def age_s(self, now_=None):
        """Seconds since the last observation (None if never
        published) — the staleness signal that flags a series whose
        source engine went quiet."""
        with self._lock:
            if self.last_update is None:
                return None
            return (now_ if now_ is not None else _time_fn()) \
                - self.last_update


class Counter(Metric):
    kind = 'counter'
    _new_child = staticmethod(_CounterChild)

    def inc(self, value=1, **labels):
        return self._child(labels).inc(value)

    def value(self, **labels):
        return self._child(labels).value()


class _GaugeChild(_CounterChild):
    def inc(self, value=1):
        with self._lock:
            self._value += value
            self.last_update = _time_fn()
            return self._value

    def dec(self, value=1):
        return self.inc(-value)

    def set(self, value):
        with self._lock:
            self._value = float(value)
            self.last_update = _time_fn()


class Gauge(Metric):
    kind = 'gauge'
    _new_child = staticmethod(_GaugeChild)

    def set(self, value, **labels):
        self._child(labels).set(value)

    def inc(self, value=1, **labels):
        return self._child(labels).inc(value)

    def dec(self, value=1, **labels):
        return self._child(labels).dec(value)

    def value(self, **labels):
        return self._child(labels).value()


class _HistogramChild:
    __slots__ = ('buckets', 'counts', 'sum', 'count', '_lock',
                 'last_update')

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()
        self.last_update = None

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            self.last_update = _time_fn()
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1

    def age_s(self, now_=None):
        with self._lock:
            if self.last_update is None:
                return None
            return (now_ if now_ is not None else _time_fn()) \
                - self.last_update

    def value(self):
        with self._lock:
            return {'sum': self.sum, 'count': self.count,
                    'buckets': {str(b): c for b, c in
                                zip(self.buckets, self.counts)}}

    def percentile(self, q):
        """Bucket-interpolated quantile estimate (Prometheus
        histogram_quantile semantics): find the bucket holding the
        q-th observation and interpolate linearly inside it, assuming
        uniform spread. The +Inf bucket degrades to its lower bound —
        an estimator can't see past the last finite boundary. None
        when the histogram is empty."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile {q} not in [0, 100]")
        with self._lock:
            total = self.count
            if total == 0:
                return None
            counts = list(self.counts)      # cumulative (le semantics)
        # q=0 must land in the first OCCUPIED bucket (rank 0 would match
        # any empty leading bucket and report its upper bound)
        rank = max(q / 100.0 * total, 1e-12)
        for i, c in enumerate(counts):
            if c >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                if hi == float('inf'):
                    return lo
                below = counts[i - 1] if i > 0 else 0
                in_bucket = c - below
                if in_bucket <= 0:
                    return hi
                return lo + (hi - lo) * (rank - below) / in_bucket
        return self.buckets[-2] if len(self.buckets) > 1 else 0.0

    def percentiles(self, qs=(50, 90, 99)):
        return {f'p{g}': self.percentile(g) for g in qs}


class Histogram(Metric):
    kind = 'histogram'

    def __init__(self, name, help='', labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        b = sorted(float(x) for x in (buckets or DEFAULT_BUCKETS))
        if not b or b[-1] != float('inf'):
            b.append(float('inf'))
        self.buckets = tuple(b)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value, **labels):
        self._child(labels).observe(value)

    def value(self, **labels):
        return self._child(labels).value()

    def percentile(self, q, **labels):
        return self._child(labels).percentile(q)

    def percentiles(self, qs=(50, 90, 99), **labels):
        return self._child(labels).percentiles(qs)


class MetricsRegistry:
    """Get-or-create registry of typed metrics, renderable as Prometheus
    text exposition and as a JSON snapshot."""

    _KINDS = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()
        self.epoch = 0      # bumped on reset(); callers caching metric
                            # handles key their cache on this
        self.history = None     # MetricHistory once enable_history()

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help,
                                              labelnames=labelnames,
                                              **kwargs)
                return m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        if tuple(labelnames) != m.labelnames:
            raise ValueError(
                f"metric {name!r} labelnames {m.labelnames} != "
                f"{tuple(labelnames)}")
        return m

    def counter(self, name, help='', labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help='', labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help='', labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def metrics_list(self):
        """Stable copy of the registered metrics (no torn dict under
        concurrent creates)."""
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def reset(self):
        """Drop every metric (staleness stamps die with the children),
        bump the epoch so cached handles invalidate, and clear the
        history rings: old samples must not bleed across an epoch."""
        with self._lock:
            self._metrics.clear()
            self.epoch += 1
        if self.history is not None:
            self.history.clear()

    # -- metric history -------------------------------------------------------
    def enable_history(self, capacity=240, min_interval_s=0.0,
                       clock=None):
        """Opt-in per-series ring-buffer history. Idempotent: returns
        the existing MetricHistory when already enabled (capacity and
        clock of the first call win)."""
        if self.history is None:
            from . import timeseries
            self.history = timeseries.MetricHistory(
                self, capacity=capacity, min_interval_s=min_interval_s,
                clock=clock)
        return self.history

    def history_tick(self):
        """Piggyback hook for the existing publish cadences: sample the
        rings and run the attached alert evaluation (host metadata only),
        a no-op until enable_history()."""
        if self.history is not None:
            self.history.tick()

    # -- renderers -----------------------------------------------------------
    @staticmethod
    def _fmt_labels(labelnames, key, extra=()):
        pairs = [f'{n}="{_escape(v)}"' for n, v in zip(labelnames, key)]
        pairs.extend(f'{n}="{_escape(v)}"' for n, v in extra)
        return '{' + ','.join(pairs) + '}' if pairs else ''

    def prometheus_text(self, include_stats=True, include_age=False):
        """Prometheus text exposition format (0.0.4), legacy STAT_*
        stats included as untyped gauges. `include_age` appends one
        `# age ...` comment line per sample (scrapers ignore unknown
        comments) carrying the per-series staleness stamp — the
        operator-facing twin of snapshot()'s `age_s`."""
        lines = []
        t = _time_fn()
        metrics = self.metrics_list()
        for m in metrics:
            if m.help:
                lines.append(f'# HELP {m.name} {m.help}')
            lines.append(f'# TYPE {m.name} {m.kind}')
            for key, child in sorted(m._series().items()):
                if m.kind == 'histogram':
                    v = child.value()
                    for b, c in v['buckets'].items():
                        b = '+Inf' if b == 'inf' else b
                        lbl = self._fmt_labels(m.labelnames, key,
                                               extra=[('le', b)])
                        lines.append(f'{m.name}_bucket{lbl} {c}')
                    lbl = self._fmt_labels(m.labelnames, key)
                    lines.append(f'{m.name}_sum{lbl} {_num(v["sum"])}')
                    lines.append(f'{m.name}_count{lbl} {v["count"]}')
                else:
                    lbl = self._fmt_labels(m.labelnames, key)
                    lines.append(f'{m.name}{lbl} {_num(child.value())}')
                if include_age:
                    age = child.age_s(t)
                    if age is not None:
                        lbl = self._fmt_labels(m.labelnames, key)
                        lines.append(
                            f'# age {m.name}{lbl} {age:.3f}')
        if include_stats:
            for name, v in sorted(_registry.snapshot().items()):
                safe = _sanitize(name)
                lines.append(f'# TYPE {safe} gauge')
                lines.append(f'{safe} {_num(v)}')
        return '\n'.join(lines) + '\n'

    def snapshot(self):
        """JSON-ready nested snapshot: {metric: {kind, series: [{labels,
        value, age_s}]}} plus the legacy stats dict; when history is
        enabled, a downsampled `series` export of the rings rides
        along."""
        out = {}
        t = _time_fn()
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = []
            for key, child in sorted(m._series().items()):
                series.append({'labels': dict(zip(m.labelnames, key)),
                               'value': child.value(),
                               'age_s': child.age_s(t)})
            out[m.name] = {'kind': m.kind, 'series': series}
        snap = {'metrics': out, 'stats': _registry.snapshot()}
        if self.history is not None:
            snap['series'] = self.history.export()
        return snap

    def snapshot_json(self, **kwargs):
        return json.dumps(self.snapshot(), **kwargs)


def _escape(v):
    return str(v).replace('\\', r'\\').replace('"', r'\"').replace(
        '\n', r'\n')


def _num(v):
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _sanitize(name):
    return ''.join(c if c.isalnum() or c == '_' else '_' for c in name)


_metrics = MetricsRegistry()


def metrics():
    return _metrics


def counter(name, help='', labelnames=()):
    return _metrics.counter(name, help=help, labelnames=labelnames)


def gauge(name, help='', labelnames=()):
    return _metrics.gauge(name, help=help, labelnames=labelnames)


def histogram(name, help='', labelnames=(), buckets=None):
    return _metrics.histogram(name, help=help, labelnames=labelnames,
                              buckets=buckets)


def prometheus_text():
    return _metrics.prometheus_text()


def metrics_snapshot():
    return _metrics.snapshot()


# ---------------------------------------------------------------------------
# /metrics HTTP endpoint
# ---------------------------------------------------------------------------
class MetricsServer:
    """Tiny embeddable exporter: GET /metrics → Prometheus text, GET
    /metrics.json → JSON snapshot. Daemon-threaded; close() to stop."""

    def __init__(self, port=0, addr='127.0.0.1', registry=None):
        import http.server
        reg = registry or _metrics

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API name)
                if self.path.startswith('/metrics.json'):
                    body = reg.snapshot_json().encode()
                    ctype = 'application/json'
                elif self.path.startswith('/metrics'):
                    body = reg.prometheus_text().encode()
                    ctype = 'text/plain; version=0.0.4; charset=utf-8'
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer((addr, port), Handler)
        self.addr, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_metrics_server(port=0, addr='127.0.0.1'):
    return MetricsServer(port=port, addr=addr)
