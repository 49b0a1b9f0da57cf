"""Declarative alert rules over metric history rings — counterpart of
`paddle_tpu/core/alerts.py`.

`AlertRule` declares a predicate over one metric's history (threshold /
windowed delta / rate-of-change / cross-series spread / EWMA-relative
drop / publish staleness), with a `for_s` sustain bound and a hysteretic
clear, and `AlertManager` runs a set of rules against a `MetricHistory`
(core/timeseries.py) on every `tick()`.

State machine per rule (deterministic on the injected clock):

    ok --breach--> pending --sustained for_s--> firing
    firing --clear-condition held clear_for_s--> ok (resolved)

A rule with `clear_value` clears on a SEPARATE (easier) threshold than
it fired on, so a signal oscillating around the bound does not flap.

Each transition emits a structured `log_util.log_json` record and a
flight-recorder journal entry, bumps `ptpu_alert_fired_total` /
`ptpu_alert_resolved_total`, flips `ptpu_alert_active{rule,severity}`,
and rewrites the capped `alert_report` artifact when a report dir is
configured.

`default_rules()` is the engine-scope pack; `router_rules()` the
cluster-scope pack over a federated registry (its `ptpu_cluster_*` and
`ptpu_route_*` series come with the multi-card router).
"""
import json
import os
import threading

from . import monitor as _mon

SEVERITIES = ('info', 'warn', 'critical')

_OPS = {
    '>': lambda a, b: a > b,
    '>=': lambda a, b: a >= b,
    '<': lambda a, b: a < b,
    '<=': lambda a, b: a <= b,
}


class AlertRule:
    """One declarative watch over a metric's history.

    kind:
      threshold  last value `op` value (any series of the metric)
      delta      windowed increment >= value (counters: storms)
      rate       per-second slope `op` value over window_s
      spread     max(last) - min(last) across series >= value
                 (cluster imbalance; needs >= 2 series)
      ewma_drop  last < value * EWMA(tau_s) — relative regression
                 against the series' own trend (value is a fraction)
      staleness  publish-stamp age of every series > value seconds
                 (the source engine went quiet)
      predicate  fn(history, now) -> truthy breach value (escape
                 hatch for composite conditions)

    `for_s` is the sustain bound before firing; `clear_for_s`
    (default: for_s) how long the clear condition must hold;
    `clear_value` an optional hysteretic clear threshold.
    """

    def __init__(self, name, metric=None, kind='threshold', op='>',
                 value=None, for_s=0.0, clear_value=None,
                 clear_for_s=None, window_s=60.0, tau_s=30.0,
                 severity='warn', description='', labels=None,
                 predicate=None, min_points=2):
        if severity not in SEVERITIES:
            raise ValueError(f"severity {severity!r} not in "
                             f"{SEVERITIES}")
        if kind != 'predicate' and metric is None:
            raise ValueError(f"rule {name!r}: metric required")
        if kind == 'predicate' and predicate is None:
            raise ValueError(f"rule {name!r}: predicate fn required")
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: unknown op {op!r}")
        self.name = name
        self.metric = metric
        self.kind = kind
        self.op = op
        self.value = value
        self.for_s = float(for_s)
        self.clear_value = clear_value
        self.clear_for_s = (float(clear_for_s) if clear_for_s
                            is not None else self.for_s)
        self.window_s = float(window_s)
        self.tau_s = float(tau_s)
        self.severity = severity
        self.description = description
        self.labels = dict(labels) if labels else None
        self.predicate = predicate
        self.min_points = int(min_points)

    # -- evaluation ----------------------------------------------------------
    def _series(self, history):
        rows = history.iter_series(self.metric)
        if self.labels is not None:
            want = tuple(str(v) for _k, v in
                         sorted(self.labels.items()))
            rows = [(k, p) for k, p in rows if k == want]
        return rows

    def check(self, history, now, threshold=None):
        """(breach, info) for the firing condition — or, with
        `threshold`, for an alternate bound (the manager passes
        `clear_value` here to test the hysteretic clear)."""
        if self.kind == 'predicate':
            v = self.predicate(history, now)
            return bool(v), {'value': v if not isinstance(v, bool)
                             else None, 'series': None}
        bound = self.value if threshold is None else threshold
        cmp = _OPS[self.op]
        worst = None
        if self.kind == 'threshold':
            for key, pts in self._series(history):
                if not pts:
                    continue
                v = pts[-1][1]
                if cmp(v, bound) and (
                        worst is None or abs(v) > abs(worst[1])):
                    worst = (key, v)
        elif self.kind == 'delta':
            for key, pts in self._series(history):
                if len(pts) < 2:
                    continue
                t0 = now - self.window_s
                base = None
                for pt, pv in pts:
                    if pt <= t0:
                        base = pv
                    else:
                        break
                if base is None:
                    base = pts[0][1]
                d = pts[-1][1] - base
                if d >= bound and (worst is None or d > worst[1]):
                    worst = (key, d)
        elif self.kind == 'rate':
            for key, pts in self._series(history):
                if len(pts) < self.min_points:
                    continue
                t0 = now - self.window_s
                base_t, base_v = pts[0]
                for pt, pv in pts:
                    if pt <= t0:
                        base_t, base_v = pt, pv
                    else:
                        break
                span = pts[-1][0] - base_t
                if span <= 0:
                    continue
                r = (pts[-1][1] - base_v) / span
                if cmp(r, bound) and (
                        worst is None or abs(r) > abs(worst[1])):
                    worst = (key, r)
        elif self.kind == 'spread':
            lasts = [(k, p[-1][1]) for k, p in self._series(history)
                     if p]
            if len(lasts) >= 2:
                vals = [v for _k, v in lasts]
                spread = max(vals) - min(vals)
                if spread >= bound:
                    hi = max(lasts, key=lambda kv: kv[1])
                    worst = (hi[0], spread)
        elif self.kind == 'ewma_drop':
            import math
            for key, pts in self._series(history):
                if len(pts) < max(self.min_points, 3):
                    continue
                acc = pts[0][1]
                for (ta, _va), (tb, vb) in zip(pts, pts[1:]):
                    dt = max(tb - ta, 0.0)
                    alpha = 1.0 - math.exp(
                        -dt / max(self.tau_s, 1e-9))
                    acc += alpha * (vb - acc)
                if acc <= 0:
                    continue
                frac = pts[-1][1] / acc
                if frac < bound and (
                        worst is None or frac < worst[1]):
                    worst = (key, frac)
        elif self.kind == 'staleness':
            m = history.registry.get(self.metric)
            if m is not None:
                ages = [(key, child.age_s(now))
                        for key, child in m._series().items()]
                ages = [(k, a) for k, a in ages if a is not None]
                if ages:
                    k, a = max(ages, key=lambda ka: ka[1])
                    if a > bound:
                        worst = (k, a)
        else:
            raise ValueError(f"unknown rule kind {self.kind!r}")
        if worst is None:
            return False, {'value': None, 'series': None}
        key, v = worst
        return True, {'value': v,
                      'series': list(key) if key else None}

    def clear_check(self, history, now):
        """True while the CLEAR condition holds (i.e. the firing
        condition — against clear_value when set — is false)."""
        if self.kind == 'predicate' or self.clear_value is None:
            breach, _ = self.check(history, now)
            return not breach
        breach, _ = self.check(history, now,
                               threshold=self.clear_value)
        return not breach

    def describe(self):
        return {'rule': self.name, 'metric': self.metric,
                'kind': self.kind, 'op': self.op, 'value': self.value,
                'for_s': self.for_s, 'clear_value': self.clear_value,
                'clear_for_s': self.clear_for_s,
                'window_s': self.window_s,
                'severity': self.severity,
                'description': self.description}


class _RuleState:
    __slots__ = ('state', 'pending_since', 'firing_since',
                 'clear_since', 'fired', 'last_value', 'last_series')

    def __init__(self):
        self.state = 'ok'
        self.pending_since = None
        self.firing_since = None
        self.clear_since = None
        self.fired = 0
        self.last_value = None
        self.last_series = None


class AlertManager:
    """Evaluate a rule set against a MetricHistory.

    Attaches itself to the history's tick loop (detach() to stop).
    Alert gauges/counters land in `registry` (default: the
    process-global monitor registry) so any scrape sees them even
    when the history runs over a private registry (the router's
    federated one).
    """

    MAX_EVENTS = 128

    def __init__(self, history, rules=None, clock=None, registry=None,
                 source='engine', report_dir=None, attach=True):
        self.history = history
        self.rules = list(rules if rules is not None
                          else default_rules())
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self._clock = clock or history._clock
        self.registry = registry or _mon.metrics()
        self.source = source
        self.report_dir = (report_dir
                           or os.environ.get('PTPU_SERVE_REPORT_DIR')
                           or os.environ.get('FLEET_LOG_DIR'))
        self.last_report_path = None
        self._states = {r.name: _RuleState() for r in self.rules}
        self._events = []
        self._evals = 0
        self._lock = threading.Lock()
        if attach:
            history.attach(self)

    def detach(self):
        self.history.detach(self)

    # -- the state machine ---------------------------------------------------
    def evaluate(self, now=None):
        """One pass over every rule; returns the list of transition
        events this pass produced."""
        t = self._clock() if now is None else now
        transitions = []
        with self._lock:
            self._evals += 1
            for rule in self.rules:
                st = self._states[rule.name]
                if st.state in ('ok', 'pending'):
                    breach, info = rule.check(self.history, t)
                    if breach:
                        st.last_value = info['value']
                        st.last_series = info['series']
                        if st.state == 'ok':
                            st.state = 'pending'
                            st.pending_since = t
                        if t - st.pending_since >= rule.for_s:
                            st.state = 'firing'
                            st.firing_since = t
                            st.clear_since = None
                            st.fired += 1
                            transitions.append(
                                self._event('fired', rule, st, t))
                    else:
                        st.state = 'ok'
                        st.pending_since = None
                else:   # firing: watch the hysteretic clear
                    if rule.clear_check(self.history, t):
                        if st.clear_since is None:
                            st.clear_since = t
                        if t - st.clear_since >= rule.clear_for_s:
                            st.state = 'ok'
                            st.pending_since = None
                            st.firing_since = None
                            st.clear_since = None
                            transitions.append(
                                self._event('resolved', rule, st, t))
                    else:
                        st.clear_since = None
                        breach, info = rule.check(self.history, t)
                        if breach:
                            st.last_value = info['value']
                            st.last_series = info['series']
        for ev in transitions:
            self._emit(ev)
        return transitions

    def _event(self, what, rule, st, t):
        return {'event': what, 'rule': rule.name,
                'severity': rule.severity, 't': t,
                'value': st.last_value, 'series': st.last_series,
                'metric': rule.metric, 'source': self.source,
                'description': rule.description}

    def _emit(self, ev):
        """Everything a transition owes the observatory: events ring,
        gauges, structured log, flight-recorder journal, artifact."""
        self._events.append(ev)
        del self._events[:-self.MAX_EVENTS]
        active = 1 if ev['event'] == 'fired' else 0
        self.registry.gauge(
            'ptpu_alert_active',
            help='1 while the rule is firing, 0 otherwise',
            labelnames=('rule', 'severity')).set(
            active, rule=ev['rule'], severity=ev['severity'])
        counter = ('ptpu_alert_fired_total' if ev['event'] == 'fired'
                   else 'ptpu_alert_resolved_total')
        self.registry.counter(
            counter,
            help=f'alert rules {ev["event"]} (lifetime)',
            labelnames=('rule', 'severity')).inc(
            rule=ev['rule'], severity=ev['severity'])
        try:
            from ..distributed import flight_recorder as _fr
            seq = _fr.recorder().record_enqueue(
                f'alert_{ev["event"]}:{ev["rule"]}')
            _fr.recorder().record_complete(seq)
        except Exception:                   # noqa: BLE001
            pass
        try:
            from ..distributed.fleet.utils.log_util import log_json
            log_json('alert_' + ev['event'],
                     level=('error' if ev['severity'] == 'critical'
                            and ev['event'] == 'fired' else 'info'),
                     msg=f"alert {ev['rule']} {ev['event']} "
                         f"({ev['severity']}): {ev['description']}",
                     **{k: v for k, v in ev.items()
                        if k not in ('event', 'description')})
        except Exception:                   # noqa: BLE001
            pass
        self._write_report()

    # -- views / artifact ----------------------------------------------------
    def active(self):
        with self._lock:
            return [{'rule': r.name, 'severity': r.severity,
                     'since': self._states[r.name].firing_since,
                     'value': self._states[r.name].last_value,
                     'series': self._states[r.name].last_series,
                     'description': r.description}
                    for r in self.rules
                    if self._states[r.name].state == 'firing']

    def snapshot(self):
        """JSON-ready view for health_dump alerts / bench records:
        per-rule state table + the capped transition ring."""
        with self._lock:
            rules = []
            for r in self.rules:
                st = self._states[r.name]
                rules.append(dict(r.describe(), state=st.state,
                                  fired=st.fired,
                                  last_value=st.last_value,
                                  last_series=st.last_series))
            return {'source': self.source, 'evals': self._evals,
                    'rules': rules, 'events': list(self._events)}

    def summary(self):
        """The compact block bench legs record: counts by severity so
        _check_legs can assert 'no critical alert fired' cheaply."""
        with self._lock:
            fired = {}
            for ev in self._events:
                if ev['event'] == 'fired':
                    fired[ev['severity']] = \
                        fired.get(ev['severity'], 0) + 1
            return {
                'rules': len(self.rules),
                'evals': self._evals,
                'fired_total': sum(fired.values()),
                'fired_critical': fired.get('critical', 0),
                'fired_by_severity': fired,
                'active': [r.name for r in self.rules
                           if self._states[r.name].state == 'firing'],
            }

    def report(self):
        """The alert_report artifact doc (capped): every transition in
        the ring plus the current rule table."""
        return {'kind': 'alert_report', 'source': self.source,
                'max_events': self.MAX_EVENTS, **self.snapshot()}

    def _write_report(self):
        if not self.report_dir:
            return
        try:
            os.makedirs(self.report_dir, exist_ok=True)
            path = os.path.join(self.report_dir,
                                f'alert_report.{self.source}.json')
            with open(path, 'w') as f:
                json.dump(self.report(), f, indent=1, default=str)
            self.last_report_path = path
        except OSError:
            pass


# ---------------------------------------------------------------------------
# built-in rule packs
# ---------------------------------------------------------------------------
def default_rules(host_bound=0.6, pool_high=0.97, pool_clear=0.8,
                  tps_drop_frac=0.5, degrade_stage=2,
                  goodput_floor=0.8, stale_s=30.0, for_s=2.0):
    """Engine-scope pack over the serving, ledger and straggler signals.
    Thresholds are keyword-tunable; the defaults are documented in
    docs/observability.md#time-series--alerts."""
    return [
        AlertRule('host_bound',
                  metric='ptpu_serve_ledger_host_bound_fraction',
                  op='>', value=host_bound, for_s=for_s,
                  severity='warn',
                  description='decode iterations dominated by host '
                              'gaps — the multi-token-dispatch '
                              'ROADMAP item is being paid for'),
        AlertRule('kv_pool_pressure',
                  metric='ptpu_serve_kv_page_utilization',
                  op='>=', value=pool_high, clear_value=pool_clear,
                  for_s=for_s, severity='critical',
                  description='KV pool occupancy ~1: admissions '
                              'spill/preempt; degrade ladder or '
                              'host-tier spill imminent'),
        AlertRule('decode_tps_drop', kind='ewma_drop',
                  metric='ptpu_serve_decode_tokens_per_sec',
                  value=tps_drop_frac, tau_s=30.0, for_s=for_s,
                  severity='warn',
                  description='decode tokens/sec fell below '
                              f'{tps_drop_frac:.0%} of its own EWMA '
                              'trend'),
        AlertRule('degrade_stage',
                  metric='ptpu_serve_degrade_stage',
                  op='>=', value=float(degrade_stage),
                  clear_value=float(degrade_stage) - 1.0,
                  for_s=for_s, severity='critical',
                  description='graceful-degradation ladder at '
                              'prefill-shrink or weighted-eviction '
                              'stage, sustained'),
        AlertRule('goodput_drop',
                  metric='ptpu_serve_goodput_fraction',
                  op='<', value=goodput_floor, for_s=for_s,
                  severity='warn',
                  description='delivered/emitted token fraction '
                              'below floor — aborts, preemption '
                              'recompute or spec overdraft dominate'),
        AlertRule('straggler_events', kind='delta',
                  metric='ptpu_straggler_events_total',
                  value=1.0, window_s=60.0, for_s=0.0,
                  severity='warn',
                  description='a rank exceeded the straggler '
                              'relative-wall bound in the window'),
        AlertRule('metrics_stale', kind='staleness',
                  metric='ptpu_serve_decode_tokens_per_sec',
                  value=stale_s, for_s=0.0, severity='info',
                  description='the serving engine stopped publishing '
                              '— stats below this age are a dead '
                              'signal'),
    ]


def router_rules(beat_stale_s=5.0, pool_high=0.95, pool_clear=0.75,
                 pool_for_s=1.0, imbalance=0.5, drains_per_min=2.0,
                 resubmits_per_min=8.0, spills_per_min=30.0):
    """Cluster-scope pack the router evaluates over its federated
    registry (every series carries a `replica` label there). The
    heartbeat bound should sit WELL UNDER the router's own
    hang_timeout_s so the alert precedes the drain."""
    return [
        AlertRule('replica_heartbeat_stale',
                  metric='ptpu_cluster_replica_beat_age_seconds',
                  op='>', value=beat_stale_s,
                  clear_value=beat_stale_s / 2.0,
                  for_s=0.0, severity='critical',
                  description='a replica step-loop heartbeat went '
                              'stale — precedes the watchdog drain'),
        AlertRule('cluster_pool_pressure',
                  metric='ptpu_serve_kv_page_utilization',
                  op='>=', value=pool_high, clear_value=pool_clear,
                  for_s=pool_for_s, severity='critical',
                  description='a replica KV pool is saturated under '
                              'load (spills/preemptions follow) — '
                              'the autoscaler grow signal'),
        AlertRule('occupancy_imbalance', kind='spread',
                  metric='ptpu_cluster_replica_occupancy',
                  value=imbalance, for_s=5.0, severity='warn',
                  description='decode-slot occupancy spread across '
                              'replicas — affinity skew or a slow '
                              'replica'),
        AlertRule('drain_storm', kind='delta',
                  metric='ptpu_route_drains_total',
                  value=drains_per_min, window_s=60.0, for_s=0.0,
                  severity='critical',
                  description='multiple replicas drained within a '
                              'minute — correlated failure, not one '
                              'bad host'),
        AlertRule('resubmit_storm', kind='delta',
                  metric='ptpu_route_resubmits_total',
                  value=resubmits_per_min, window_s=60.0, for_s=0.0,
                  severity='warn',
                  description='drain resubmissions moving significant '
                              'in-flight work between replicas'),
        AlertRule('spill_rate', kind='delta',
                  metric='ptpu_route_spills_total',
                  value=spills_per_min, window_s=60.0, for_s=0.0,
                  severity='warn',
                  description='affinity placements diverted by '
                              'backpressure — prefix locality is '
                              'being destroyed by load'),
    ]
