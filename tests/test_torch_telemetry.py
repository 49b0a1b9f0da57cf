"""The port's telemetry against the JAX package's, on the CPU: the same
inputs, made from a numpy seed, and the same injected clock go through
both packages.

- Metric history (core/timeseries.py): points, `delta`, `rate`, `ewma`,
  `window`, `sustained`, `export` and the sampler's own gauges equal the
  reference's; the registry's history hooks and `reset`.
- Alerts (core/alerts.py): the default and router packs fire and clear
  the same events over the same history; rule validation.
- The step ledger (core/ledger.py): `StepLedger.account` gives the same
  components and FLOPs from the same gap snapshot and hints; the
  published gauges read back; the straggler check at world size 1.
- The flight recorder: `dump` and `analyze` give the same documents;
  the hang watchdog's local dump, driven by its clock, not by sleeping.
- The memory accountant: phases, census, the OOM report and guard.
- `resolve_comm_config` reads `PTPU_BUCKET_MB` as the reference does;
  the comm model's `comm_overlap` record equals the reference's.
- The profiler's scheduler and `StepTelemetry.snapshot()` keys.
- Every `ptpu_*` name the port publishes is in docs/observability.md's
  metrics table (tests/test_metrics_docs.py's rule).
"""
import json
import os
import re
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprof
from paddle_tpu.core import alerts as jalerts
from paddle_tpu.core import bucketing as jbuck
from paddle_tpu.core import ledger as jledger
from paddle_tpu.core import monitor as jmon
from paddle_tpu.distributed import flight_recorder as jfr
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.core import alerts as talerts
from paddle_tpu_torch.core import async_step as tasync
from paddle_tpu_torch.core import bucketing as tbuck
from paddle_tpu_torch.core import ledger as tledger
from paddle_tpu_torch.core import memory as tmem
from paddle_tpu_torch.core import monitor as tmon
from paddle_tpu_torch.distributed import flight_recorder as tfr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _twin_histories(capacity=16):
    """(clock, [(package monitor, registry, history)]) for both packages,
    each over a private registry on the shared injected clock."""
    clock = Clock()
    out = []
    for mon in (jmon, tmon):
        reg = mon.MetricsRegistry()
        out.append((mon, reg, reg.enable_history(capacity=capacity,
                                                 clock=clock)))
    return clock, out


def _feed(clock, twins, steps=30, seed=0):
    """The same gauge walk, counter increments and histogram samples
    into both registries, one sample per clock step of 0.5 s."""
    rng = np.random.RandomState(seed)
    vals = rng.normal(1.0, 0.3, steps)
    incs = rng.randint(0, 5, steps)
    obs = rng.gamma(2.0, 0.05, steps)
    for i in range(steps):
        clock.t = 0.5 * i
        for _mon, reg, hist in twins:
            reg.gauge('ptpu_serve_decode_tokens_per_sec').set(
                float(vals[i]))
            reg.counter('ptpu_straggler_events_total').inc(int(incs[i]))
            reg.gauge('ptpu_serve_kv_page_utilization',
                      labelnames=('pool',)).set(float(vals[i]) / 2,
                                                pool='a')
            reg.histogram('ptpu_serve_ttft_seconds').observe(float(obs[i]))
            hist.sample()
    return vals


# ---------------------------------------------------------------------------
# metric history
# ---------------------------------------------------------------------------
def test_history_views_equal_the_reference():
    clock, twins = _twin_histories()
    _feed(clock, twins)
    (_, _, jh), (_, _, th) = twins
    assert th.series_names() == jh.series_names()
    for name in jh.series_names():
        labels = {'pool': 'a'} if name == \
            'ptpu_serve_kv_page_utilization' else None
        assert th.points(name, labels) == jh.points(name, labels)
        for w in (1.0, 3.0, 100.0):
            assert th.delta(name, w, labels) == jh.delta(name, w, labels)
            assert th.rate(name, w, labels) == jh.rate(name, w, labels)
            assert th.window(name, w, labels) == jh.window(name, w, labels)
        assert th.ewma(name, 2.0, labels) == jh.ewma(name, 2.0, labels)
        for pred in (lambda v: v > 0.5, lambda v: v < 100):
            assert th.sustained(name, pred, 4.0, labels) == \
                jh.sustained(name, pred, 4.0, labels)
        assert th.sparkline(name, labels) == jh.sparkline(name, labels)
    assert th.export(max_points=8) == jh.export(max_points=8)
    assert th.snapshot() == jh.snapshot()


def test_history_hooks_and_reset():
    clock = Clock()
    reg = tmon.MetricsRegistry()
    reg.history_tick()                        # a no-op before enabling
    hist = reg.enable_history(capacity=4, min_interval_s=1.0, clock=clock)
    assert reg.enable_history(capacity=99) is hist
    reg.gauge('ptpu_serve_degrade_stage').set(1.0)
    reg.history_tick()
    clock.t = 0.5
    reg.history_tick()                        # rate-limited: no sample
    assert hist.snapshot()['samples'] == 1
    for i in range(6):                        # the ring wraps at 4
        clock.t = 1.0 + i
        reg.history_tick()
    assert len(hist.points('ptpu_serve_degrade_stage')) == 4
    assert reg.snapshot()['series']['ptpu_serve_degrade_stage']['last'] \
        == 1.0
    reg.reset()
    assert hist.series_names() == []
    with pytest.raises(ValueError, match='capacity'):
        tmon.MetricsRegistry().enable_history(capacity=1)


def test_background_tick_starts_and_joins():
    reg = tmon.MetricsRegistry()
    hist = reg.enable_history(capacity=8)
    hist.start_background(interval_s=0.01)
    t = hist._bg
    for _ in range(200):
        if hist.snapshot()['samples']:
            break
        threading.Event().wait(0.01)
    hist.stop_background()
    assert not t.is_alive() and hist.snapshot()['samples'] >= 1


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------
def _walk_alerts(pack, steps=60):
    clock, twins = _twin_histories(capacity=64)
    mgrs = []
    for (mod, (_mon, reg, hist)) in zip((jalerts, talerts), twins):
        mgrs.append(mod.AlertManager(hist, rules=pack(mod), clock=clock,
                                     registry=reg, source='parity',
                                     report_dir=None))
    rng = np.random.RandomState(3)
    util = np.concatenate([np.full(10, 0.5), np.full(20, 0.99),
                           np.full(30, 0.3)]) + rng.uniform(0, 0.005, 60)
    tps = np.concatenate([np.full(25, 100.0), np.full(35, 20.0)])
    events = ([], [])
    for i in range(steps):
        clock.t = 0.5 * i
        for k, (_mon, reg, hist) in enumerate(twins):
            reg.gauge('ptpu_serve_kv_page_utilization').set(float(util[i]))
            reg.gauge('ptpu_serve_decode_tokens_per_sec').set(float(tps[i]))
            reg.gauge('ptpu_serve_degrade_stage').set(
                2.0 if 20 <= i < 30 else 0.0)
            reg.gauge('ptpu_cluster_replica_occupancy',
                      labelnames=('replica',)).set(
                float(util[i]), replica='0')
            reg.gauge('ptpu_cluster_replica_occupancy',
                      labelnames=('replica',)).set(0.1, replica='1')
            reg.counter('ptpu_route_drains_total').inc(
                1 if i in (40, 41, 42) else 0)
            events[k].extend(hist.tick())
    return events, mgrs


@pytest.mark.parametrize('pack', ['default', 'router'])
def test_rule_packs_fire_and_clear_the_same_events(pack, monkeypatch):
    monkeypatch.delenv('PTPU_SERVE_REPORT_DIR', raising=False)
    monkeypatch.delenv('FLEET_LOG_DIR', raising=False)
    make = (lambda mod: mod.default_rules()) if pack == 'default' else \
        (lambda mod: mod.router_rules())
    (jev, tev), (jm, tm) = _walk_alerts(make)
    assert tev == jev
    assert any(e['event'] == 'fired' for e in tev)
    assert any(e['event'] == 'resolved' for e in tev)
    assert tm.summary() == jm.summary()
    assert tm.snapshot() == jm.snapshot()
    assert tm.active() == jm.active()


def test_alert_rule_validation_and_report(tmp_path):
    for bad in (dict(severity='loud'), dict(metric=None),
                dict(kind='predicate', metric=None), dict(op='!=')):
        with pytest.raises(ValueError):
            talerts.AlertRule(**dict(dict(name='r', metric='ptpu_x'),
                                     **bad))
    clock, twins = _twin_histories()
    _mon, reg, hist = twins[1]
    rule = talerts.AlertRule('hot', metric='ptpu_serve_degrade_stage',
                             op='>=', value=1.0, severity='critical')
    with pytest.raises(ValueError, match='duplicate'):
        talerts.AlertManager(hist, rules=[rule, rule], registry=reg)
    mgr = talerts.AlertManager(hist, rules=[rule], registry=reg,
                               report_dir=str(tmp_path), source='t')
    reg.gauge('ptpu_serve_degrade_stage').set(2.0)
    hist.tick()
    doc = json.load(open(mgr.last_report_path))
    assert doc['kind'] == 'alert_report' and doc['events'][0]['rule'] == \
        'hot'
    assert reg.get('ptpu_alert_active').value(rule='hot',
                                              severity='critical') == 1
    assert mgr.summary()['fired_critical'] == 1
    mgr.detach()
    assert hist.tick() == []


# ---------------------------------------------------------------------------
# the step ledger
# ---------------------------------------------------------------------------
class _StubGap:
    def __init__(self, snap):
        self.snap = snap

    def snapshot(self):
        return dict(self.snap)


@pytest.mark.parametrize('policy', ['none', 'full', 'dots',
                                    'attn_mlp_boundaries'])
def test_ledger_account_equals_the_reference(policy):
    rng = np.random.RandomState(1)
    wall = float(rng.uniform(0.2, 0.5))
    snap = {'steps': 7, 'step_interval_seconds': wall,
            'host_gap_seconds': wall * 0.1,
            'host_residue_seconds': wall * 0.05,
            'blocked_wait_seconds': wall * 0.02}
    hints = dict(layers=4, hidden=256, seq_len=128, n_params=123456,
                 arch='gpt', peak_tflops=989.0)
    accts = []
    for mod in (jledger, tledger):
        eng = f'parity_{policy}'
        mod.configure(eng, **hints)
        led = mod.StepLedger(eng, gap=_StubGap(snap), remat_policy=policy,
                             bubble_fraction_fn=lambda: 0.25)
        led.observe_batch((8, 128))
        accts.append(led.account())
    j, t = accts
    assert set(t) == set(j)
    for k, v in j.items():
        assert t[k] == (pytest.approx(v, rel=1e-12)
                        if isinstance(v, (dict, float)) else v), k
    assert sum(t['components'].values()) == pytest.approx(wall)
    assert t['reconciled_fraction'] == pytest.approx(1.0)
    for f in (0.0, 0.3):
        assert tledger.recompute_factor(policy, 10.0, 10.0 * f) == \
            jledger.recompute_factor(policy, 10.0, 10.0 * f)


def test_ledger_publish_reads_back_and_renders():
    tmon.metrics()
    led = tledger.StepLedger(
        'ledger_readback', gap=_StubGap({'step_interval_seconds': 0.4,
                                         'host_gap_seconds': 0.04}),
        params_fn=lambda: tledger.count_params(
            {'a': torch.zeros(10, 10), 'b': [torch.zeros(5)]}))
    led.observe_batch((2, 16))
    acct = led.publish()
    assert acct['n_params'] == 105 and acct['tokens_per_step'] == 32
    back = tledger.ledger_snapshot('ledger_readback')['ledger_readback']
    assert back['wall_seconds'] == acct['wall_seconds']
    assert back['components'] == pytest.approx(acct['components'])
    assert back['mfu'] is None            # no card: no peak, no MFU
    assert 'ledger_readback' in tledger.render_ledger(
        tledger.ledger_snapshot())
    assert tledger.resolve_peak_tflops('NVIDIA H100 80GB HBM3') == 989.0
    assert tledger.resolve_peak_tflops('cpu') is None
    assert tledger.StragglerDetector().check(50, 0.3) is None


class _Group:
    """An injected host-collective group of `world` ranks whose
    all_gather returns the given per-rank values."""

    def __init__(self, rank, values):
        self.rank, self.world_size, self.gid = rank, len(values), 0
        self.values = values

    def all_gather(self, x):
        return [np.asarray(v, np.float64) for v in self.values]


def test_straggler_check_with_an_injected_group(tmp_path):
    det = tledger.StragglerDetector(
        group=_Group(0, [[0.30], [0.31], [0.60]]), threshold=1.25,
        dump_dir=str(tmp_path))
    rep = det.check(50, 0.30)
    assert rep['offending_ranks'] == [2]
    assert os.path.exists(det.report_path)
    assert 'STRAGGLER' in tledger.render_straggler_report(rep)


# ---------------------------------------------------------------------------
# flight recorder and watchdog
# ---------------------------------------------------------------------------
_TIMES = ('time', 'pid', 't_enqueue', 't_complete', 'last_heartbeat')


def _untimed(doc):
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items() if k not in _TIMES}
    if isinstance(doc, list):
        return [_untimed(v) for v in doc]
    return doc


def _journal(mod, rank, fail_at=None):
    rec = mod.FlightRecorder(capacity=6, rank=rank)
    for g in range(1, 10):
        seq = rec.record_enqueue('all_reduce' if g % 2 else 'all_gather',
                                 group=0, gseq=g, shape=(4, g),
                                 nbytes=16 * g)
        if g != fail_at:
            rec.record_complete(seq)
        if g == fail_at:
            break
    rec.heartbeat()
    return rec


def test_flight_recorder_dump_and_analyze_equal_the_reference():
    dumps = {}
    for mod in (jfr, tfr):
        ranks = {0: _journal(mod, 0).dump(), 1: _journal(mod, 1, 6).dump(),
                 2: _journal(mod, 2, 3).dump(), 3: None}
        dumps[mod] = ranks
    assert _untimed(dumps[tfr]) == _untimed(dumps[jfr])
    assert _untimed(tfr.analyze(dumps[tfr])) == \
        _untimed(jfr.analyze(dumps[jfr]))
    assert tfr.render_dump(dumps[tfr][1]) == jfr.render_dump(dumps[jfr][1])
    doc = {'reason': 'r', 'ranks': dumps[tfr],
           'analysis': tfr.analyze(dumps[tfr])}
    assert tfr.render_dump(doc) == jfr.render_dump(
        {'reason': 'r', 'ranks': dumps[jfr],
         'analysis': jfr.analyze(dumps[jfr])})


def test_watchdog_local_dump_on_a_stale_heartbeat(tmp_path):
    clock = Clock()
    rec = tfr.FlightRecorder(capacity=8, rank=0)
    rec.heartbeat()
    dog = tfr.HangWatchdog(timeout=5.0, recorder=rec, dump_dir=str(tmp_path),
                           clock=clock)
    clock.t = rec.last_beat() + 1.0
    assert dog._stall_reason(clock()) is None
    clock.t = rec.last_beat() + 6.0
    reason = dog._stall_reason(clock())
    assert 'heartbeat stale' in reason
    report = dog._fire(reason)
    assert report['kind'] == 'hang_report'
    doc = json.load(open(dog.report_path))
    assert doc['reason'] == reason and doc['ranks']['0']['stacks']
    seq = rec.record_enqueue('all_reduce', gseq=1)
    clock.t = rec.entries()[-1]['t_enqueue'] + 6.0
    assert 'all_reduce gseq=1 pending' in dog._stall_reason(clock())
    rec.record_complete(seq)
    with pytest.raises(NotImplementedError, match='item 7'):
        tfr.HangWatchdog(store=object())


def test_watchdog_thread_fires_and_joins(tmp_path):
    rec = tfr.FlightRecorder(capacity=8, rank=0)
    rec.heartbeat()
    clock = Clock()
    clock.t = rec.last_beat() + 100.0     # stale from the first check
    dog = tfr.HangWatchdog(timeout=1.0, interval=0.01, recorder=rec,
                           dump_dir=str(tmp_path), clock=clock)
    with dog:
        assert dog.fired.wait(5.0)
    assert dog._thread is None and dog.fire_count >= 1
    assert os.path.exists(dog.report_path)
    tfr.engine_teardown()
    assert tfr.recorder().last_beat() is None


def test_start_watchdog_is_env_gated(monkeypatch):
    monkeypatch.delenv('PADDLE_HANG_TIMEOUT', raising=False)
    assert tfr.start_watchdog() is None
    monkeypatch.setenv('PADDLE_HANG_TIMEOUT', '30')
    try:
        dog = tfr.start_watchdog()
        assert dog is not None and tfr.start_watchdog() is dog
    finally:
        tfr.stop_watchdog()


# ---------------------------------------------------------------------------
# memory accountant
# ---------------------------------------------------------------------------
def test_memory_phases_census_and_oom_report(tmp_path, monkeypatch):
    monkeypatch.setenv('FLEET_LOG_DIR', str(tmp_path))
    acct = tmem.MemoryAccountant()
    keep = []
    with acct.phase('engine.init'):          # a census phase
        keep.append(torch.zeros(1 << 16))
    ph = acct.phases()['engine.init']
    assert ph['calls'] == 1 and ph['max_delta'] >= 4 * (1 << 16)
    assert ph['live_buffers'] is not None
    rows = acct.live_buffers(top=50)
    assert any(o == 'engine.init' and b == 4 * (1 << 16)
               for b, _s, _d, o in rows)
    with acct.phase('pipeline.step'):        # not a census phase
        pass
    assert acct.phases()['pipeline.step']['live_buffers'] is None
    rep = acct.oom_report()
    assert rep['kind'] == 'oom_report' and rep['suspect_phase'] == \
        'engine.init'
    assert 'engine.init' in tmem.render_oom_report(rep)
    with pytest.raises(tmem.DeviceOOMError) as ei:
        with tmem.oom_guard('t.site'):
            raise torch.cuda.OutOfMemoryError('CUDA out of memory.')
    assert ei.value.report['site'] == 't.site'
    assert os.path.exists(ei.value.report_path)
    with pytest.raises(ValueError):
        with tmem.oom_guard('t.site'):
            raise ValueError('not memory')
    assert tmem.is_oom_error(RuntimeError('CUDA error: out of memory'))
    assert not tmem.is_oom_error(None)


def test_engine_memory_phases_and_shutdown_census():
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline as tsp)
    from paddle_tpu_torch.models import gpt as tgpt
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=16, hidden_dropout=0.0,
                         attn_dropout=0.0)
    eng = tsp.SpmdPipelineEngine(
        *tgpt.build_gpt_pipeline(cfg, generator=torch.Generator()
                                 .manual_seed(0)),
        topt.AdamW(learning_rate=1e-3), accumulate_steps=2, device='cpu')
    ids = np.random.RandomState(0).randint(0, 64, (4, 16)).astype('int32')
    eng.train_batch((ids, np.roll(ids, -1, 1)))
    phases = tmem.accountant().phases()
    assert {'engine.init', 'pipeline.build', 'pipeline.step'} <= set(phases)
    assert 'pipeline' in tasync.host_snapshot()['sites']
    released = eng.shutdown()
    assert released['live_buffers'] is not None
    assert 'pipeline' not in tasync.host_snapshot()['sites']
    assert eng.shutdown()['live_buffers'] is not None   # idempotent


# ---------------------------------------------------------------------------
# comm config and the comm model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('env,kw', [('8', {}), ('0.5', {}), ('64', {}),
                                    ('8', {'bucket_mb': 2.0}),
                                    ('16', {'comm_dtype': 'bfloat16'})])
def test_resolve_comm_config_reads_the_env_as_the_reference(
        monkeypatch, env, kw):
    monkeypatch.setenv('PTPU_BUCKET_MB', env)
    monkeypatch.delenv('PTPU_COMM_DTYPE', raising=False)
    jd, jb = jbuck.resolve_comm_config(**kw)
    td, tb = tbuck.resolve_comm_config(**kw)
    assert tb == jb
    assert (None if td is None else str(td).split('.')[-1]) == \
        (None if jd is None else str(jd))
    monkeypatch.setenv('PTPU_COMM_OVERLAP', '1')
    monkeypatch.setenv('PTPU_COMM_CHUNK', '0')
    assert tbuck.resolve_overlap_config() == jbuck.resolve_overlap_config()


def test_comm_model_records_equal_the_reference():
    import jax.numpy as jnp
    shapes = {'embed/w': ((64, 32), 'bfloat16'),
              'blocks/0/w': ((32, 32), 'bfloat16'),
              'blocks/0/b': ((32,), 'float32'),
              'head/w': ((32, 8), 'bfloat16')}
    grp = (lambda name, shape, dtype:
           'blocks' if name.startswith('blocks/') else 'repl')
    jl = jbuck.BucketLayout.build(
        {n: (s, jnp.dtype(d)) for n, (s, d) in shapes.items()},
        bucket_bytes=4096, pad_to=8, group_fn=grp)
    tl = tbuck.BucketLayout.build(
        {n: (s, getattr(torch, d)) for n, (s, d) in shapes.items()},
        bucket_bytes=4096, pad_to=8, group_fn=grp)
    for mod, lay in ((jbuck, jl), (tbuck, tl)):
        mod.publish_comm_gauges(lay, engine='parity_comm', n_shards=1,
                                comm_dtype=None, enabled=False)
        mod.publish_overlap_gauges(lay, engine='parity_comm', n_shards=1,
                                   enabled=False)
    assert tbuck.wire_bytes(tl, 1) == jbuck.wire_bytes(jl, 1)
    j = jbuck.comm_snapshot()['comm_overlap']['parity_comm']
    t = tbuck.comm_snapshot()['comm_overlap']['parity_comm']
    # the modeled link differs (the H100's NVLink, a TPU's ICI): the
    # seconds scale by the bandwidths' ratio, every count is equal
    ratio = jbuck.MODELED_ICI_BYTES_PER_S / tbuck.MODELED_LINK_BYTES_PER_S
    for k in ('enabled', 'groups', 'groups_in_flight', 'prefetch_depth',
              'chunk_elements'):
        assert t[k] == j[k]
    for k in ('total_comm_seconds', 'exposed_comm_seconds',
              'hidden_comm_seconds'):
        assert t[k] == pytest.approx(j[k] * ratio, rel=1e-6, abs=1e-9)


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('kw', [dict(closed=1, ready=1, record=2),
                                dict(wait=2, warmup=0, active=3, repeat=2),
                                dict(record=1, skip_first=3)])
def test_make_scheduler_equals_the_reference(kw):
    js, ts = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [ts(i) for i in range(20)] == [js(i) for i in range(20)]


def test_profiler_windows_and_chrome_export(tmp_path):
    seen = []
    prof = tprof.Profiler(scheduler=(1, 3), on_trace_ready=lambda p:
                          seen.append(p.profiler_result.step_range))
    with prof:
        for i in range(5):
            with tprof.RecordEvent(f'step{i}'):
                pass
            prof.step()
    assert seen == [(1, 3)]
    names = [s['name'] for s in prof.profiler_result.events()]
    assert names == ['step1', 'step2']
    path = prof.export(str(tmp_path / 'w.trace.json'))
    doc = json.load(open(path))
    assert {'step1', 'step2'} <= {e['name'] for e in doc['traceEvents']}
    handler = tprof.export_chrome_tracing_handler(str(tmp_path / 'h'))
    assert os.path.exists(handler(prof))


def test_step_telemetry_snapshot_has_the_reference_keys():
    tel = tprof.StepTelemetry(window=4, publish=True)
    for _ in range(3):
        with tel.step(examples=8, tokens=128):
            pass
    t = tel.snapshot()
    j = jprof.StepTelemetry(publish=False).snapshot()
    assert set(t) == set(j) - {'xla_flops_per_run'}
    assert t['steps'] == 3 and t['tokens_per_sec'] > 0
    assert t['device_memory'] is None and t['compile_cache'] is None
    assert tmon.metrics().get('ptpu_step_ms') is not None


# ---------------------------------------------------------------------------
# metric names against the docs
# ---------------------------------------------------------------------------
def test_every_port_metric_is_in_the_docs_table():
    """Every `ptpu_*` name under paddle_tpu_torch/ is a row of
    docs/observability.md's metrics reference (the rule
    tests/test_metrics_docs.py holds for the JAX package)."""
    code_re = re.compile(r"""['"](ptpu_[a-z0-9_]+)['"]""")
    names = set()
    for root, _dirs, files in os.walk(os.path.join(REPO,
                                                   'paddle_tpu_torch')):
        for fn in files:
            if fn.endswith('.py'):
                with open(os.path.join(root, fn)) as f:
                    names |= {m for m in code_re.findall(f.read())
                              if not m.endswith('_')}
    with open(os.path.join(REPO, 'docs', 'observability.md')) as f:
        text = f.read()
    ref = text.split('<!-- metrics-reference:begin -->', 1)[1].split(
        '<!-- metrics-reference:end -->', 1)[0]
    documented = set(re.findall(r'`(ptpu_[a-z0-9_]+)`', ref))
    assert names and not names - documented, sorted(names - documented)
