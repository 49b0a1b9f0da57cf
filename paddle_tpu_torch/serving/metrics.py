"""ptpu_serve_* metrics — the serving engine's observability surface,
counterpart of `paddle_tpu/serving/metrics.py` with the same gauge,
counter and histogram names.

Published through the port's core.monitor registry and read back by
`serve_snapshot()`: the engine's scalar gauges and lifetime totals, the
per-request queue-wait / TTFT / TPOT / e2e / preemption histograms
with bucket-interpolated p50/p90/p99, the scheduler-timeline summary,
the tenancy layer (tenant-labeled ptpu_serve_tenant_{queue_wait,e2e}_
seconds histograms, the quota / preemption / deadline counters as
gauges, the ladder's stage and pressure), the host-tier gauges (only
when the engine has a tier), and the serving ledger's goodput and
roofline views.
"""
from ..core import monitor as _m
from . import ledger as _serve_ledger

TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                2.5, 5.0, 10.0, 30.0, float('inf'))
TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, float('inf'))
E2E_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
               5.0, 10.0, 30.0, 60.0, 120.0, float('inf'))
PREEMPT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, float('inf'))

# SLO histograms: monitor name -> (engine _new_slo key, buckets, help)
_SLO_HISTOGRAMS = {
    'ptpu_serve_queue_wait_seconds': (
        'queue_wait_s', TTFT_BUCKETS,
        'per-request submit -> first admit wait'),
    'ptpu_serve_tpot_seconds': (
        'tpot_s', TPOT_BUCKETS,
        'per-request mean inter-token latency (time per output token)'),
    'ptpu_serve_e2e_seconds': (
        'e2e_s', E2E_BUCKETS,
        'per-request submit -> retire latency'),
    'ptpu_serve_preemptions_per_request': (
        'preemptions', PREEMPT_BUCKETS,
        'preemptions suffered per retired request'),
}

_GAUGE_NAMES = (
    'ptpu_serve_decode_tokens_per_sec',
    'ptpu_serve_batch_occupancy',
    'ptpu_serve_kv_page_utilization',
    'ptpu_serve_kv_pages_total',
    'ptpu_serve_kv_pages_in_use',
    'ptpu_serve_kv_pages_high_water',
    'ptpu_serve_kv_pool_bytes',
    'ptpu_serve_kv_bytes_per_token',
    'ptpu_serve_batch_slots',
    'ptpu_serve_requests_in_flight',
    'ptpu_serve_requests_waiting',
    # prefix cache: lifetime hit/miss lookups, pages mapped
    # by >1 request right now, ref-0 pages parked for resurrection
    'ptpu_serve_prefix_hits',
    'ptpu_serve_prefix_misses',
    'ptpu_serve_prefix_shared_pages',
    'ptpu_serve_prefix_cached_pages',
    # multi-tenant SLO layer: lifetime quota deferral /
    # charged-preemption / deadline-reject counts (engine-owned
    # monotonic state mirrored as gauges, like the _total block) and
    # the degradation ladder's current stage + windowed pressure
    'ptpu_serve_quota_deferrals',
    'ptpu_serve_preemptions_charged',
    'ptpu_serve_deadline_rejects',
    'ptpu_serve_deadline_misses',
    'ptpu_serve_degrade_stage',
    'ptpu_serve_degrade_pressure',
    # fused multi-token decode: the configured window
    # length (1 = per-token decode)
    'ptpu_serve_fused_k',
    # host-RAM KV tier: occupancy gauges — published ONLY
    # when the engine has a host tier (pool stats carry tier_* keys),
    # so tierless configs keep exactly the tierless gauge set (held
    # in tests/test_torch_serving_kvtier.py)
    'ptpu_serve_tier_host_pages',
    'ptpu_serve_tier_host_used_pages',
    'ptpu_serve_tier_resident_pages',
    'ptpu_serve_tier_spill_inflight_pages',
)

# host-RAM tier gauges: name -> (help, value(pool stats)). Conditional
# on the pool actually carrying tier stats — see _GAUGE_NAMES note.
_TIER_GAUGES = (
    ('ptpu_serve_tier_host_pages',
     'host-tier capacity in KV pages',
     lambda p: p.get('tier_host_pages', 0)),
    ('ptpu_serve_tier_host_used_pages',
     'host-tier slots holding spilled pages right now',
     lambda p: p.get('tier_host_used_pages', 0)),
    ('ptpu_serve_tier_resident_pages',
     'device-resident KV pages (mapped + parked) — the HBM side of '
     'the tier split',
     lambda p: (p.get('pages_in_use', 0) + p.get('cached_pages', 0))),
    ('ptpu_serve_tier_spill_inflight_pages',
     'device pages pinned by an in-flight spill (unavailable to '
     'allocation until the transfer lands)',
     lambda p: p.get('tier_spill_inflight_pages', 0)),
)

# host-RAM tier counters-as-gauges (engine-owned lifetime totals,
# mirrored like _COUNTER_NAMES; conditional like _TIER_GAUGES)
_TIER_COUNTERS = (
    ('ptpu_serve_tier_resurrected_pages_total',
     'host-resident pages resurrected by prefetch instead of '
     're-prefill (lifetime)', 'tier_resurrected_pages_total'),
    ('ptpu_serve_tier_resurrected_tokens_total',
     'prompt tokens whose KV came back from the host tier instead of '
     'recompute (lifetime)', 'tier_resurrected_tokens_total'),
)

# transfer totals: REAL monitor counters incremented by host_tier.py
# at transfer time (never re-published as gauges — the registry would
# conflict); scalar_series mirrors them from pool stats so per-replica
# cluster snapshots carry them without touching the shared registry
_TIER_TRANSFER_COUNTERS = (
    ('ptpu_serve_tier_spilled_pages_total',
     'KV pages spilled device->host tier (lifetime)',
     'tier_spilled_pages_total'),
    ('ptpu_serve_tier_spilled_bytes_total',
     'bytes spilled device->host tier (lifetime)',
     'tier_spilled_bytes_total'),
    ('ptpu_serve_tier_fetched_pages_total',
     'KV pages fetched host->device (lifetime)',
     'tier_fetched_pages_total'),
    ('ptpu_serve_tier_fetched_bytes_total',
     'bytes fetched host->device (lifetime)',
     'tier_fetched_bytes_total'),
)

# tenant-labeled SLO histograms: name -> (engine tenant-slo key,
# buckets, help). One labeled series per tenant in the one registry
# metric — serve_snapshot()['tenants'] renders per-tenant percentiles.
_TENANT_HISTOGRAMS = {
    'ptpu_serve_tenant_queue_wait_seconds': (
        'queue_wait_s', TTFT_BUCKETS,
        'per-request submit -> first admit wait, by tenant'),
    'ptpu_serve_tenant_e2e_seconds': (
        'e2e_s', E2E_BUCKETS,
        'per-request submit -> retire latency, by tenant'),
}
_COUNTER_NAMES = (
    'ptpu_serve_requests_submitted_total',
    'ptpu_serve_requests_completed_total',
    'ptpu_serve_requests_aborted_total',
    'ptpu_serve_preemptions_total',
    'ptpu_serve_decode_steps_total',
    'ptpu_serve_decode_tokens_total',
    'ptpu_serve_prefill_tokens_total',
    'ptpu_serve_prefill_chunks_total',
    'ptpu_serve_prefix_hit_tokens_total',
    'ptpu_serve_spec_proposed_tokens_total',
    'ptpu_serve_spec_accepted_tokens_total',
    # fused multi-token decode: windows dispatched (one
    # host fetch each), device iterations inside them, tokens they
    # delivered — decode_steps_total keeps counting ITERATIONS, so
    # per-token dashboards stay comparable across fused/serial
    'ptpu_serve_fused_windows_total',
    'ptpu_serve_fused_iterations_total',
    'ptpu_serve_fused_tokens_total',
)

# scalar gauges: name -> (help, value(stats, pool)). One declarative
# table so publish() (global registry) and scalar_series() (per-replica
# compact snapshots for the cluster `metrics` op) can never drift.
_SCALAR_GAUGES = (
    ('ptpu_serve_decode_tokens_per_sec',
     'batched decode throughput (generated tokens/sec)',
     lambda s, p: s.get('decode_tokens_per_sec', 0.0)),
    ('ptpu_serve_batch_occupancy',
     'mean running slots / decode slots over decode steps',
     lambda s, p: s.get('batch_occupancy', 0.0)),
    ('ptpu_serve_kv_page_utilization',
     'KV pool pages in use / total',
     lambda s, p: s.get('kv_page_utilization', 0.0)),
    ('ptpu_serve_kv_pages_total', 'KV pool size in pages',
     lambda s, p: p.get('num_pages', 0)),
    ('ptpu_serve_kv_pages_in_use', 'KV pages mapped right now',
     lambda s, p: p.get('pages_in_use', 0)),
    ('ptpu_serve_kv_pages_high_water',
     'max KV pages simultaneously mapped',
     lambda s, p: p.get('high_water', 0)),
    ('ptpu_serve_kv_pool_bytes',
     'device bytes of the paged KV pool (scale buffers '
     'included for int8 pools)',
     lambda s, p: p.get('pool_bytes', 0)),
    ('ptpu_serve_kv_bytes_per_token',
     'K+V device bytes per cached token across layers '
     '(docs/serving.md#quantized-kv capacity math)',
     lambda s, p: p.get('bytes_per_token', 0)),
    ('ptpu_serve_batch_slots', 'decode batch slots',
     lambda s, p: s.get('slots', 0)),
    ('ptpu_serve_requests_in_flight', 'requests holding a decode slot',
     lambda s, p: s.get('in_flight', 0)),
    ('ptpu_serve_requests_waiting', 'queued requests',
     lambda s, p: s.get('waiting', 0)),
    ('ptpu_serve_prefix_hits',
     'prefix-cache lookups that mapped shared pages (lifetime)',
     lambda s, p: s.get('prefix_hits_total', 0)),
    ('ptpu_serve_prefix_misses',
     'prefix-cache lookups that found nothing (lifetime)',
     lambda s, p: s.get('prefix_misses_total', 0)),
    ('ptpu_serve_prefix_shared_pages',
     'physical KV pages currently mapped by >1 request',
     lambda s, p: s.get('prefix_shared_pages', 0)),
    ('ptpu_serve_prefix_cached_pages',
     'ref-0 pages retained by the prefix index '
     '(evictable, resurrectable)',
     lambda s, p: s.get('prefix_cached_pages', 0)),
    ('ptpu_serve_quota_deferrals',
     'requests deferred by a tenant token-rate quota '
     '(defer episodes, lifetime)',
     lambda s, p: s.get('quota_deferrals_total', 0)),
    ('ptpu_serve_preemptions_charged',
     'preemptions debited against the preempting tenant\'s '
     'quota (lifetime)',
     lambda s, p: s.get('preemptions_charged_total', 0)),
    ('ptpu_serve_deadline_rejects',
     'requests rejected at submit because their deadline was '
     'already unmeetable (lifetime)',
     lambda s, p: s.get('deadline_rejects_total', 0)),
    ('ptpu_serve_deadline_misses',
     'requests finished past their own deadline (lifetime)',
     lambda s, p: s.get('deadline_misses_total', 0)),
    ('ptpu_serve_fused_k',
     'configured fused decode window length (decode iterations per '
     'dispatch; 1 = per-token decode)',
     lambda s, p: s.get('fused_k', 1)),
)


def scalar_series(stats):
    """Pure view: engine stats dict -> {gauge name: scalar value} for
    every scalar ptpu_serve_* series publish() would set. Reads the
    same keys, pops nothing — the replica `metrics` control-channel op
    uses this to build compact per-replica snapshots without touching
    the (process-global, shared between in-process replicas) registry."""
    pool = stats.get('pool') or {}
    out = {name: fn(stats, pool) for name, _h, fn in _SCALAR_GAUGES}
    for name in _COUNTER_NAMES:
        key = name[len('ptpu_serve_'):-len('_total')]
        out[name] = stats.get(key + '_total', 0)
    if 'tier_host_pages' in pool:       # host tier attached
        for name, _h, fn in _TIER_GAUGES:
            out[name] = fn(pool)
        for name, _h, key in _TIER_COUNTERS:
            out[name] = pool.get(key, 0)
        for name, _h, key in _TIER_TRANSFER_COUNTERS:
            out[name] = pool.get(key, 0)
    out['ptpu_serve_degrade_stage'] = stats.get('degrade_stage', 0)
    tenancy = stats.get('tenancy')
    out['ptpu_serve_degrade_pressure'] = \
        (tenancy or {}).get('pressure', 0.0)
    return out


# scheduler-timeline summary from the engine's last publish — a dict,
# not registry gauges: it is a windowed aggregate that the snapshot
# passes through whole (the router-feedback signal)
_last_timeline = None
# per-tenant accounting table from the engine's last publish
# (engine._tenancy_stats()) — passed through whole like the timeline
_last_tenancy = None


def publish_degrade_stage(stage, pressure):
    """Gauge a degradation-ladder transition the moment it happens —
    every stage change must be visible even between periodic publishes
    (an explicit, gauged, traced event)."""
    _m.gauge('ptpu_serve_degrade_stage',
             help='graceful-degradation ladder stage (0 = normal, '
                  '1 = spec shed, 2 = prefill shrink, 3 = weighted '
                  'prefix eviction)').set(int(stage))
    _m.gauge('ptpu_serve_degrade_pressure',
             help='windowed scheduler pressure signal (pool occupancy '
                  '+ waiting depth) driving the ladder').set(
        float(pressure))


def publish(stats):
    """Publish an engine stats dict (ServingEngine.stats()) as
    ptpu_serve_* gauges. Counters are published as gauges set to the
    engine's lifetime totals — the engine owns the monotonic state, the
    registry just mirrors it (monitor counters can't be set)."""
    global _last_timeline, _last_tenancy
    g = _m.gauge
    pool = stats.get('pool') or {}
    for name, help_, fn in _SCALAR_GAUGES:
        g(name, help=help_).set(fn(stats, pool))
    for name in _COUNTER_NAMES:
        key = name[len('ptpu_serve_'):-len('_total')]
        g(name, help=f'serving {key.replace("_", " ")} (lifetime)').set(
            stats.get(key + '_total', 0))
    # host-RAM tier: published only when the pool carries
    # tier stats, so tierless engines keep exactly the tierless gauge
    # set. Transfer totals are real counters host_tier.py owns — not
    # re-published here.
    if 'tier_host_pages' in pool:
        for name, help_, fn in _TIER_GAUGES:
            g(name, help=help_).set(fn(pool))
        for name, help_, key in _TIER_COUNTERS:
            g(name, help=help_).set(pool.get(key, 0))
    h = _m.histogram('ptpu_serve_ttft_seconds',
                     help='per-request time to first token',
                     buckets=TTFT_BUCKETS)
    for t in stats.pop('_new_ttfts_s', ()):
        h.observe(t)
    slo = stats.pop('_new_slo', None) or {}
    for name, (key, buckets, help_) in _SLO_HISTOGRAMS.items():
        vals = slo.get(key)
        if not vals:
            continue
        hh = _m.histogram(name, help=help_, buckets=buckets)
        for v in vals:
            hh.observe(v)
    # multi-tenant layer: the quota/deadline
    # counters-as-gauges rode the table above; the ladder
    # stage/pressure + one labeled series per tenant in the
    # queue-wait/e2e histograms land here
    tenancy = stats.pop('tenancy', None)
    publish_degrade_stage(
        stats.get('degrade_stage', 0),
        (tenancy or {}).get('pressure', 0.0))
    tslo = stats.pop('_new_tenant_slo', None) or {}
    for tid, samples in tslo.items():
        for name, (key, buckets, help_) in _TENANT_HISTOGRAMS.items():
            vals = samples.get(key)
            if not vals:
                continue
            hh = _m.histogram(name, help=help_, buckets=buckets,
                              labelnames=('tenant',))
            for v in vals:
                hh.observe(v, tenant=str(tid))
    if tenancy is not None:
        _last_tenancy = tenancy
    tl = stats.pop('timeline', None)
    if tl is not None:
        _last_timeline = tl
    # history sampling piggybacks on the publish cadence: host metadata
    # only, a no-op unless MetricsRegistry.enable_history() opted in
    _m.metrics().history_tick()


def _histogram_view(h, scale_ms=True):
    """JSON-ready histogram summary: count/sum/mean + interpolated
    p50/p90/p99 (seconds scaled to ms when scale_ms)."""
    v = h.value()
    pct = h.percentiles((50, 90, 99))
    k = 1000.0 if scale_ms else 1.0
    unit = '_ms' if scale_ms else ''
    out = {'count': v['count'], 'sum': v['sum'],
           f'mean{unit}': (v['sum'] / v['count'] * k) if v['count']
           else None}
    for name, val in pct.items():
        out[f'{name}{unit}'] = val * k if val is not None else None
    return out


def serve_snapshot():
    """JSON-ready view of every ptpu_serve_* metric (None-able: {} when
    the engine never published).
    Histograms carry bucket-interpolated p50/p90/p99; `timeline` is the
    scheduler-timeline summary from the engine's last publish."""
    reg = _m.metrics()
    out = {}
    for name in (_GAUGE_NAMES + _COUNTER_NAMES
                 + tuple(n for n, _h, _k in _TIER_COUNTERS)
                 + tuple(n for n, _h, _k in _TIER_TRANSFER_COUNTERS)):
        m = reg.get(name)
        if m is None:
            continue
        out[name] = m.value()
    h = reg.get('ptpu_serve_ttft_seconds')
    if h is not None:
        out['ptpu_serve_ttft_seconds'] = _histogram_view(h)
    for name, (key, _b, _h) in _SLO_HISTOGRAMS.items():
        m = reg.get(name)
        if m is not None:
            out[name] = _histogram_view(
                m, scale_ms=(key != 'preemptions'))
    # derived rates: prefix hit-rate over lookups, spec
    # acceptance over proposed drafts — None until there is traffic
    if 'ptpu_serve_prefix_hits' in out:
        hits = out['ptpu_serve_prefix_hits']
        total = hits + out.get('ptpu_serve_prefix_misses', 0)
        out['prefix_hit_rate'] = hits / total if total else None
    if 'ptpu_serve_spec_proposed_tokens_total' in out:
        prop = out['ptpu_serve_spec_proposed_tokens_total']
        out['spec_acceptance_rate'] = (
            out.get('ptpu_serve_spec_accepted_tokens_total', 0) / prop
            if prop else None)
    # per-tenant view: the engine's accounting table from
    # the last publish merged with per-tenant histogram percentiles —
    # the per-tenant SLO table
    if out:
        tenants = {}
        if _last_tenancy is not None:
            out['tenancy'] = {k: v for k, v in _last_tenancy.items()
                              if k != 'tenants'}
            tenants = {tid: dict(row) for tid, row in
                       (_last_tenancy.get('tenants') or {}).items()}
        for name, (key, _b, _h) in _TENANT_HISTOGRAMS.items():
            m = reg.get(name)
            if m is None:
                continue
            label = key[:-2]            # queue_wait_s -> queue_wait
            for lkey, child in m._series().items():
                tenants.setdefault(lkey[0], {})[label] = \
                    _histogram_view(child)
        if tenants:
            out['tenants'] = tenants
    if out and _last_timeline is not None:
        out['timeline'] = dict(_last_timeline)
    # serving ledger / goodput / roofline: read the LIVE
    # ledger registry — not the gauges — so engines that unregistered
    # at shutdown stop reporting here; per-tenant goodput folds into
    # the tenants rows beside the SLO percentiles
    led = _serve_ledger.serve_ledger_snapshot()
    if led is not None:
        if led.get('ledger'):
            out['ledger'] = led['ledger']
        good = led.get('goodput')
        if good and good.get('emitted_tokens'):
            out['goodput'] = {k: v for k, v in good.items()
                              if k != 'per_tenant'}
            for tid, row in (good.get('per_tenant') or {}).items():
                dst = out.setdefault('tenants', {}).setdefault(tid, {})
                dst['delivered_tokens'] = row['delivered_tokens']
                dst['wasted_tokens'] = row['wasted_tokens']
        if led.get('roofline'):
            out['roofline'] = led['roofline']
    return out
