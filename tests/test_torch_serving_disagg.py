"""The port's prefill/decode disaggregation against the JAX package's
(tests/test_serving_cluster.py::TestDisaggregation,
test_serving_tenants.py::test_disagg_stage3_arms_both_pools and the
alerts federation case of test_alerts.py): `stream_kv_pages` byte for
byte on the same page contents, `DisaggregatedEngine` on bridged weights
under one call sequence (tokens, stats with the pd_* counters and the
merged prefix and tenancy counters, journals, timeline, goodput), a
cluster of disaggregated LocalReplicas (placements, tokens, the status
goodput fold, the union digest), and the engine's own bars: tokens equal
one unified engine's, streamed pages equal the pages it wrote."""
import numpy as np
import pytest
import torch

from paddle_tpu.core import monitor as jmonitor
from paddle_tpu.serving import KVPagePool as JPool
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving.cluster import ClusterRouter as JRouter
from paddle_tpu.serving.cluster import LocalReplica as JLocal
from paddle_tpu.serving.cluster import build_engine as jbuild_engine
from paddle_tpu.serving.cluster import stream_kv_pages as jstream
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.serving import (KVPagePool, RequestState,
                                      ServingConfig, ServingEngine)
from paddle_tpu_torch.serving.cluster import (ClusterRouter,
                                              DisaggregatedEngine,
                                              LocalReplica, build_engine,
                                              stream_kv_pages)
from torch_serving_twin import FakeClock, Twin, model_pair
from torch_threads import one_intra_op_thread  # noqa: F401

ENGINE_KW = dict(page_size=8, max_batch_size=3, prefill_chunk=16)
DISAGG = dict(ENGINE_KW, disaggregate=True)


@pytest.fixture(scope='module')
def pair():
    return model_pair(seed=5)


def _mixed_prompts():
    """The reference test's stream: two 24-token families, short tails."""
    rng = np.random.RandomState(1)
    fam = [list(rng.randint(1, 128, 24)) for _ in range(2)]
    order = [0, 1, 0, 1, 1, 0, 0, 1, 0, 1]
    return [fam[f] + list(rng.randint(1, 128, int(rng.randint(2, 10))))
            for f in order]


# ---------------------------------------------------------------------------
# stream_kv_pages
# ---------------------------------------------------------------------------
NUM_PAGES, PS, LAYERS, HEADS, HD = 9, 4, 2, 2, 4


def _pools(dtype, seed):
    """A JAX and a port pool of the same shape whose pages hold the same
    random rows (the port's sink row too, which the JAX pool lacks)."""
    jpool = JPool(NUM_PAGES, PS, num_layers=LAYERS, num_heads=HEADS,
                  head_dim=HD, dtype=dtype)
    jpool.materialize()
    tpool = KVPagePool(NUM_PAGES, PS, num_layers=LAYERS, num_heads=HEADS,
                       head_dim=HD, dtype=dtype)
    tpool.materialize('cpu')
    rng = np.random.RandomState(seed)
    jkv = []
    for layer in tpool.kv:
        bufs = []
        for t in layer:
            if t.dtype == torch.int8:
                vals = rng.randint(-127, 128, tuple(t.shape)).astype(np.int8)
            else:
                vals = rng.randn(*t.shape).astype(np.float32)
            t.copy_(torch.from_numpy(vals))
            bufs.append(vals[:NUM_PAGES])
        jkv.append(tuple(bufs))
    import jax.numpy as jnp
    jpool.kv = [tuple(jnp.asarray(b) for b in layer) for layer in jkv]
    return jpool, tpool


def _streamed_counts(mon):
    reg = mon.metrics()
    return tuple(reg.get(n).value() if reg.get(n) is not None else 0
                 for n in ('ptpu_serve_pd_streamed_pages_total',
                           'ptpu_serve_pd_streamed_bytes_total'))


@pytest.mark.parametrize('chunk', [0, 1, 2, 3])
@pytest.mark.parametrize('dtype', ['float32', 'int8'])
def test_stream_kv_pages_equals_reference(dtype, chunk):
    """Every buffer (an int8 pool's fp32 scales too) equals the JAX
    stream's byte for byte, the port's sink row is untouched, and both
    count the same pages and bytes."""
    jsrc, tsrc = _pools(dtype, seed=1)
    jdst, tdst = _pools(dtype, seed=2)
    sink = [[t[NUM_PAGES].clone() for t in layer] for layer in tdst.kv]
    src_pages, dst_pages = [3, 0, 7, 5, 1], [2, 8, 4, 0, 6]
    jbefore, tbefore = _streamed_counts(jmonitor), _streamed_counts(monitor)
    jout = jstream(jsrc.kv, jdst.kv, src_pages, dst_pages,
                   chunk_pages=chunk)
    tout = stream_kv_pages(tsrc.kv, tdst.kv, src_pages, dst_pages,
                           chunk_pages=chunk)
    assert tout is tdst.kv and len(tout) == len(jout) == LAYERS
    nbufs = 4 if dtype == 'int8' else 2
    for jl, tl, sl in zip(jout, tout, sink):
        assert len(jl) == len(tl) == nbufs
        for jb, tb, sb in zip(jl, tl, sl):
            got = tb.numpy()
            assert got.dtype == np.asarray(jb).dtype
            assert got[:NUM_PAGES].tobytes() == np.asarray(jb).tobytes()
            assert torch.equal(tb[NUM_PAGES], sb)
    jd = np.subtract(_streamed_counts(jmonitor), jbefore)
    td = np.subtract(_streamed_counts(monitor), tbefore)
    assert list(td) == list(jd) and td[0] == len(src_pages)


@pytest.mark.parametrize('case', ['empty', 'mismatch', 'sink'])
def test_stream_kv_pages_edges(case):
    """An empty list returns dst unchanged and counts nothing; lists of
    different lengths raise ValueError, as in the reference; a
    destination at the sink page raises (the port never writes it)."""
    jsrc, tsrc = _pools('float32', seed=1)
    jdst, tdst = _pools('float32', seed=2)
    before = [[t.clone() for t in layer] for layer in tdst.kv]
    if case == 'empty':
        counts = _streamed_counts(monitor)
        assert stream_kv_pages(tsrc.kv, tdst.kv, [], []) is tdst.kv
        assert jstream(jsrc.kv, jdst.kv, [], []) is jdst.kv
        assert _streamed_counts(monitor) == counts
    elif case == 'mismatch':
        with pytest.raises(ValueError, match='mismatch'):
            jstream(jsrc.kv, jdst.kv, [1, 2], [3])
        with pytest.raises(ValueError, match='mismatch'):
            stream_kv_pages(tsrc.kv, tdst.kv, [1, 2], [3])
    else:
        with pytest.raises(ValueError, match='sink'):
            stream_kv_pages(tsrc.kv, tdst.kv, [1, 2], [3, NUM_PAGES])
    for layer, old in zip(tdst.kv, before):
        for t, o in zip(layer, old):
            assert torch.equal(t, o)


# ---------------------------------------------------------------------------
# DisaggregatedEngine against the JAX package's, one call sequence
# ---------------------------------------------------------------------------
PD_KEYS = ('pd_disaggregated', 'pd_handoffs_total',
           'pd_streamed_pages_total', 'pd_pending', 'pd_prefill_pool')
TENANTS = {'hi': {'priority': 2}, 'lo': {'priority': 0}}


def _run_mixed(tw):
    return tw.generate(_mixed_prompts(), max_new_tokens=8)


def _run_shared(tw):
    shared = list(range(1, 25))                 # three full pages
    rng = np.random.RandomState(2)
    return tw.generate([shared + list(rng.randint(1, 128, n))
                        for n in (3, 9, 5, 12, 7, 2)], max_new_tokens=6)


def _run_pressure(tw):
    """A 10-page decode pool under tenants: decode-side preemptions, and
    'lo' handoffs deferred while 'hi' residents hold the pages."""
    rng = np.random.RandomState(4)
    for i, n in enumerate((20, 18, 22, 17, 19, 21)):
        tw.submit(list(rng.randint(1, 128, n)), max_new_tokens=12,
                  tenant_id='hi' if i < 3 else 'lo')
    tw.drain()


def _run_deadline(tw):
    """The facade's deadline gate over both backlogs, once a decode rate
    exists: an unmeetable deadline is refused (both packages count the
    rejection on the decode engine and the tenant's row), a generous one
    is served."""
    rng = np.random.RandomState(6)
    tw.generate([list(rng.randint(1, 128, 6))], max_new_tokens=4)
    tw.submit(list(rng.randint(1, 128, 9)), max_new_tokens=8,
              tenant_id='lo')
    with pytest.raises(Exception) as ei:
        tw.submit(list(rng.randint(1, 128, 5)), max_new_tokens=4,
                  tenant_id='hi', deadline_s=1e-9)
    assert getattr(ei.value, 'reason', None) == 'deadline_unmet'
    tw.submit(list(rng.randint(1, 128, 5)), max_new_tokens=4,
              tenant_id='hi', deadline_s=1e9)
    tw.drain()


def _run_abort(tw):
    """Abort a request still queued for prefill, one prefilled and
    pending a decode slot, and one decoding."""
    rng = np.random.RandomState(7)
    prompts = [list(rng.randint(1, 128, n)) for n in (12, 14, 11, 13)]
    for p in prompts:
        tw.submit(p, max_new_tokens=10)
    tw.step()
    (r_dec, p_dec), (r_pend, p_pend), (r_wait, p_wait), _ = tw.reqs
    assert r_dec in tw.ref.decode.scheduler.slots
    assert p_dec in tw.port.decode.scheduler.slots
    assert p_pend in tw.port._pending and r_pend in tw.ref._pending
    assert p_wait in tw.port.prefill.scheduler.waiting
    assert r_wait in tw.ref.prefill.scheduler.waiting
    for r, p in ((r_wait, p_wait), (r_pend, p_pend), (r_dec, p_dec)):
        assert tw.ref.abort(r) is True and tw.port.abort(p) is True
    tw.drain()


SCENARIOS = {
    'mixed': (_run_mixed, {}),
    'shared_prefix': (_run_shared, {}),
    'int8_kv': (_run_mixed, dict(kv_dtype='int8')),
    'pressure': (_run_pressure, dict(num_pages=10, tenants=TENANTS)),
    'deadline': (_run_deadline, dict(tenants=TENANTS)),
    'abort': (_run_abort, dict(max_batch_size=1, prefill_slots=2)),
}


@pytest.fixture(scope='module')
def twins(pair):
    out = {}
    for name, (run, kw) in SCENARIOS.items():
        tw = Twin(pair, **{**DISAGG, **kw})
        run(tw)
        out[name] = tw
    yield out
    for tw in out.values():
        tw.shutdown()


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_disaggregated_engine_equals_reference(twins, name):
    """Tokens, request states, stats (the merged prefix and tenancy
    counters included), pool counters, ladder, journals across the
    handoff, the decode timeline and both engines' goodput equal the JAX
    DisaggregatedEngine's; and the pd_* record too."""
    tw = twins[name]
    tw.check()
    rs, ps = tw.ref.stats(), tw.port.stats()
    for k in PD_KEYS:
        assert ps[k] == rs[k], (k, ps[k], rs[k])
    assert ps['pd_pending'] == 0 and ps['pd_prefill_pool'][
        'pages_in_use'] == 0


@pytest.mark.parametrize('name,key,check', [
    ('mixed', 'pd_handoffs_total', lambda v, tw: v == 10),
    ('shared_prefix', 'pd_streamed_pages_total',
     lambda v, tw: v < sum(len(r.prompt) // 8 for r, _p in tw.reqs)),
    ('pressure', 'preemptions_total', lambda v, tw: v > 0),
    ('deadline', 'deadline_rejects_total', lambda v, tw: v == 1),
    # the queued request aborts on the prefill engine, which counts it
    ('abort', 'requests_aborted_total', lambda v, tw: v == 2 and tw.port
     .prefill.stats()['requests_aborted_total'] == 1),
])
def test_disaggregated_scenario_exercises_its_path(twins, name, key, check):
    """Each scenario reaches what it is named for: every request handed
    off; decode-side prefix sharing streams fewer pages than the prompts
    hold; the small pool preempts; the facade's gate refuses once; the
    three aborts land."""
    tw = twins[name]
    assert check(tw.port.stats()[key], tw), (key, tw.port.stats()[key])


def test_pressure_scenario_defers_a_handoff(pair):
    """With every decode resident of a higher class, a 'lo' request's
    handoff waits on the prefill side (it keeps its prefill slot and
    pages) instead of raising PoolExhausted; the stream still ends."""
    tw = Twin(pair, **{**DISAGG, **SCENARIOS['pressure'][1]})
    deferred = {'ref': 0, 'port': 0}
    for tag in deferred:
        eng = getattr(tw, tag)
        real = eng._handoff

        def counted(req, eng=eng, real=real, tag=tag):
            before = eng._handoffs
            real(req)
            deferred[tag] += eng._handoffs == before
        eng._handoff = counted
    _run_pressure(tw)
    assert deferred['port'] == deferred['ref'] > 0
    tw.check()
    tw.shutdown()


@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
def test_disaggregated_tokens_and_pages_equal_one_engine(pair, kv_dtype):
    """Greedy tokens equal one unified port engine's, and a request's
    full prompt pages in the decode pool equal, byte for byte, the pages
    the unified engine wrote (int8 payload and scales)."""
    _jm, tm = pair
    kw = dict(ENGINE_KW, kv_dtype=kv_dtype)
    prompts = _mixed_prompts()
    uni = ServingEngine(tm, ServingConfig(**kw), device='cpu')
    want = uni.generate(prompts, max_new_tokens=8, top_k=0)
    dis = DisaggregatedEngine(tm, ServingConfig(
        disaggregate=True, stream_chunk_pages=2, **kw), device='cpu')
    assert dis.generate(prompts, max_new_tokens=8, top_k=0) == want
    prompt = list(np.random.RandomState(3).randint(1, 128, 29))
    ru, rd = uni.submit(prompt, max_new_tokens=4), dis.submit(
        prompt, max_new_tokens=4)
    while ru.state != RequestState.RUNNING:
        uni.step()
    while rd.state != RequestState.RUNNING or rd not in \
            dis.decode.scheduler.slots:
        dis.step()
    upages = uni.pool.page_table(ru.id)
    dpages = dis.decode.pool.page_table(rd.id)
    n_full = len(prompt) // kw['page_size']
    for lu, ld in zip(uni.pool.kv, dis.decode.pool.kv):
        for bu, bd in zip(lu, ld):
            for pu, pd_ in zip(upages[:n_full], dpages[:n_full]):
                assert torch.equal(bu[pu], bd[pd_])
    uni.shutdown()
    dis.shutdown()


def test_disagg_stage3_arms_both_pools(pair):
    """One ladder for the pipeline: a stage-3 transition observed by
    either engine arms weighted eviction on both pools, and the walk back
    down disarms both (test_serving_tenants.py, on the port)."""
    _jm, tm = pair
    d = DisaggregatedEngine(tm, ServingConfig(
        page_size=8, max_batch_size=2, prefill_chunk=8, disaggregate=True,
        clock=FakeClock(),
        tenants={'a': {'weight': 0.2}, 'b': {'weight': 2.0}},
        degrade=True, degrade_window=1, degrade_up=(0.1, 0.2, 0.3),
        degrade_down=(0.01, 0.02, 0.03), degrade_hold=1), device='cpu')
    assert d.prefill._ladder is d.decode._ladder
    d.decode.pool.utilization = lambda: 0.95
    for _ in range(3):
        d.decode._observe_pressure()
    assert d.decode.degrade_stage() == 3
    assert d.decode.pool._evict_weights is not None
    assert d.prefill.pool._evict_weights is not None
    d.decode.pool.utilization = lambda: 0.0
    for _ in range(12):
        d.decode._observe_pressure()
    assert d.decode.degrade_stage() < 3
    assert d.decode.pool._evict_weights is None
    assert d.prefill.pool._evict_weights is None
    d.prefill.pool.utilization = lambda: 0.95
    while d.prefill.degrade_stage() < 3:
        d.prefill._observe_pressure()
    assert d.prefill.pool._evict_weights is not None
    assert d.decode.pool._evict_weights is not None
    d.shutdown()


def test_serving_engine_refuses_disaggregate_config(pair):
    _jm, tm = pair
    with pytest.raises(ValueError, match='disaggregate'):
        ServingEngine(tm, ServingConfig(**DISAGG), device='cpu')


def test_engines_share_one_journal_and_take_their_own_ledger_site(pair):
    """The prefill engine writes into the decode engine's tracer under
    its clock, keeps deadline admission off, and reports on its own
    ledger site, as the reference's does."""
    _jm, tm = pair
    d = DisaggregatedEngine(tm, ServingConfig(**DISAGG), device='cpu')
    assert d.prefill.tracer is d.decode.tracer
    assert d.prefill._clock is d.decode._clock
    assert d.prefill.deadline_admission is False
    assert d.decode.deadline_admission is True
    assert (d.prefill.ledger_site, d.decode.ledger_site) == (
        'serve_prefill', 'serve')
    assert d.prefill.config.max_batch_size == d.config.prefill_slots
    assert d.prefill.config.trace is False
    d.shutdown()


# ---------------------------------------------------------------------------
# a cluster of disaggregated replicas
# ---------------------------------------------------------------------------
def _dcluster(pkg, pair, prompts):
    if pkg == 'jax':
        model, build, Local, Router = pair[0], (
            lambda m, **kw: jbuild_engine(m, JConfig(**kw))), JLocal, JRouter
    else:
        model, build, Local, Router = pair[1], (
            lambda m, **kw: build_engine(m, ServingConfig(**kw),
                                         device='cpu')), LocalReplica, \
            ClusterRouter
    reps = [Local(build(model, **DISAGG), rid) for rid in ('d0', 'd1')]
    router = Router(reps, page_size=8, max_queue=32,
                    refresh_interval_s=3600.0)
    outs = router.serve(prompts, max_new_tokens=8, top_k=0)
    router.refresh()
    statuses = [r.status() for r in reps]
    rec = dict(outs=outs, placements=router.snapshot()['placements'],
               decisions=[(v['replica_id'], v['router_decision'])
                          for _k, v in sorted(router.request_slo().items())],
               goodput=[s['goodput'] for s in statuses],
               digest=[sorted(s['prefix_digest']) for s in statuses],
               pools=[(sorted(r.engine.prefill.pool.prefix_chain_hashes()),
                       sorted(r.engine.decode.pool.prefix_chain_hashes()))
                      for r in reps],
               pd=[{k: r.engine.stats()[k] for k in PD_KEYS} for r in reps])
    router.shutdown()
    return rec


@pytest.fixture(scope='module')
def dclusters(pair):
    prompts = _mixed_prompts()
    return {pkg: _dcluster(pkg, pair, prompts) for pkg in ('jax', 'port')}


@pytest.mark.parametrize('key', ['outs', 'placements', 'decisions',
                                 'goodput', 'digest', 'pd'])
def test_disaggregated_cluster_equals_reference(dclusters, key):
    assert dclusters['port'][key] == dclusters['jax'][key]


def test_disaggregated_cluster_equals_one_engine(pair, dclusters):
    """Tokens equal one unified engine's, affinity hits happen, each
    replica's digest is the union of its two pools, and the goodput
    fold counts the prefill engine's prompt positions."""
    rec = dclusters['port']
    uni = ServingEngine(pair[1], ServingConfig(**ENGINE_KW), device='cpu')
    assert rec['outs'] == uni.generate(_mixed_prompts(), max_new_tokens=8,
                                       top_k=0)
    uni.shutdown()
    assert rec['placements']['affinity'] > 0
    for digest, (pre, dec) in zip(rec['digest'], rec['pools']):
        assert digest == sorted(set(pre) | set(dec)) and pre and dec
    for g in rec['goodput']:
        assert g['emitted_tokens'] == g['delivered_tokens'] + \
            g['wasted_tokens'] > 0


def _federate(pkg, pair, disaggregate):
    """test_alerts.py's federation case: replicas built through
    build_engine, one serve, one cluster scrape."""
    t = [0.0]
    if pkg == 'jax':
        model, Local, Router, mon = pair[0], JLocal, JRouter, jmonitor
        reps = [Local(jbuild_engine(model, JConfig(
            disaggregate=disaggregate, **ENGINE_KW)), f'r{i}',
            clock=lambda: t[0]) for i in range(2)]
    else:
        model, Local, Router, mon = pair[1], LocalReplica, ClusterRouter, \
            monitor
        reps = [Local(build_engine(model, ServingConfig(
            disaggregate=disaggregate, **ENGINE_KW), device='cpu'),
            f'r{i}', clock=lambda: t[0]) for i in range(2)]
    router = Router(reps, page_size=8, hang_timeout_s=20.0,
                    refresh_interval_s=0.0, clock=lambda: t[0])
    outs = router.serve([[1, 2, 3], [4, 5, 6], [7, 8, 9], [2, 4, 6]],
                        max_new_tokens=4, top_k=0)
    text = router.cluster_prometheus_text()
    rec = dict(outs=outs, routed=[router._routed_count[r.replica_id]
                                  for r in reps],
               series=sorted(line.split(' ')[0]
                             for line in text.splitlines()
                             if line.startswith('ptpu_')),
               # the process-global registry holds no replica-labeled
               # serve series (read off the registry: rendering it whole
               # would also render what earlier tests left there)
               local='replica' in getattr(mon.metrics().get(
                   'ptpu_serve_decode_tokens_total'), 'labelnames', ()))
    router.shutdown()
    return rec


@pytest.mark.parametrize('disaggregate', [False, True],
                         ids=['unified', 'disaggregated'])
def test_federation_through_build_engine_equals_reference(pair,
                                                          disaggregate):
    got = _federate('port', pair, disaggregate)
    want = _federate('jax', pair, disaggregate)
    assert got == want
    assert min(got['routed']) > 0 and not got['local']
    for rid in ('r0', 'r1'):
        assert f'ptpu_serve_decode_tokens_total{{replica="{rid}"}}' in \
            got['series']
