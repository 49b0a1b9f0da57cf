"""The port's request tracing, scheduler timeline and stalled-request
watchdog against the JAX package's (tests/test_serving_trace.py):
`Histogram.percentile`, `percentile_of` and `reconstruct` give the
reference's results on the same inputs; journals under preemption,
the JSON-lines and chrome exports, the journal caps, the timeline, the
watchdog's report and abort paths make the same per-request event
sequences and counters as the reference engine on bridged weights; and
tracing adds no host fetch."""
import json
import os

import numpy as np
import pytest

from paddle_tpu.core import monitor as jmonitor
from paddle_tpu.serving import request_trace as jtrace
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.serving import (RequestState, ServingConfig,
                                      ServingEngine, load_trace,
                                      reconstruct)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving import metrics as serve_metrics
from paddle_tpu_torch.serving import request_trace as ttrace
from torch_serving_twin import Twin, model_pair
from torch_threads import one_intra_op_thread  # noqa: F401

PRESSURED = dict(page_size=8, max_batch_size=3, prefill_chunk=8,
                 num_pages=4)


@pytest.fixture(scope='module')
def pair():
    return model_pair(seed=7)


@pytest.fixture(scope='module')
def mixed_prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, 128, n)) for n in (5, 11, 3, 17, 8)]


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('case', ['gamma', 'uniform', 'edges'])
def test_histogram_percentile_equals_reference(case):
    rng = np.random.RandomState(0)
    if case == 'gamma':
        buckets = [float(b) for b in np.linspace(0.0, 1.0, 101)[1:]]
        vals = rng.gamma(2.0, 0.05, 2000)
    elif case == 'uniform':
        buckets = [float(i) for i in range(1, 11)]
        vals = np.arange(10) + 0.5
    else:
        buckets = [1.0, 2.0]
        vals = [100.0, 0.5]
    got, ref = [], []
    for mod, out in ((tmonitor, got), (jmonitor, ref)):
        h = mod.Histogram(f't_pct_{case}', buckets=buckets)
        out.append(h.percentile(50))
        for v in vals:
            h.observe(float(v))
        out += [h.percentile(q) for q in (0, 10, 50, 90, 99, 100)]
        out.append(h.percentiles((50, 90, 99)))
        out.append(h.value())
    assert got == ref
    with pytest.raises(ValueError):
        tmonitor.Histogram('t_pct_bad', buckets=[1.0]).percentile(101)


def test_percentile_of_and_reconstruct_equal_reference():
    rng = np.random.RandomState(1)
    vals = list(rng.rand(37)) + [None, None]
    for q in (0, 1, 50, 90, 99, 100):
        assert ttrace.percentile_of(vals, q) == \
            jtrace.percentile_of(vals, q)
    assert ttrace.percentile_of([None], 50) is None
    # a journal touching every event kind reconstructs alike
    events = [
        {'event': 'submit', 'req': 0, 't': 1.0, 'prompt_tokens': 9,
         'tenant_id': 'a', 'priority': 1, 'deadline_s': 2.0},
        {'event': 'route', 'req': 0, 't': 1.01, 'replica_id': 1,
         'router_decision': 'affinity'},
        {'event': 'quota_defer', 'req': 0, 't': 1.02},
        {'event': 'admit', 'req': 0, 't': 1.1},
        {'event': 'prefix_hit', 'req': 0, 't': 1.11, 'cached_tokens': 8,
         'pages': 1},
        {'event': 'resurrect', 'req': 0, 't': 1.12, 'pages': 1,
         'tokens': 8},
        {'event': 'prefill_chunk', 'req': 0, 't': 1.2, 'tokens': 1,
         'sampled': 1, 'pages': 2},
        {'event': 'first_token', 'req': 0, 't': 1.3,
         'tokens_generated': 1},
        {'event': 'spec_verify', 'req': 0, 't': 1.35, 'proposed': 3,
         'accepted': 1, 'discarded': 1},
        {'event': 'decode', 'req': 0, 't': 1.4, 'tokens_generated': 3},
        {'event': 'fused_decode', 'req': 0, 't': 1.45, 'k': 4,
         'accepted': 2, 'tokens_generated': 5},
        {'event': 'preempt', 'req': 0, 't': 1.5},
        {'event': 'resume', 'req': 0, 't': 1.6},
        {'event': 'prefill_chunk', 'req': 0, 't': 1.7, 'tokens': 14,
         'recompute_tokens': 6, 'sampled': 1, 'pages': 3},
        {'event': 'degrade_stage', 'req': -1, 't': 1.75, 'stage': 1},
        {'event': 'spill', 'req': -1, 't': 1.76, 'pages': 2},
        {'event': 'deadline_miss', 'req': 0, 't': 3.5},
        {'event': 'retire', 'req': 0, 't': 3.5, 'tokens_generated': 6},
        {'event': 'submit', 'req': 1, 't': 2.0, 'prompt_tokens': 3},
        {'event': 'abort', 'req': 1, 't': 2.5, 'reason': 'x'},
    ]
    assert reconstruct(events) == jtrace.reconstruct(events)
    report = ttrace.build_serve_report('r', {'req': 0, 'state': 'running',
                                             'age_s': 3.0},
                                       events, [{'iter': 0}], {}, {0: 2})
    assert ttrace.render_serve_report(report) == \
        jtrace.render_serve_report(report)


# ---------------------------------------------------------------------------
# engine scenarios against the reference engine
# ---------------------------------------------------------------------------
def test_journals_under_preemption(pair, mixed_prompts):
    tw = Twin(pair, tick=1e-3, **PRESSURED)
    # publish on retire and drain only: the periodic publish keys to wall
    # time and would read the engine clock at different sweeps
    tw.ref.PUBLISH_INTERVAL_S = tw.port.PUBLISH_INTERVAL_S = float('inf')
    tw.generate(mixed_prompts, max_new_tokens=6)
    tw.check()
    # the port reads the ticking clock where the reference does, so even
    # the journal timestamps agree
    assert [(e['event'], e['t']) for e in tw.port.tracer.events()] == \
        [(e['event'], e['t']) for e in tw.ref.tracer.events()]
    eng = tw.port
    assert eng.stats()['preemptions_total'] > 0
    for req in eng.scheduler.finished:
        names = [e['event'] for e in eng.tracer.events(req.id)]
        times = [e['t'] for e in eng.tracer.events(req.id)]
        assert times == sorted(times)
        assert names[:2] == ['submit', 'admit'] and names[-1] == 'retire'
        assert names.count('preempt') == names.count('resume') \
            == req.preemptions
    # the journal-derived table is the engine's own stamps, exactly
    table = eng.request_table()
    for req in eng.scheduler.finished:
        r = table[req.id]
        assert r['ttft_s'] == req.first_token_time - req.submit_time
        assert r['queue_wait_s'] == req.admit_time - req.submit_time
        assert r['e2e_s'] == req.finish_time - req.submit_time
        assert r['tokens_generated'] == len(req.generated)
    tw.shutdown()


def test_jsonl_and_chrome_export(pair, mixed_prompts, tmp_path):
    tw = Twin(pair, tick=1e-3, page_size=8, max_batch_size=3,
              prefill_chunk=8)
    tprof.reset_profiler()
    tprof.start_profiler()
    try:
        tw.generate(mixed_prompts[:3], max_new_tokens=4)
    finally:
        tprof.stop_profiler()
    tw.check()
    paths = tw.port.export_trace(jsonl_path=str(tmp_path / 's.jsonl'),
                                 chrome_path=str(tmp_path / 's.json'))
    header, events = load_trace(paths['jsonl'])
    assert header['schema'] == 'paddle_tpu.serve_trace/6'
    assert header['dropped_events'] == 0
    assert reconstruct(events) == tw.port.request_table()
    with open(paths['chrome']) as f:
        evs = json.load(f)['traceEvents']
    assert len({e['tid'] for e in evs
                if e.get('cat') == 'serve_request'}) == 3
    assert {e['args']['name'] for e in evs
            if e.get('name') == 'process_name'} == {
        'serving requests', 'paddle_tpu_torch host'}
    names = {e['name'] for e in evs if e.get('cat') == 'serve'}
    assert {'serve::schedule', 'serve::prefill_chunk', 'serve::decode',
            'serve::compiled_step', 'serve::sample_fetch',
            'serve::prepare'} <= names
    tw.shutdown()


def test_journal_caps(pair):
    tw = Twin(pair, tick=1e-3, page_size=8, max_batch_size=2,
              prefill_chunk=8, trace_events_per_request=4,
              trace_requests=2)
    tw.generate([[1, 2, 3], [4, 5], [6, 7, 8]], max_new_tokens=5)
    tw.check()
    tr = tw.port.tracer
    assert len(tr.traces()) == 2 and tr.dropped_requests == 1
    assert all(len(t.events) <= 4 and t.events[-1]['event'] == 'retire'
               for t in tr.traces())
    assert [t.dropped for t in tr.traces()] == \
        [t.dropped for t in tw.ref.tracer.traces()]
    tw.shutdown()


def test_trace_off_engine_still_serves(pair):
    eng = ServingEngine(pair[1], ServingConfig(
        page_size=8, max_batch_size=2, prefill_chunk=8, trace=False),
        device='cpu')
    assert len(eng.generate([[1, 2, 3]], max_new_tokens=3)[0]) == 6
    assert eng.request_table() == {}
    with pytest.raises(RuntimeError, match='tracing is off'):
        eng.export_trace(jsonl_path='unused.jsonl')
    eng.shutdown()


@pytest.mark.parametrize('capacity', [2048, 4])
def test_timeline(pair, mixed_prompts, capacity):
    tw = Twin(pair, tick=1e-3, **PRESSURED, timeline_capacity=capacity)
    tw.generate(mixed_prompts, max_new_tokens=6)
    tw.check()
    tl, st = tw.port.timeline, tw.port.stats()
    assert tl.summary() == tw.ref.timeline.summary()
    rows = tl.snapshot()
    assert len(rows) == min(capacity, tl.iterations)
    if capacity > tl.iterations:
        assert sum(r['decode_tokens'] for r in rows) == \
            st['decode_tokens_total']
        assert sum(r['admissions'] for r in rows) == \
            len(mixed_prompts) + st['preemptions_total']
    assert len(tl.tail(2)) == 2
    tw.shutdown()


@pytest.mark.parametrize('action', ['report', 'abort'])
def test_watchdog(pair, tmp_path, action):
    tw = Twin(pair, tick=1e-3, page_size=8, max_batch_size=2,
              prefill_chunk=8, request_deadline_s=5.0,
              deadline_action=action, report_dir=str(tmp_path))
    reqs = [tw.submit(p, max_new_tokens=4) for p in ([1, 2, 3], [4, 5])]
    tw.jump(10.0)
    tw.step()
    report = tw.port.last_serve_report
    assert report['kind'] == 'serve_report'
    assert report['schema'] == 'paddle_tpu.serve_trace/6'
    assert report['request']['req'] == reqs[1].id
    assert report['request']['age_s'] > 5.0
    assert {'trace', 'timeline_tail', 'pool', 'pool_census',
            'engine'} <= set(report)
    with open(report['path']) as f:
        assert json.load(f)['request']['deadline_s'] == 5.0
    assert os.path.basename(report['path']) == \
        f'serve_report.req{reqs[1].id}.json'
    tw.port.last_serve_report = None
    tw.drain()
    tw.check()
    assert tw.port.last_serve_report is None        # once a request
    want = (RequestState.ABORTED if action == 'abort'
            else RequestState.FINISHED)
    assert all(r.state == want for r in reqs)
    assert tw.port.pool.pages_in_use == 0
    if action == 'abort':
        assert tw.port.stats()['requests_aborted_total'] == 2
        assert all(tw.port.request_table()[r.id]['state'] == 'aborted'
                   for r in reqs)
    tw.shutdown()


def test_abort_is_terminal_and_no_deadline_no_report(pair):
    tw = Twin(pair, tick=1e-3, page_size=8, max_batch_size=2,
              prefill_chunk=8)
    req = tw.submit([1, 2, 3], max_new_tokens=3)
    tw.jump(1e6)
    tw.drain()
    finish = req.finish_time
    for eng, r in ((tw.ref, tw.reqs[0][0]), (tw.port, req)):
        assert eng.abort(r) is False and eng.abort(r) is False
    assert req.state == RequestState.FINISHED
    assert req.finish_time == finish
    assert tw.port.scheduler.finished.count(req) == 1
    assert tw.port.last_serve_report is None
    tw.check()
    # an operator abort of a waiting request closes its journal
    r2 = tw.submit([5, 6], max_new_tokens=3)
    assert tw.ref.abort(tw.reqs[-1][0]) and tw.port.abort(r2)
    tw.check()
    assert tw.port.tracer.events(r2.id)[-1]['event'] == 'abort'
    tw.shutdown()


def test_metrics_snapshot_percentiles():
    tmonitor.metrics().reset()
    serve_metrics.publish({
        'pool': {}, '_new_ttfts_s': [0.02, 0.04, 0.2],
        '_new_slo': {'queue_wait_s': [0.001], 'tpot_s': [0.003],
                     'e2e_s': [0.5], 'preemptions': [2]},
        'timeline': {'iterations': 3, 'window': 3}})
    snap = serve_metrics.serve_snapshot()
    ttft = snap['ptpu_serve_ttft_seconds']
    assert ttft['count'] == 3
    assert ttft['p50_ms'] <= ttft['p90_ms'] <= ttft['p99_ms']
    assert snap['ptpu_serve_tpot_seconds']['count'] == 1
    assert snap['ptpu_serve_preemptions_per_request']['p99'] >= 1.0
    assert snap['timeline']['iterations'] == 3
    assert 'ptpu_serve_ttft_ms' not in snap
    # the metric history: enabled, the publish cadence samples it
    reg = tmonitor.metrics()
    hist = reg.enable_history(capacity=4, clock=lambda: 1.0)
    try:
        assert reg.enable_history() is hist
        serve_metrics.publish({'pool': {}, '_new_ttfts_s': [0.03]})
        assert hist.snapshot()['samples'] == 1
        assert hist.last('ptpu_serve_ttft_seconds_count') == 4.0
        assert reg.snapshot()['series'][
            'ptpu_serve_ttft_seconds_count']['last'] == 4.0
    finally:
        reg.history = None


@pytest.mark.parametrize('prefill_chunk', [4, 8])
def test_multi_chunk_prompt_fetches_as_the_reference(pair, monkeypatch,
                                                     prefill_chunk):
    """A prompt of several prefill chunks is fetched once, after the
    chunk that completes it, as the JAX engine fetches it
    (paddle_tpu/serving/engine.py:1643-1649): the same host fetches on
    the same stream, and the same tokens."""
    from paddle_tpu import serving as jserving
    from paddle_tpu.serving import engine as jengine_mod
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(1, 128, n)) for n in (23, 4, 17)]
    runs = []
    for mod, make in (
            (jengine_mod, lambda cfg: jserving.ServingEngine(
                pair[0], jserving.ServingConfig(**cfg))),
            (engine_mod, lambda cfg: ServingEngine(
                pair[1], ServingConfig(**cfg), device='cpu'))):
        count = [0]
        real = mod._host_fetch

        def counting(x, count=count, real=real):
            count[0] += 1
            return real(x)
        monkeypatch.setattr(mod, '_host_fetch', counting)
        eng = make(dict(page_size=8, max_batch_size=3,
                        prefill_chunk=prefill_chunk))
        outs = eng.generate(prompts, max_new_tokens=5)
        st = eng.stats()
        runs.append((outs, count[0], st['prefill_chunks_total'],
                     st['decode_steps_total']))
        eng.shutdown()
    (j_outs, j_n, j_chunks, j_steps), (t_outs, t_n, t_chunks, t_steps) = runs
    assert t_outs == j_outs and t_chunks == j_chunks
    assert t_n == j_n == len(prompts) + t_steps
    assert t_chunks > len(prompts)       # the stream has multi-chunk ones


@pytest.mark.parametrize('fused_k', [1, 4])
def test_tracing_adds_no_host_fetch(pair, mixed_prompts, monkeypatch,
                                    fused_k):
    """Every fetch of chosen ids funnels through engine._host_fetch; the
    journals, timeline, SLO accounting, ledger and watchdog add none:
    one fetch per prefill that completes and samples (the JAX engine's
    count), per serial decode step and per fused window, with trace on
    or off."""
    real = engine_mod._host_fetch
    runs = {}
    for trace in (False, True):
        count = [0]

        def counting(x, count=count):
            count[0] += 1
            return real(x)
        monkeypatch.setattr(engine_mod, '_host_fetch', counting)
        eng = ServingEngine(pair[1], ServingConfig(
            **PRESSURED, trace=trace, fused_k=fused_k,
            request_deadline_s=1e9), device='cpu')
        outs = eng.generate(mixed_prompts, max_new_tokens=6)
        st = eng.stats()
        eng.publish_metrics()
        eng.request_table()
        eng.ledger.account()
        runs[trace] = (outs, count[0], st, eng.prefill_fetches)
        eng.shutdown()
    monkeypatch.setattr(engine_mod, '_host_fetch', real)
    (o_off, n_off, _, _), (o_on, n_on, st, pf) = runs[False], runs[True]
    assert o_on == o_off and n_on == n_off
    assert n_on == (pf + st['decode_steps_total']
                    - st['fused_iterations_total']
                    + st['fused_windows_total'])
