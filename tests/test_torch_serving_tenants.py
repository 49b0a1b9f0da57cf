"""The port's multi-tenant serving against the JAX package's
(tests/test_serving_tenants.py): the token bucket, the tenant table, the
priority scheduler, the degradation ladder and weighted eviction take
the same call sequences and give equal results; and engine scenarios —
quota deferral and refill, deadline admission, charged preemption, the
yield to a higher priority, forced overload walking the ladder up and
down, the spec shed, the untenanted identity, the adversarial heavy +
light mix and a tenanted trace export — make the same decisions: greedy
tokens, stats counters, ladder transitions, per-tenant rows, per-request
trace events and the goodput account (torch_serving_twin.Twin.check)."""
import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import AdmissionRejected
from paddle_tpu_torch.serving.request_trace import load_trace, reconstruct
from torch_serving_twin import FakeClock, Twin, model_pair
from torch_threads import one_intra_op_thread  # noqa: F401

PAGES8 = dict(page_size=8, max_batch_size=2, prefill_chunk=8)


@pytest.fixture(scope='module')
def pair():
    return model_pair(seed=11)


def _both(name):
    return getattr(jserving, name), getattr(tserving, name)


# ---------------------------------------------------------------------------
# units: the same call sequence, equal results
# ---------------------------------------------------------------------------
def _bucket_calls(TokenBucket):
    clk = FakeClock()
    b = TokenBucket(rate=2.0, burst=10.0, clock=clk)
    out = [b.level, b.try_debit(8), b.level, b.try_debit(8),
           b.seconds_until(8)]
    clk.now += 3.0
    out += [b.try_debit(8), b.level]
    clk.now += 100.0
    out += [b.level, b.try_debit(25), b.level, b.try_debit(1),
            b.seconds_until(1)]
    b.charge(5)
    out += [b.level, TokenBucket(rate=0.0, burst=1.0, clock=clk)
            .seconds_until(5)]
    return out


def _table_calls(TenantTable):
    t = TenantTable({'a': {'priority': 3, 'quota_tokens_per_s': 5.0,
                           'burst_tokens': 7.0, 'weight': 0.5},
                     'b': {}}, clock=FakeClock())
    out = [t.priority_of('a'), t.priority_of('b'), t.priority_of('zz'),
           t.priority_of(None), t.bucket('a').burst, t.bucket('b'),
           t.bucket(None), t.weight_of('a'), t.weight_of('zzz'),
           t.eviction_weights(), t.tenants(), 'a' in t, 'c' in t,
           t.policy('a')]
    try:
        TenantTable({'a': {'prio': 1}})
    except ValueError as e:
        out.append(str(e))
    return out


def _scheduler_calls(Scheduler, Request):
    s = Scheduler(3, clock=FakeClock(tick=1e-3))
    reqs = [Request([i + 1], priority=p)
            for i, p in enumerate((0, 2, 0, 1, 1))]
    for r in reqs:
        s.submit(r)
    order = lambda rs: [reqs.index(r) for r in rs]     # noqa: E731
    out = [order(s.admission_order())]
    out.append(order(s.admit(limit=2)))
    out.append(order(s.admission_order()))
    out.append(order(s.admit()))
    out.append(order(s.running()))
    for below in (None, 0, 1, 2, 3):
        v = s.preempt_victim(below_priority=below)
        out.append(None if v is None else reqs.index(v))
    v = s.preempt_victim(exclude=reqs[3], below_priority=2)
    out.append(reqs.index(v))
    s.preempt(reqs[1])
    out.append(order(s.admission_order()))
    out.append((s.abort(reqs[4]), s.abort(reqs[4]), reqs[4].state))
    out.append((s.abort(reqs[2]), reqs[2].state, reqs[2].finish_time))
    out.append((s.occupancy(), s.quiescent(), s.has_work, s.preemptions))
    return out


def _ladder_calls(DegradeLadder):
    out = []
    lad = DegradeLadder(window=2, up=(0.5, 0.7, 0.9), down=(0.3, 0.5, 0.7),
                        hold=3, clock=FakeClock(tick=1.0))
    for sig in [(1.0, 8, 2)] * 6 + [(0.0, 0, 2)] * 11 + [(0.6, 1, 2)] * 5:
        out.append(lad.would_transition(
            DegradeLadder.pressure_of(*sig), 3))
        out.append(lad.observe(*sig))
        out.append((lad.stage, lad.pressure()))
    band = DegradeLadder(window=1, up=(0.8, 0.9, 0.95),
                         down=(0.4, 0.6, 0.8), hold=2, clock=FakeClock())
    band.observe(0.85, 0, 4)
    for _ in range(20):
        band.observe(0.6, 0, 4)
    out += [lad.history, lad.transitions, band.stage, band.transitions,
            DegradeLadder.pressure_of(0.9, 0, 4),
            DegradeLadder.pressure_of(0.1, 8, 4),
            DegradeLadder.pressure_of(0.2, 2, 4),
            DegradeLadder.pressure_of(0.2, 0, 4, spill=0.95)]
    for up, down in (((0.5, 0.6, 0.7), (0.5, 0.5, 0.6)), ((0.5,), (0.4,))):
        try:
            DegradeLadder(up=up, down=down)
        except ValueError as e:
            out.append(str(e))
    return out


def _eviction_calls(KVPagePool):
    out = []
    for weights in ({'heavy': 0.1, 'light': 1.0}, None):
        pool = KVPagePool(num_pages=4, page_size=2, prefix_cache=True)
        for seq, toks, owner in (('L', [1, 2, 3, 4], 'light'),
                                 ('H', [9, 8, 7, 6], 'heavy')):
            pool.ensure_capacity(seq, len(toks))
            pool.register_prefix(seq, toks, len(toks), owner=owner)
            pool.release(seq)
        pool.set_eviction_weights(weights)
        pool.ensure_capacity('new', 2)
        out.append((pool._match_pages([9, 8, 7, 6]),
                    pool._match_pages([1, 2, 3, 4]),
                    pool.stats()['weighted_eviction']))
        pool.set_eviction_weights(None)
        pool.ensure_capacity('new2', 4)
        out.append((pool._match_pages([9, 8, 7, 6]),
                    pool._match_pages([1, 2, 3, 4]), pool.cached_pages,
                    pool.prefix_evictions, pool.reclaimable_pages('new2'),
                    pool.capacity_tokens('new2'), pool.census()))
    return out


@pytest.mark.parametrize('unit', ['bucket', 'table', 'scheduler', 'ladder',
                                  'eviction'])
def test_units_equal_reference(unit):
    if unit == 'bucket':
        ref, got = (_bucket_calls(c) for c in _both('TokenBucket'))
    elif unit == 'table':
        ref, got = (_table_calls(c) for c in _both('TenantTable'))
    elif unit == 'scheduler':
        ref, got = (_scheduler_calls(s, r) for s, r in zip(
            _both('Scheduler'), _both('Request')))
    elif unit == 'ladder':
        ref, got = (_ladder_calls(c) for c in _both('DegradeLadder'))
    else:
        ref, got = (_eviction_calls(c) for c in _both('KVPagePool'))
    assert got == ref


# ---------------------------------------------------------------------------
# engine scenarios against the reference engine
# ---------------------------------------------------------------------------
def _rand(seed, n, lo=4, hi=None):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 128, lo if hi is None else
                             rng.randint(lo, hi + 1)))
            for _ in range(n)]


def test_quota_defers_then_admits_on_refill(pair):
    tw = Twin(pair, **PAGES8,
              tenants={'bulk': {'quota_tokens_per_s': 1.0,
                                'burst_tokens': 10.0}})
    p1, p2 = _rand(0, 2)
    r1 = tw.submit(p1, max_new_tokens=4, tenant_id='bulk')
    r2 = tw.submit(p2, max_new_tokens=4, tenant_id='bulk')
    tw.step(6)
    assert r1.state in ('running', 'finished', 'prefill')
    assert r2.state == 'waiting' and r2.quota_deferred
    assert r2.quota_defers == 1
    tw.check()
    tw.jump(20.0)
    tw.drain()
    tw.check()
    row = tw.port.stats()['tenancy']['tenants']['bulk']
    assert row['quota_deferrals'] == 1 and row['tokens_billed'] == 16
    # a resume after preemption never re-debits
    r3 = tw.submit(_rand(1, 1)[0], max_new_tokens=4, tenant_id='bulk')
    tw.jump(20.0)
    tw.step(2)
    for eng, req in ((tw.ref, tw.reqs[-1][0]), (tw.port, r3)):
        eng.pool.release(req.id)
        eng.scheduler.preempt(req)
    tw.drain()
    tw.check()
    assert tw.port.stats()['tenancy']['tenants']['bulk'][
        'tokens_billed'] == 24
    tw.shutdown()


def test_deadline_admission_and_miss(pair):
    # the decode rate the estimate divides by is measured wall time and
    # differs between the engines: each engine's rate is pinned, so the
    # estimate (pending tokens / rate) is a pure function of decisions
    tw = Twin(pair, tick=1e-3, **PAGES8, tenants={})
    r = tw.submit(_rand(2, 1)[0], max_new_tokens=4, deadline_s=1e-9,
                  tenant_id='t')
    tw.drain()
    assert r.state == 'finished'
    for eng in (tw.ref, tw.port):
        eng._decode_time, eng._decode_tokens = 1.0, 100
    backlog = [tw.submit(p, max_new_tokens=16) for p in _rand(3, 3, 8)]
    with pytest.raises(AdmissionRejected) as ei:
        tw.submit(_rand(4, 1)[0], max_new_tokens=4, deadline_s=1e-9,
                  tenant_id='t')
    assert ei.value.reason == 'deadline_unmet'
    assert ei.value.retry_after_s > 0
    tw.submit(_rand(5, 1)[0], max_new_tokens=4, deadline_s=1e9)
    tw.drain()
    assert all(b.state == 'finished' for b in backlog)
    tw.check()
    st = tw.port.stats()
    assert st['deadline_rejects_total'] == 1
    assert st['deadline_misses_total'] == 1
    assert tw.port.request_table()[r.id]['deadline_miss'] is True
    tw.shutdown()


def test_charged_preemption(pair):
    tw = Twin(pair, page_size=8, max_batch_size=2, prefill_chunk=8,
              num_pages=3, max_pages_per_seq=3, degrade=False,
              tenants={'low': {'priority': 0},
                       'high': {'priority': 2,
                                'quota_tokens_per_s': 1000.0,
                                'burst_tokens': 1000.0}})
    lo = tw.submit(_rand(3, 1, 8)[0], max_new_tokens=12, tenant_id='low')
    tw.step(3)
    hi = tw.submit(_rand(4, 1, 8)[0], max_new_tokens=12, tenant_id='high')
    tw.drain()
    tw.check()
    assert lo.preemptions >= 1 and hi.preemptions == 0
    row = tw.port.stats()['tenancy']['tenants']['high']
    assert row['preemptions_charged'] >= 1 and row['charge_tokens'] >= 1
    tw.shutdown()


def test_low_priority_yields(pair):
    tw = Twin(pair, page_size=8, max_batch_size=2, prefill_chunk=8,
              num_pages=6, max_pages_per_seq=4, degrade=False,
              tenants={'hi': {'priority': 2}, 'lo': {'priority': 0}})
    rng = np.random.RandomState(13)
    hi = tw.submit(list(rng.randint(1, 128, 24)), max_new_tokens=8,
                   tenant_id='hi')
    lo = tw.submit(list(rng.randint(1, 128, 8)), max_new_tokens=17,
                   tenant_id='lo')
    tw.drain()
    tw.check()
    assert hi.preemptions == 0 and lo.preemptions >= 1
    assert any(e.get('reason') == 'yield_to_higher_priority'
               for e in tw.port.tracer.events(lo.id))
    tw.shutdown()


def test_forced_overload_walks_the_ladder(pair):
    tw = Twin(pair, page_size=8, max_batch_size=2, prefill_chunk=16,
              num_pages=6, max_pages_per_seq=4,
              tenants={'a': {'weight': 0.2}, 'b': {'weight': 2.0}},
              degrade=True, degrade_window=2, degrade_up=(0.5, 0.7, 0.9),
              degrade_down=(0.2, 0.3, 0.4), degrade_hold=2)
    for i, p in enumerate(_rand(4, 8, 8)):
        tw.submit(p, max_new_tokens=8, tenant_id='a' if i % 2 else 'b')
    tw.drain()
    tw.check()
    ups = [h['to'] for h in tw.port.ladder_history() if h['to'] > h['from']]
    assert ups == [1, 2, 3]
    assert tw.port.pool._evict_weights is not None
    # the halved chunk ran: a prefill_chunk event of 8 tokens at stage 2
    assert any(e['event'] == 'prefill_chunk' and e['tokens'] == 8
               for e in tw.port.tracer.events())
    tw.step(20)
    tw.check()
    assert tw.port.degrade_stage() == 0
    assert tw.port.pool._evict_weights is None
    tw.shutdown()


def test_spec_shed_is_token_invariant(pair):
    prompts = [[7, 8, 9] * 5, [3, 4] * 6]
    base = Twin(pair, **PAGES8, spec_k=4)
    ref = base.generate(prompts, max_new_tokens=8)
    base.check()
    assert base.port.stats()['spec_proposed_tokens_total'] > 0
    base.shutdown()
    shed = Twin(pair, **PAGES8, spec_k=4, degrade=True, tenants={},
                degrade_hold=10 ** 9)
    shed.ref._ladder.stage = shed.port._ladder.stage = 1
    assert shed.generate(prompts, max_new_tokens=8) == ref
    shed.check()
    assert shed.port.stats()['spec_proposed_tokens_total'] == 0
    assert shed.port.ledger.goodput()['spec_shed_tokens'] > 0
    shed.shutdown()


def test_untenanted_engine_is_unchanged(pair):
    """No tenants: no table, no ladder, FCFS decisions — the same tokens
    and stats as the reference and as a trace-off port engine."""
    prompts = _rand(5, 3, 3, 11)
    tw = Twin(pair, page_size=8, max_batch_size=3, prefill_chunk=8)
    outs = tw.generate(prompts, max_new_tokens=6)
    tw.check()
    assert tw.port._tenants is None and tw.port._ladder is None
    st = tw.port.stats()
    assert st['tenancy']['enabled'] is False and st['degrade_stage'] == 0
    off = tserving.ServingEngine(pair[1], tserving.ServingConfig(
        page_size=8, max_batch_size=3, prefill_chunk=8, trace=False),
        device='cpu')
    assert off.generate(prompts, max_new_tokens=6) == outs
    off.shutdown()
    tw.shutdown()


def test_adversarial_mix(pair):
    """One heavy tenant saturating the slots, light tenants arriving
    after 3 steps (tests/test_serving_tenants.py TestAdversarialMix):
    both engines decide alike under FCFS and under the SLO map, and the
    port meets the leg's bars on sweep-counted throughput."""
    rng = np.random.RandomState(10)
    heavy = [list(rng.randint(1, 128, 12)) for _ in range(6)]
    light = [list(rng.randint(1, 128, 4)) for _ in range(6)]
    ten = {'heavy': {'priority': 0}, 'light0': {'priority': 1},
           'light1': {'priority': 1}, 'light2': {'priority': 1}}
    tick = dict(tick=1e-6)
    solo = Twin(pair, **tick, **PAGES8)
    sreqs = [solo.submit(p, max_new_tokens=4) for p in light]
    solo.drain()
    solo.check()
    solo_p99 = max(r.finish_time - r.submit_time for r in sreqs)
    solo.shutdown()
    res = {}
    for name, tenants in (('fcfs', None), ('slo', ten)):
        tw = Twin(pair, **tick, **PAGES8, tenants=tenants)
        hreqs = [tw.submit(p, max_new_tokens=16, tenant_id='heavy')
                 for p in heavy]
        tw.step(3)
        lreqs = [tw.submit(p, max_new_tokens=4, tenant_id=f'light{i % 3}')
                 for i, p in enumerate(light)]
        steps = tw.drain()
        tw.check()
        res[name] = (max(r.finish_time - r.submit_time for r in lreqs),
                     sum(len(r.generated) for r in hreqs + lreqs)
                     / (steps + 3))
        tw.shutdown()
    assert res['slo'][0] <= 1.5 * solo_p99
    assert res['slo'][1] >= 0.9 * res['fcfs'][1]
    assert res['fcfs'][0] > res['slo'][0]


def test_tenant_trace_export(pair, tmp_path):
    tw = Twin(pair, **PAGES8,
              tenants={'bulk': {'priority': 0, 'quota_tokens_per_s': 1.0,
                                'burst_tokens': 10.0},
                       'gold': {'priority': 2}})
    reqs = [tw.submit(p, max_new_tokens=4, tenant_id=tid)
            for p, tid in zip(_rand(12, 3), ('bulk', 'bulk', 'gold'))]
    tw.step(4)
    tw.jump(30.0)
    tw.drain()
    tw.check()
    path = str(tmp_path / 'tenants.jsonl')
    tw.port.export_trace(jsonl_path=path)
    header, events = load_trace(path)
    assert header['schema'] == 'paddle_tpu.serve_trace/6'
    table = reconstruct(events)
    assert table[reqs[2].id]['tenant_id'] == 'gold'
    assert table[reqs[2].id]['priority'] == 2
    assert table[reqs[1].id]['quota_defers'] == 1
    assert all(k >= 0 for k in table)
    # the reference's reader takes the port's file, and derives the
    # same table
    jheader, jevents = jserving.load_trace(path)
    assert jserving.reconstruct(jevents) == table
    tw.shutdown()
