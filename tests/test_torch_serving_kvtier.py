"""The port's host-RAM KV tier against the JAX package's
(tests/test_serving_kvtier.py): the tiered allocator makes the same page
and slot decisions on the same call sequence (spill, resurrect, COW
sharing, LRU subtree order, a full tier, reset); fp32, bf16 and int8
pages (with their fp32 scales) come back from the host bit for bit,
chunked or not; an in-flight spill's pages are unavailable until they
land, and a concurrent stress of spills and fetches keeps the pool
partitioned; the engine under preemption with spills emits the
reference's greedy tokens, a resurrect skips the prefill and shows in
the trace and the ledger, and a tier that never spills is inert: the
same tokens, host fetches and gauge set as a tierless engine."""
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.serving import KVPagePool as JPool
from paddle_tpu.serving.host_tier import HostTier as JTier
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.serving import (KVPagePool, ServingConfig,
                                      ServingEngine, load_trace,
                                      reconstruct)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.host_tier import HostTier
from paddle_tpu_torch.serving.metrics import scalar_series, serve_snapshot
from torch_serving_twin import Twin, model_pair
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope='module')
def pair():
    return model_pair(seed=7, max_seq_len=160)


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, 128, n)) for n in (5, 11, 3, 8)]


def _pool(num_pages=8, page_size=4, host_pages=8, dtype=None, **tier_kw):
    pool = KVPagePool(num_pages=num_pages, page_size=page_size,
                      num_layers=2, num_heads=2, head_dim=4, dtype=dtype,
                      prefix_cache=True)
    pool.materialize('cpu')
    pool.attach_host_tier(HostTier(host_pages, **tier_kw))
    return pool


def _jpool(num_pages=8, page_size=4, host_pages=8, dtype=None, **tier_kw):
    pool = JPool(num_pages=num_pages, page_size=page_size, num_layers=2,
                 num_heads=2, head_dim=4, dtype=dtype, prefix_cache=True)
    pool.materialize()
    pool.attach_host_tier(JTier(host_pages, **tier_kw))
    return pool


def _fill_random(pool, seed=0):
    """Distinguishable contents in every row, written in place."""
    gen = torch.Generator().manual_seed(seed)
    for layer in pool.kv:
        for b in layer:
            if b.dtype == torch.int8:
                b.copy_(torch.randint(-128, 128, b.shape, generator=gen,
                                      dtype=torch.int8))
            else:
                b.copy_(torch.rand(b.shape, generator=gen).to(b.dtype))


def _rows(pool, pages):
    return [[b[list(pages)].clone() for b in layer] for layer in pool.kv]


def _park_chain(pool, seq, toks):
    pool.ensure_capacity(seq, len(toks))
    pool.register_prefix(seq, toks, written=len(toks))
    pool.release(seq)


def _partition_ok(pool):
    return (len(pool._free) + len(pool._cached) + len(pool._ref)
            + len(pool._spilling) == pool.num_pages)


def _state(pool):
    """The allocator state both packages keep, as plain values."""
    return (sorted(pool._free), list(pool._cached), dict(pool._ref),
            {k: sorted(v) for k, v in pool._seq_pages.items()},
            dict(pool._index), sorted(pool._spilling),
            pool.host_tier.used_slots, pool.free_pages, pool.pages_in_use,
            pool.host_resident_pages(), pool.prefix_evictions,
            pool.host_resurrect_pages)


def _tier_calls(pool):
    out = []
    toks = list(range(10, 22))                      # 3 pages
    _park_chain(pool, 'a', toks)
    out += [pool.spill_lru(sync=True), _state(pool)]
    out += [pool.peek_prefix(toks, limit=11),
            pool.match_and_map('b', toks, limit=11), _state(pool),
            pool.pop_resurrect_stats(), pool.pop_resurrect_stats()]
    out += [pool.release('b'), _state(pool)]
    # copy-on-write sharing of resurrected pages
    cow = list(range(30, 38))
    _park_chain(pool, 'c', cow)
    out.append(pool.spill_lru(sync=True))
    out += [pool.match_and_map('d', cow + [1], limit=8),
            pool.match_and_map('e', cow + [2], limit=8), _state(pool)]
    pool.release('d')
    pool.release('e')
    out.append(_state(pool))
    # LRU subtree order, a bounded spill, then a full tier
    for i, seq in enumerate('fgh'):
        _park_chain(pool, seq, list(range(100 + 20 * i, 108 + 20 * i)))
    out += [pool.spill_lru(max_pages=1, sync=True), _state(pool),
            pool.spill_lru(sync=True), _state(pool),
            pool.host_tier.free_slots]
    # allocation pressure spills inline, then evicts host markers
    pool.ensure_capacity('big', 8 * pool.page_size)
    out += [_state(pool), pool.census(), pool.stats()]
    pool.release('big')
    pool.reset()
    out.append(_state(pool))
    return out


def test_tiered_allocator_equals_reference():
    ref = _tier_calls(_jpool(num_pages=8, page_size=4, host_pages=8))
    got = _tier_calls(_pool(num_pages=8, page_size=4, host_pages=8))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if isinstance(r, dict) and 'kv_dtype' in r:
            r = {k: v for k, v in r.items() if k != 'kv_dtype'}
            g = {k: v for k, v in g.items() if k != 'kv_dtype'}
        assert g == r, (i, g, r)


@pytest.mark.parametrize('dtype,chunk', [
    (torch.float32, 0), (torch.float32, 2), (torch.bfloat16, 2),
    ('int8', 0), ('int8', 2)])
def test_round_trip_bit_identical(dtype, chunk):
    pool = _pool(num_pages=8, page_size=4, dtype=dtype, chunk_pages=chunk)
    if dtype == 'int8':
        assert pool.quantized and len(pool.kv[0]) == 4
    _fill_random(pool, seed=3)
    toks = list(range(50, 62))                      # 3 pages
    _park_chain(pool, 'a', toks)
    before = _rows(pool, pool._match_pages(toks))
    assert pool.spill_lru(sync=True) == 3
    # overwrite the freed device pages, so only the host holds the rows
    for layer in pool.kv:
        for b in layer:
            b[:pool.num_pages].zero_()
    assert pool.match_and_map('b', toks, limit=11) == 8
    after = _rows(pool, pool.page_table('b'))
    for lb, la in zip(before, after):
        for bb, ba in zip(lb, la):
            assert bb.dtype == ba.dtype
            assert torch.equal(bb[:2], ba)
    st = pool.stats()
    assert st['tier_spilled_pages_total'] == 3
    assert st['tier_fetched_pages_total'] == 2
    assert st['tier_spilled_bytes_total'] == 3 * sum(
        b[0].numel() * b.element_size() for layer in pool.kv for b in layer)


def test_inflight_spill_is_unavailable_until_landed():
    pool = _pool(num_pages=4, page_size=4, window=2)
    _fill_random(pool)
    _park_chain(pool, 'a', list(range(10, 26)))     # all 4 pages
    gate = threading.Event()
    tier = pool.host_tier
    real_land = tier._land

    def gated_land(*args):
        assert gate.wait(10)
        real_land(*args)
    tier._land = gated_land
    try:
        assert pool.spill_lru(sync=False) == 4
        assert pool.free_pages == 0 and len(pool._spilling) == 4
        assert _partition_ok(pool)
        assert not pool.try_reserve('x', 4)
        gate.set()
        tier.drain()
        for _ in range(500):
            if pool.free_pages == 4:
                break
            threading.Event().wait(0.01)
        assert pool.free_pages == 4 and not pool._spilling
        assert pool.try_reserve('x', 4)
    finally:
        tier._land = real_land
        tier.shutdown()


def test_spills_and_fetches_under_thread_stress():
    """Async spills on the transfer thread race the engine thread's
    allocations and resurrects (more threads than this test's one core
    of work, a short switch interval): the pool stays partitioned, every
    slot is returned, and every resurrected row is the row spilled."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = _pool(num_pages=24, page_size=2, host_pages=48, window=1)
        _fill_random(pool, seed=5)
        chains = [list(range(1000 * c, 1000 * c + 6)) for c in range(4)]
        want = {}
        for c, toks in enumerate(chains):
            pool.ensure_capacity(('w', c), len(toks))
            want[c] = _rows(pool, pool.page_table(('w', c)))
            pool.register_prefix(('w', c), toks, written=len(toks))
            pool.release(('w', c))
        for rnd in range(30):
            pool.spill_lru(max_pages=3)             # async, window 1
            c = rnd % len(chains)
            seq = ('r', rnd)
            got = pool.match_and_map(seq, chains[c], limit=len(chains[c]))
            if got == len(chains[c]):
                rows = _rows(pool, pool.page_table(seq))
                for lw, lg in zip(want[c], rows):
                    for bw, bg in zip(lw, lg):
                        assert torch.equal(bw, bg)
            with pool._lock:
                assert _partition_ok(pool)
            pool.release(seq)
        pool.host_tier.drain()
        for _ in range(500):
            if not pool._spilling:
                break
            threading.Event().wait(0.01)
        assert not pool._spilling and _partition_ok(pool)
        pool.reset()
        assert pool.host_tier.used_slots == 0
        pool.host_tier.shutdown()
        assert pool.host_tier._thread is None
    finally:
        sys.setswitchinterval(old)


# ---------------------------------------------------------------------------
# engine scenarios
# ---------------------------------------------------------------------------
def test_preempt_spill_resume_tokens(pair, prompts):
    """A 5-page pool preempts, released pages spill under a low
    watermark and resumes resurrect them: both engines emit the tierless
    reference's tokens. Each step's spills land before the next step
    (settle_spills), so the transfer threads' timing under load cannot
    move one engine's admissions against the other's."""
    ref = Twin(pair, page_size=8, max_batch_size=3, prefill_chunk=8,
               seed=11)
    want = ref.generate(prompts, max_new_tokens=8)
    ref.check()
    ref.shutdown()
    tw = Twin(pair, page_size=8, max_batch_size=3, prefill_chunk=8,
              seed=11, num_pages=5, host_tier_pages=16, spill_watermark=0.5,
              settle_spills=True)
    assert tw.generate(prompts, max_new_tokens=8) == want
    assert [r.output_ids() for r, _p in tw.reqs] == want
    st = tw.port.stats()
    assert st['preemptions_total'] > 0
    assert st['pool']['tier_spilled_pages_total'] > 0
    assert tw.port.pool.pages_in_use == 0
    tw.shutdown()


def test_resurrect_skips_prefill(pair, tmp_path):
    tw = Twin(pair, page_size=8, max_batch_size=2, prefill_chunk=8,
              seed=11, host_tier_pages=16)
    prompt = list(range(1, 21))                     # 2 full pages
    base = tw.generate([prompt], max_new_tokens=6)
    for eng in (tw.ref, tw.port):
        assert eng.pool.spill_lru(sync=True) >= 2
    assert tw.generate([prompt], max_new_tokens=6) == base
    tw.check()                                      # all sync: exact
    ps = tw.port.pool.stats()
    assert ps['tier_resurrected_pages_total'] >= 2
    assert ps['tier_resurrected_tokens_total'] >= 16
    assert ps['tier_fetched_bytes_total'] > 0
    for k in ('tier_host_pages', 'tier_host_used_pages',
              'tier_spilled_pages_total', 'tier_spilled_bytes_total',
              'tier_fetched_pages_total', 'tier_fetched_bytes_total',
              'tier_resurrected_pages_total',
              'tier_resurrected_tokens_total'):
        assert ps[k] == tw.ref.pool.stats()[k], k
    # the second request prefilled only the uncached tail
    assert tw.port.stats()['prefill_tokens_total'] == 20 + 4
    paths = tw.port.export_trace(jsonl_path=str(tmp_path / 't.jsonl'))
    _h, events = load_trace(paths['jsonl'])
    spills = [e for e in events if e['event'] == 'spill']
    assert spills and all(e['req'] == -1 for e in spills)
    res = [e for e in events if e['event'] == 'resurrect']
    assert res and res[0]['pages'] >= 2
    assert sum(r['resurrected_tokens']
               for r in reconstruct(events).values()) >= 16
    a = tw.port.ledger.account()
    assert a['components']['page_stream'] > 0
    assert sum(a['components'].values()) == pytest.approx(a['wall_seconds'])
    tw.shutdown()


def test_no_spill_tier_is_inert(pair, prompts, monkeypatch):
    count = [0]
    real = engine_mod._host_fetch

    def counting(x):
        count[0] += 1
        return real(x)
    monkeypatch.setattr(engine_mod, '_host_fetch', counting)
    runs = {}
    for name, kw in (('plain', {}), ('tiered', dict(host_tier_pages=32))):
        count[0] = 0
        eng = ServingEngine(pair[1], ServingConfig(
            page_size=8, max_batch_size=4, prefill_chunk=8, seed=11, **kw),
            device='cpu')
        outs = eng.generate(prompts, max_new_tokens=8)
        runs[name] = (outs, count[0], eng.pool.stats(), eng.stats())
        eng.shutdown()
    (o1, n1, ps1, st1), (o2, n2, ps2, st2) = runs['plain'], runs['tiered']
    assert o1 == o2 and n1 == n2
    assert st1['decode_steps_total'] == st2['decode_steps_total']
    assert 'tier_host_pages' not in ps1
    assert ps2['tier_spilled_pages_total'] == 0
    assert ps2['tier_fetched_pages_total'] == 0
    assert ps2['tier_host_used_pages'] == 0


def test_tierless_gauge_set(pair):
    monitor.metrics().reset()
    eng = ServingEngine(pair[1], ServingConfig(
        page_size=8, max_batch_size=2, prefill_chunk=8), device='cpu')
    eng.generate([[1, 2, 3]], max_new_tokens=4)
    eng.publish_metrics()
    snap = serve_snapshot()
    assert snap and not any('tier' in k for k in snap)
    assert not any('tier' in m.name for m in monitor.metrics().metrics_list())
    assert not any('tier' in k for k in scalar_series(eng.stats()))
    eng.shutdown()
    # with a tier, the tier gauges appear
    eng = ServingEngine(pair[1], ServingConfig(
        page_size=8, max_batch_size=2, prefill_chunk=8, host_tier_pages=4),
        device='cpu')
    eng.generate([[1, 2, 3]], max_new_tokens=4)
    eng.publish_metrics()
    assert serve_snapshot()['ptpu_serve_tier_host_pages'] == 4
    eng.shutdown()


def test_consecutive_slot_runs():
    """The card's direct route: a chunk whose slots are consecutive
    (either way) moves to and from host[lo:lo + w], its pages put in
    ascending-slot order; any other chunk stages."""
    from paddle_tpu_torch.serving.host_tier import _chunk_spans, _runs
    pages = [10, 11, 12, 13, 14, 15, 16]
    assert _runs(pages, [3, 4, 5, 6, 7, 8, 9], [(0, 7)]) == (
        [3], pages)
    assert _runs(pages, [9, 8, 7, 6, 5, 4, 3], [(0, 7)]) == (
        [3], pages[::-1])
    spans = _chunk_spans(7, 3)
    assert spans == [(0, 3), (3, 3), (6, 1)]
    assert _runs(pages, [5, 4, 3, 0, 2, 9, 1], spans) == (
        [3, None, 1], [12, 11, 10, 13, 14, 15, 16])
    assert _chunk_spans(3, 0) == [(0, 3)]
