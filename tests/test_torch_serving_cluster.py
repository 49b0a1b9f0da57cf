"""The port's serving cluster against the JAX package's
(tests/test_serving_cluster.py and the cluster cases of
test_serving_kvtier.py, test_alerts.py, test_serving_ledger.py and
test_serving_tenants.py): the pool's prefix digest and its memo, the
prefetch warm, every router placement scenario over a status feed, and
two-replica clusters over bridged weights (shared prefix, throttle, a
drain mid-stream, the host-tier hint), whose greedy tokens, placements,
counters, drain records and goodput equal the reference's and whose
tokens equal one engine's; federation, tenancy through the router, the
route trace event, and the package surface and disaggregation knobs
(tests/test_torch_serving_disagg.py and test_torch_serving_workers.py
hold the disaggregated engine and the worker replicas).

Routers over engines refresh once a stream (refresh_interval_s=3600):
the default interval ties a refresh, and so the ageing of the
optimistic digest overlay, to the wall clock, while placement must be a
function of the token ids and the queue depths to compare."""
import json
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.core import monitor as jmonitor
from paddle_tpu.serving import KVPagePool as JPool
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.cluster import ClusterRouter as JRouter
from paddle_tpu.serving.cluster import LocalReplica as JLocal
from paddle_tpu.serving.cluster import RouterRejected as JRejected
from paddle_tpu.serving.host_tier import HostTier as JTier
from paddle_tpu.serving.kv_pool import chain_hashes as jchain_hashes
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.core.alerts import router_rules
from paddle_tpu_torch.serving import (KVPagePool, ServingConfig,
                                      ServingEngine, chain_hashes,
                                      load_trace, reconstruct)
from paddle_tpu_torch.serving import cluster as tcluster
from paddle_tpu_torch.serving.cluster import (ClusterRouter, LocalReplica,
                                              RouterRejected,
                                              cluster_snapshot)
from paddle_tpu_torch.serving.host_tier import HostTier
from torch_serving_twin import model_pair
from torch_threads import one_intra_op_thread  # noqa: F401

ENGINE_KW = dict(page_size=8, max_batch_size=3, prefill_chunk=16)
STEADY = dict(refresh_interval_s=3600.0)

JAX = dict(Router=JRouter, Local=JLocal, Rejected=JRejected,
           chain_hashes=jchain_hashes, Pool=JPool, Tier=JTier,
           Engine=lambda m, **kw: JEngine(m, JConfig(**kw)),
           monitor=jmonitor)
PORT = dict(Router=ClusterRouter, Local=LocalReplica, Rejected=RouterRejected,
            chain_hashes=chain_hashes, Pool=KVPagePool, Tier=HostTier,
            Engine=lambda m, **kw: ServingEngine(m, ServingConfig(**kw),
                                                 device='cpu'),
            monitor=monitor)


@pytest.fixture(scope='module')
def pair():
    return model_pair(seed=5)


@pytest.fixture(scope='module')
def mixed_prompts():
    """The reference's stream: two 24-token families, short tails."""
    rng = np.random.RandomState(1)
    fam = [list(rng.randint(1, 128, 24)) for _ in range(2)]
    order = [0, 1, 0, 1, 1, 0, 0, 1, 0, 1]
    return [fam[f] + list(rng.randint(1, 128, int(rng.randint(2, 10))))
            for f in order]


def _model(pair, pkg):
    return pair[0] if pkg is JAX else pair[1]


def _single(pair, prompts, max_new, **kw):
    eng = PORT['Engine'](pair[1], **{**ENGINE_KW, **kw})
    out = eng.generate(prompts, max_new_tokens=max_new, top_k=0)
    eng.shutdown()
    return out


def _cluster(pkg, pair, n=2, engine_kw=None, replica_clock=None,
             reps=None, **router_kw):
    """A router over `reps`, or over n new LocalReplicas."""
    model = _model(pair, pkg)
    if reps is None:
        reps = [pkg['Local'](pkg['Engine'](model, **{**ENGINE_KW,
                                                     **(engine_kw or {})}),
                             f'r{i}', clock=replica_clock)
                for i in range(n)]
    router = pkg['Router'](reps, page_size=ENGINE_KW['page_size'],
                           **router_kw)
    return router, reps


def _decisions(reqs):
    return [(str(r.replica_id), r.decision, r.resubmits, list(r.tokens))
            for r in reqs]


def _snap(router):
    """snapshot() without its clock readings."""
    s = dict(router.snapshot())
    s['drain_events'] = [{k: v for k, v in e.items() if k != 't'}
                         for e in s['drain_events']]
    s.pop('alerts')
    return s


# ---------------------------------------------------------------------------
# the pool's prefix digest, its memo and the prefetch warm
# ---------------------------------------------------------------------------
def _pool(pkg, tier, num_pages=8, page_size=4, host_pages=8):
    pool = pkg['Pool'](num_pages=num_pages, page_size=page_size,
                       num_layers=2, num_heads=2, head_dim=4,
                       prefix_cache=True)
    if pkg is JAX:
        pool.materialize()
    else:
        pool.materialize('cpu')
    if tier:
        pool.attach_host_tier(pkg['Tier'](host_pages))
    return pool


def _park(pool, seq, toks):
    pool.ensure_capacity(seq, len(toks))
    pool.register_prefix(seq, toks, written=len(toks))
    pool.release(seq)


CHAIN_A = list(range(10, 22))                   # 3 pages of 4
CHAIN_B = CHAIN_A[:4] + list(range(50, 58))     # shares A's first page
CHAIN_C = list(range(70, 82))


def _digest_calls(pool, ch):
    """Register, share, spill, evict under pressure, resurrect, reset:
    the digest as a set after each, and what the router's chain_hashes
    of the parked chains say it must be at the start."""
    out = []
    _park(pool, 'a', CHAIN_A)
    _park(pool, 'b', CHAIN_B)
    want = set(ch(CHAIN_A, 4)) | set(ch(CHAIN_B, 4))
    out.append(set(pool.prefix_chain_hashes()) == want)
    out.append(sorted(pool.prefix_chain_hashes()))
    out.append(len(pool.prefix_chain_hashes(limit=2)))
    if pool.host_tier is not None:
        pool.spill_lru(max_pages=2, sync=True)
        out.append(sorted(pool.prefix_chain_hashes()))
    _park(pool, 'c', CHAIN_C)
    out.append(sorted(pool.prefix_chain_hashes()))
    pool.ensure_capacity('big', 7 * pool.page_size)   # spills or evicts
    out.append(sorted(pool.prefix_chain_hashes()))
    pool.release('big')
    out.append(pool.match_and_map('d', CHAIN_A, limit=11))
    out.append(sorted(pool.prefix_chain_hashes()))
    pool.release('d')
    pool.reset()
    out.append(pool.prefix_chain_hashes())
    return out


@pytest.mark.parametrize('tier', [False, True], ids=['device', 'tiered'])
def test_prefix_chain_hashes_equal_reference(tier):
    ref = _digest_calls(_pool(JAX, tier), jchain_hashes)
    got = _digest_calls(_pool(PORT, tier), chain_hashes)
    assert got[0] is True and got[-1] == []
    assert got == ref
    # the port's chain hash is the reference's, link for link
    assert chain_hashes(CHAIN_A + [1], 4, limit=12) == \
        jchain_hashes(CHAIN_A + [1], 4, limit=12)


def _memo_point(pool, point):
    if point == 'evict':
        pool.ensure_capacity('big', 8 * pool.page_size)
    elif point == 'rekey':
        assert pool.spill_lru(max_pages=1, sync=True) >= 1
    elif point == 'reset':
        pool.reset()
    else:
        _park(pool, 'c', CHAIN_C)


@pytest.mark.parametrize('point', ['evict', 'rekey', 'reset', 'register'])
def test_digest_memo_cleared(point):
    """The memo holds between index changes and goes at each of the
    four points where the reference's goes: a subtree eviction, a
    spill's rekey, reset and a newly registered chain."""
    pools = [_pool(pkg, tier=(point == 'rekey')) for pkg in (JAX, PORT)]
    digests = []
    for pool in pools:
        _park(pool, 'a', CHAIN_A)
        first = pool.prefix_chain_hashes()
        assert pool._digest_cache is not None
        assert pool.prefix_chain_hashes() == first      # the memo
        _memo_point(pool, point)
        assert pool._digest_cache is None, point
        digests.append(sorted(pool.prefix_chain_hashes()))
    assert digests[1] == digests[0]


def _warm_calls(pool):
    out = [pool.warm_prefix(CHAIN_A, limit=11)]        # nothing on host
    _park(pool, 'a', CHAIN_A)
    _park(pool, 'c', CHAIN_C)
    out.append(pool.spill_lru(sync=True))
    out.append(pool.warm_prefix(CHAIN_A, limit=11))     # 2 pages back
    out += [sorted(pool._free), list(pool._cached), dict(pool._ref),
            pool.host_resident_pages(), pool.host_resurrect_pages,
            pool.pop_resurrect_stats()]
    # a warm takes free pages only: with none free it warms nothing
    pool.ensure_capacity('hold', len(pool._free) * pool.page_size)
    out.append(pool.warm_prefix(CHAIN_C, limit=11))
    out += [pool.peek_prefix(CHAIN_A, limit=11), dict(pool._ref)]
    # the warmed pages prefix-hit with no fetch of their own
    pool.release('hold')
    fetched = pool.host_tier.stats()['tier_fetched_pages_total']
    out.append(pool.match_and_map('b', CHAIN_A, limit=11))
    out.append(pool.host_tier.stats()['tier_fetched_pages_total']
               - fetched)
    out.append(pool.warm_prefix(CHAIN_C, limit=11))
    return out


def test_warm_prefix_equals_reference():
    ref = _warm_calls(_pool(JAX, tier=True))
    got = _warm_calls(_pool(PORT, tier=True))
    # nothing on host, 2 pages warmed, none with no free page, and the
    # warmed pages map with no fetch of their own
    assert (got[0], got[2], got[9], got[12], got[13]) == (0, 2, 0, 8, 0), \
        got
    assert got == ref
    assert _pool(PORT, tier=False).warm_prefix(CHAIN_A) == 0


def _joined(target, timeout=10.0):
    """Run `target` on a daemon thread and return what it returned: a
    deadlock fails the test after `timeout` seconds instead of hanging
    the run."""
    box = {}

    def body():
        try:
            box['out'] = target()
        except BaseException as e:      # noqa: BLE001 - re-raised below
            box['err'] = e
    th = threading.Thread(target=body, daemon=True)
    th.start()
    return th, box


def _result(th, box, timeout=10.0):
    th.join(timeout)
    assert not th.is_alive(), 'deadlocked'
    if 'err' in box:
        raise box['err']
    return box['out']


def _tier_pool(num_pages, page_size, host_pages, window):
    pool = KVPagePool(num_pages=num_pages, page_size=page_size,
                      num_layers=2, num_heads=2, head_dim=4,
                      prefix_cache=True)
    pool.materialize('cpu')
    pool.attach_host_tier(HostTier(host_pages, window=window))
    return pool


def test_warm_waits_for_a_later_spill_outside_the_lock():
    """Chains A and C spill as two async jobs, A's landing held back. A
    warm of C must wait for C's job outside the pool lock: the transfer
    thread runs A's landing callback, which takes the lock, before it
    lands C, so a warm waiting under the lock would never end."""
    pool = _tier_pool(8, 4, 16, window=2)
    _park(pool, 'a', CHAIN_A)
    _park(pool, 'c', CHAIN_C)
    tier = pool.host_tier
    gate, real_land, calls = threading.Event(), tier._land, [0]

    def gated_land(*args):
        calls[0] += 1
        if calls[0] == 1:
            assert gate.wait(20)
        real_land(*args)
    tier._land = gated_land
    try:
        assert pool.spill_lru(sync=False) == 6      # job A, then job C
        th, box = _joined(lambda: pool.warm_prefix(CHAIN_C))
        th.join(0.3)                # the warm is waiting on job C now
        gate.set()
        assert _result(th, box) == 3
    finally:
        gate.set()
        tier._land = real_land
    assert pool.peek_prefix(CHAIN_C) == (12, 0, 3, 0)
    tier.shutdown()
    with pool._lock:
        assert (len(pool._free) + len(pool._cached) + len(pool._ref)
                + len(pool._spilling)) == pool.num_pages


def test_warms_under_async_spill_stress():
    """Async spills race warms and maps of the same chains (the
    match_and_map stress of test_torch_serving_kvtier.py, with the
    router's prefetch in it): no deadlock, the pool stays partitioned,
    and every host slot comes back."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = _tier_pool(24, 2, 48, window=1)
        chains = [list(range(1000 * c, 1000 * c + 6)) for c in range(4)]
        for c, toks in enumerate(chains):
            _park(pool, ('w', c), toks)

        def rounds():
            warmed = 0
            for rnd in range(30):
                pool.spill_lru(max_pages=3)             # async, window 1
                c = rnd % len(chains)       # the router's order: the
                warmed += pool.warm_prefix(chains[c])   # hint, then the
                seq = ('r', rnd)                        # submit's map
                pool.match_and_map(seq, chains[c], limit=len(chains[c]))
                with pool._lock:
                    assert (len(pool._free) + len(pool._cached)
                            + len(pool._ref) + len(pool._spilling)
                            == pool.num_pages)
                pool.release(seq)
            return warmed
        assert _result(*_joined(rounds), timeout=60.0) > 0
    finally:
        sys.setswitchinterval(old)
    pool.host_tier.drain()
    for _ in range(500):
        if not pool._spilling:
            break
        threading.Event().wait(0.01)
    assert not pool._spilling
    pool.reset()
    assert pool.host_tier.used_slots == 0
    pool.host_tier.shutdown()


# ---------------------------------------------------------------------------
# placement over a fake status feed (no engines), both routers
# ---------------------------------------------------------------------------
class FakeReplica:
    """The reference tests' status-feed replica (test_serving_cluster.py
    FakeReplica): no prefetch and no metrics op, as a replica that
    lacks them."""

    def __init__(self, rid, digest=(), waiting=0, in_flight=0,
                 occupancy=0.0, hung=False, beat_age=0.0):
        self.replica_id = rid
        self.feed = {'replica_id': rid, 'beat_age_s': beat_age,
                     'hung': hung, 'hang_reason': None,
                     'draining': False, 'waiting': waiting,
                     'in_flight': in_flight, 'pending_tokens': 0,
                     'decode_tokens_per_sec': 0.0,
                     'timeline': {'mean_occupancy': occupancy},
                     'pool': {}, 'prefix_digest': list(digest)}
        self.submitted = []
        self._next = 0

    def submit(self, prompt, opts, route_meta=None):
        self.submitted.append((list(prompt), dict(opts),
                               dict(route_meta or {})))
        self._next += 1
        return f'{self.replica_id}-{self._next}'

    def status(self):
        return dict(self.feed)

    def poll(self):
        return {}

    def pump(self):
        return False

    def drain(self):
        return []

    def shutdown(self):
        pass


def _place_affinity(pkg, ch):
    prompt = list(range(1, 13))
    hot = FakeReplica('hot', digest=ch(prompt, 4), waiting=3)
    cold = FakeReplica('cold')
    return [hot, cold], {}, lambda r: [r.submit(prompt, max_new_tokens=4)]


def _place_deepest(pkg, ch):
    prompt = list(range(1, 17))
    h = ch(prompt, 4)
    reps = [FakeReplica('shallow', digest=h[:1]),
            FakeReplica('deep', digest=h[:3])]
    return reps, {}, lambda r: [r.submit(prompt)]


def _place_timeline(pkg, ch):
    reps = [FakeReplica('busy', waiting=1, occupancy=0.9),
            FakeReplica('idle', waiting=1, occupancy=0.1)]
    return reps, {}, lambda r: [r.submit(list(range(1, 9)))]


def _place_burst(pkg, ch):
    prompt = list(range(1, 13))
    return [FakeReplica('a'), FakeReplica('b')], STEADY, lambda r: [
        r.submit(prompt + [77]), r.submit(prompt + [88])]


def _place_stale_digest(pkg, ch):
    prompt = list(range(1, 13))
    a = FakeReplica('a', digest=ch(prompt, 4))

    def drive(r):
        first = r.submit(prompt + [50])
        a.feed['prefix_digest'] = []        # the pool evicted everything
        for _ in range(r.OPTIMISTIC_GENERATIONS + 2):
            r.refresh()
        return [first, r.submit(prompt + [60])]
    return [a, FakeReplica('b')], dict(refresh_interval_s=0.0), drive


def _place_spill(pkg, ch):
    prompt = list(range(1, 13))
    reps = [FakeReplica('hot', digest=ch(prompt, 4), waiting=9),
            FakeReplica('cold')]
    return reps, {}, lambda r: [r.submit(prompt)]


def _place_partial_spill(pkg, ch):
    prompt = list(range(1, 17))
    h = ch(prompt, 4)
    reps = [FakeReplica('hot', digest=h, waiting=9),
            FakeReplica('warm', digest=h[:2], waiting=2),
            FakeReplica('cold', waiting=1)]
    return reps, {}, lambda r: [r.submit(prompt)]


def _place_reject(pkg, ch):
    reps = [FakeReplica(n, waiting=9) for n in ('a', 'b')]
    return reps, {}, lambda r: [r.submit(list(range(1, 9)))]


def _place_deadline(pkg, ch):
    slow = FakeReplica('slow')
    slow.feed['decode_tokens_per_sec'] = 10.0
    slow.feed['pending_tokens'] = 1000          # 100 s of queue

    def drive(r):
        r.refresh()
        return [r.submit(list(range(1, 9)))]
    return [slow], dict(deadline_bound_s=5.0), drive


def _place_retry_hint(pkg, ch):
    reps = [FakeReplica(n, waiting=4) for n in ('a', 'b')]
    reps[0].feed.update(decode_tokens_per_sec=50.0, pending_tokens=300)
    reps[1].feed.update(decode_tokens_per_sec=20.0, pending_tokens=40)

    def drive(r):
        r.refresh()
        return [r.submit(list(range(1, 9)))]
    return reps, {}, drive


def _place_stale_heartbeat(pkg, ch):
    prompt = list(range(1, 13))
    a = FakeReplica('a', digest=ch(prompt, 4))

    def drive(r):
        req = r.submit(prompt, max_new_tokens=8)
        a.feed['beat_age_s'] = 9.9              # wedged step loop
        r.refresh()
        return [req]
    return [a, FakeReplica('b')], dict(hang_timeout_s=2.0,
                                       refresh_interval_s=0.0), drive


def _place_hung_flag(pkg, ch):
    reps = [FakeReplica('a', beat_age=99.0), FakeReplica('b')]

    def drive(r):
        r.refresh()
        return []
    return reps, dict(hang_timeout_s=2.0), drive


def _place_drain_bypass(pkg, ch):
    def drive(r):
        req = r.submit(list(range(1, 9)), max_new_tokens=8)
        r.drain('a', reason='test')
        return [req]
    return [FakeReplica('a'), FakeReplica('b', waiting=9)], {}, drive


def _place_flaky_peer(pkg, ch):
    prompt = list(range(1, 13))
    flaky = FakeReplica('b')
    orig, calls = flaky.submit, {'n': 0}

    def flaky_submit(p, opts, route_meta=None):
        calls['n'] += 1
        if calls['n'] == 1:
            raise OSError('channel hiccup')
        return orig(p, opts, route_meta)
    flaky.submit = flaky_submit

    def drive(r):
        req = r.submit(prompt, max_new_tokens=8)
        r.drain('a', reason='test')         # the dispatch fails once
        parked = (req.replica_id, len(r._unplaced))
        r.pump()                            # the retry lands
        return [req, parked]
    return [FakeReplica('a', digest=ch(prompt, 4)), flaky], {}, drive


def _place_drained(pkg, ch):
    def drive(r):
        r.drain('a', reason='operator')
        return [r.submit(list(range(1, 9))) for _ in range(3)]
    return [FakeReplica('a'), FakeReplica('b')], {}, drive


# scenario -> what the reference test asserts, checked on the port's run
PLACEMENTS = {
    'affinity_beats_least_loaded': (
        _place_affinity, [('hot', 'affinity')]),
    'deepest_prefix_wins': (_place_deepest, [('deep', 'affinity')]),
    'least_loaded_uses_timeline': (
        _place_timeline, [('idle', 'least_loaded')]),
    'optimistic_digest_routes_burst': (
        _place_burst, [('a', 'least_loaded'), ('a', 'affinity')]),
    'published_digest_replaces_stale': (
        _place_stale_digest, [('a', 'affinity'), ('b', 'least_loaded')]),
    'backpressure_spills_affinity': (_place_spill, [('cold', 'spill')]),
    'spill_prefers_partial_affinity': (
        _place_partial_spill, [('warm', 'spill')]),
    'reject_early_when_saturated': (_place_reject, 'backpressure'),
    'deadline_bound_rejects': (_place_deadline, 'backpressure'),
    'retry_hint_fastest_replica': (_place_retry_hint, 'backpressure'),
    'stale_heartbeat_drains_and_resubmits': (
        _place_stale_heartbeat, [('b', 'affinity')]),
    'hung_flag_on_stale_heartbeat': (_place_hung_flag, []),
    'drain_resubmit_bypasses_backpressure': (
        _place_drain_bypass, [('b', 'least_loaded')]),
    'drain_survives_peer_dispatch_failure': (
        _place_flaky_peer, [('b', 'affinity'), ('a', 1)]),
    'drained_replica_not_placed': (
        _place_drained, [('b', 'least_loaded')] + [('b', 'affinity')] * 2),
}


def _run_placement(pkg, build):
    reps, kw, drive = build(pkg, pkg['chain_hashes'])
    kw = {'page_size': 4, 'max_queue': 4, **kw}
    router = pkg['Router'](reps, **kw)
    rec = {}
    try:
        out = drive(router)
    except pkg['Rejected'] as rej:
        out = None
        rec['rejected'] = (type(rej).__name__, rej.reason,
                           rej.retry_after_s)
    reqs = [r for r in (out or []) if not isinstance(r, tuple)]
    rec['placed'] = [(r.replica_id, r.decision) for r in reqs] + \
        [r for r in (out or []) if isinstance(r, tuple)]
    rec['requests'] = [(r.replica_id, r.decision, r.resubmits,
                        r.opts, r.budget_left) for r in reqs]
    rec['snapshot'] = _snap(router)
    rec['submitted'] = {r.replica_id: r.submitted for r in reps}
    rec['healthy'] = router.healthy_replicas()
    return rec


@pytest.mark.parametrize('name', sorted(PLACEMENTS))
def test_router_placement_equals_reference(name):
    build, want = PLACEMENTS[name]
    ref = _run_placement(JAX, build)
    got = _run_placement(PORT, build)
    if isinstance(want, str):
        assert got['rejected'][1] == want and got['snapshot']['rejects'] == 1
    else:
        assert got['placed'] == want, got
    assert got == ref


def test_placement_scenarios_say_what_they_test():
    """The scenarios carry the reference tests' own facts: a resubmit
    keeps its budget, the hint is the fastest replica's backlog over its
    depth, and a drain bypasses backpressure without counting a
    reject."""
    rec = _run_placement(PORT, _place_stale_heartbeat)
    snap = rec['snapshot']
    assert snap['replicas']['a']['drained'] and \
        snap['placements']['drain'] == 1
    assert snap['placements']['resubmit'] == 1
    assert rec['submitted']['b'][-1][1]['max_new_tokens'] == 8
    rec = _run_placement(PORT, _place_retry_hint)
    assert rec['rejected'][2] == pytest.approx(min(300 / 50 / 4,
                                                   40 / 20 / 4))
    rec = _run_placement(PORT, _place_drain_bypass)
    assert rec['snapshot']['rejects'] == 0


@pytest.mark.parametrize('op', ['submit', 'status', 'poll'])
@pytest.mark.parametrize('fault', [OSError, RuntimeError],
                         ids=['channel', 'engine'])
def test_only_channel_faults_drain(op, fault):
    """A replica whose channel fails (an OSError) is drained and its
    work moves to the peer, as the reference does; any other exception
    is the replica's engine failing in-process, and reaches the caller
    with nothing drained."""
    prompt = list(range(1, 13))
    a = FakeReplica('a', digest=chain_hashes(prompt, 4))
    b = FakeReplica('b')
    router = ClusterRouter([a, b], page_size=4, max_queue=4)
    req = None if op == 'submit' else router.submit(prompt,
                                                    max_new_tokens=8)

    def boom(*args, **kw):
        raise fault(f'{op} failed')
    setattr(a, op, boom)

    def act():
        if op == 'submit':
            return router.submit(prompt, max_new_tokens=8)
        if op == 'status':
            router.refresh(max_age_s=0.0)
        else:
            router.pump()
        return req
    if fault is RuntimeError:
        with pytest.raises(RuntimeError, match=f'{op} failed'):
            act()
        assert router.drain_events == [] and router.healthy_replicas() == \
            ['a', 'b']
        return
    got = act()
    assert [e['replica_id'] for e in router.drain_events] == ['a']
    assert got.replica_id == 'b' and router.healthy_replicas() == ['b']
    rec = _run_placement(PORT, _place_hung_flag)
    assert rec['snapshot']['replicas']['a']['hung']
    assert rec['healthy'] == ['b']


# ---------------------------------------------------------------------------
# two-replica clusters over bridged weights
# ---------------------------------------------------------------------------
def _shared_prefix(pkg, pair, prompts, reps):
    router, reps = _cluster(pkg, pair, reps=reps, max_queue=32, **STEADY)
    outs = router.serve(prompts, max_new_tokens=8, top_k=0)
    router.refresh()
    tables = [list(r.engine.request_table().values()) for r in reps]
    return router, reps, dict(outs=outs, tables=tables)


def _throttle(pkg, pair, prompts, reps):
    router, reps = _cluster(pkg, pair, reps=reps, max_queue=2, **STEADY)
    outs = router.serve(prompts, max_new_tokens=8, top_k=0, timeout_s=120)
    router.refresh()
    return router, reps, dict(outs=outs)


def _drain(pkg, pair, prompts, reps):
    router, reps = _cluster(pkg, pair, reps=reps, max_queue=32, **STEADY)
    reqs = [router.submit(p, max_new_tokens=12, top_k=0) for p in prompts]
    for _ in range(6):                      # partial progress
        router.pump()
    drained = reqs[0].replica_id
    moved = router.drain(drained, reason='test drain')
    router.run(timeout_s=120)
    return router, reps, dict(outs=[r.output_ids() for r in reqs],
                              reqs=_decisions(reqs), drained=drained,
                              moved=len(moved))


def _hint(pkg, pair, prompts, _reps):
    router, reps = _cluster(pkg, pair, max_queue=32,
                            engine_kw=dict(host_tier_pages=16, seed=11),
                            **STEADY)
    shared = list(range(1, 20))                 # 2+ pages shared
    stream = [shared + [50 + i] for i in range(4)]
    outs = router.serve(stream, max_new_tokens=4, top_k=0)
    for r in reps:                  # everything parked spills to host
        r.engine.pool.spill_lru(sync=True)
    before = [r.engine.pool.stats()['tier_resurrected_pages_total']
              for r in reps]
    outs2 = router.serve(stream, max_new_tokens=4, top_k=0)
    warmed = [r.engine.pool.stats()['tier_resurrected_pages_total'] - b
              for r, b in zip(reps, before)]
    return router, reps, dict(outs=outs, outs2=outs2, warmed=warmed)


CLUSTERS = {'shared_prefix': _shared_prefix, 'throttle': _throttle,
            'drain': _drain, 'hint': _hint}


@pytest.fixture(scope='module')
def clusters(pair, mixed_prompts):
    """Each scenario run once through both packages: {name: {'jax':
    (router, replicas, record), 'port': ...}}. The shared-prefix,
    throttle and drain passes run in turn on one pair of replicas per
    package (an engine per replica costs the JAX package a compile);
    the hint builds tiered ones. The replicas stay open for the tests
    that read them."""
    out = {name: {} for name in CLUSTERS}
    for tag, pkg in (('jax', JAX), ('port', PORT)):
        _router, reps = _cluster(pkg, pair)
        for name, run in CLUSTERS.items():
            out[name][tag] = run(pkg, pair, mixed_prompts, reps)
    yield out
    every = {id(r): r for runs in out.values()
             for _router, reps, _rec in runs.values() for r in reps}
    for r in every.values():
        r.shutdown()


@pytest.mark.parametrize('name', sorted(CLUSTERS))
def test_local_cluster_equals_reference(clusters, name):
    """Tokens, placements, counters and drain records equal the JAX
    cluster's."""
    (jrouter, _jr, jrec), (router, _r, rec) = (clusters[name]['jax'],
                                                clusters[name]['port'])
    assert rec['outs'] == jrec['outs']
    if name == 'hint':
        assert rec['outs2'] == rec['outs'] and rec['warmed'] == \
            jrec['warmed']
    if name == 'shared_prefix':
        keys = ('replica_id', 'router_decision', 'prompt_tokens',
                'tokens_generated')
        assert [[{k: t.get(k) for k in keys} for t in table]
                for table in rec['tables']] == \
            [[{k: t.get(k) for k in keys} for t in table]
             for table in jrec['tables']]
    if name == 'drain':
        assert (rec['reqs'], rec['drained'], rec['moved']) == \
            (jrec['reqs'], jrec['drained'], jrec['moved'])
    assert _snap(router) == _snap(jrouter)
    slo = [(v['replica_id'], v['router_decision'], v['resubmits'],
            v['tokens_generated'])
           for v in router.request_slo().values()]
    jslo = [(v['replica_id'], v['router_decision'], v['resubmits'],
             v['tokens_generated'])
            for v in jrouter.request_slo().values()]
    assert slo == jslo


@pytest.mark.parametrize('name,max_new', [
    ('shared_prefix', 8), ('throttle', 8), ('drain', 12)])
def test_local_cluster_equals_one_engine(pair, mixed_prompts, clusters,
                                         name, max_new):
    router, reps, rec = clusters[name]['port']
    assert rec['outs'] == _single(pair, mixed_prompts, max_new)
    assert all(r.engine.pool.pages_in_use == 0 for r in reps)
    snap = router.snapshot()
    assert snap['requests_done'] == len(mixed_prompts)
    if name == 'shared_prefix':
        # affinity beats round-robin, and both replicas took traffic
        assert snap['placements']['affinity'] > \
            _round_robin_affinity_hits(mixed_prompts, 2, 8)
        assert all(v['requests_routed'] > 0
                   for v in snap['replicas'].values())
    if name == 'drain':
        assert snap['placements']['drain'] == 1 and rec['moved'] > 0
        assert snap['replicas'][rec['drained']]['drained']


def test_prefetch_hint_warms_host_tier(clusters):
    router, reps, rec = clusters['hint']['port']
    snap = router.snapshot()
    assert snap['placements']['prefetch_hint'] > 0
    assert sum(rec['warmed']) >= snap['prefetch_warmed_pages'] > 0
    assert cluster_snapshot()['ptpu_route_prefetch_hints_total'] > 0
    # advisory on a tierless replica: nothing warmed, nothing broken
    _r, treps, _t = clusters['shared_prefix']['port']
    assert treps[0].prefetch(list(range(1, 20))) == {'warmed_pages': 0}


def _round_robin_affinity_hits(prompts, n_replicas, page_size):
    """The affinity hits pure round-robin placement would get (the
    reference test's baseline)."""
    digests = [set() for _ in range(n_replicas)]
    hits = 0
    for i, p in enumerate(prompts):
        h = chain_hashes(p, page_size, limit=len(p) - 1)
        r = i % n_replicas
        if h and h[0] in digests[r]:
            hits += 1
        digests[r].update(h)
    return hits


def test_route_events_reconstruct(clusters, tmp_path):
    """The replica stamps a schema-v2 `route` event; an exported journal
    reconstructs the replica and the decision of every request, as the
    reference's does."""
    from paddle_tpu.serving.request_trace import load_trace as jload
    from paddle_tpu.serving.request_trace import reconstruct as jrecon
    rows = {}
    for tag, (load, recon) in (('port', (load_trace, reconstruct)),
                               ('jax', (jload, jrecon))):
        _router, reps, _rec = clusters['shared_prefix'][tag]
        rows[tag] = []
        for rep in reps:
            path = str(tmp_path / f'{tag}_{rep.replica_id}.jsonl')
            rep.export_trace(path)
            _header, events = load(path)
            rows[tag].append([(v['replica_id'], v['router_decision'])
                              for _k, v in sorted(recon(events).items())])
    assert rows['port'] == rows['jax']
    assert all(d in ('affinity', 'least_loaded', 'spill')
               for table in rows['port'] for _rid, d in table)
    assert [{rid for rid, _d in table} for table in rows['port']] == \
        [{'r0'}, {'r1'}]


# ---------------------------------------------------------------------------
# federation, drain goodput, tenancy through the router
# ---------------------------------------------------------------------------
def _federate_then_hang(pkg, pair):
    """Four requests over two replicas and one cluster scrape; then an
    injected hang stops r1's heartbeat: the heartbeat rule (5 s) fires
    while r1 is still placed, and past hang_timeout_s (20 s) the router
    drains it."""
    t = [0.0]
    router, reps = _cluster(pkg, pair, replica_clock=lambda: t[0],
                            hang_timeout_s=20.0, refresh_interval_s=0.0,
                            clock=lambda: t[0])
    outs = router.serve([[1, 2, 3], [4, 5, 6], [7, 8, 9], [2, 4, 6]],
                        max_new_tokens=4, top_k=0)
    snap = router.cluster_snapshot()
    fed = dict(outs=outs, text=router.cluster_prometheus_text(),
               routed=[router._routed_count[r.replica_id] for r in reps],
               rules=snap['alerts']['rules'], tenants='tenants' in snap,
               process_text=pkg['monitor'].prometheus_text())
    reps[1].inject_hang()
    t[0] += 6.0
    router.pump()                       # r0 stamps its beat again
    router.refresh(max_age_s=0.0)
    hang = dict(active=[(a['rule'], a['series'], a['value'])
                        for a in router.alerts.active()],
                drained_at_alert=sorted(router._drained),
                gauge=pkg['monitor'].metrics().get('ptpu_alert_active')
                .value(rule='replica_heartbeat_stale', severity='critical'))
    t[0] += 20.0
    router.pump()
    router.refresh(max_age_s=0.0)
    hang.update(drained=sorted(router._drained),
                events=_snap(router)['drain_events'])
    router.shutdown()
    return fed, hang


@pytest.fixture(scope='module')
def fed_hang(pair):
    return {tag: _federate_then_hang(pkg, pair)
            for tag, pkg in (('jax', JAX), ('port', PORT))}


def test_federation_one_scrape_carries_both_replicas(fed_hang):
    (jfed, _jh), (fed, _h) = fed_hang['jax'], fed_hang['port']
    assert fed['outs'] == jfed['outs'] and len(fed['outs']) == 4
    assert min(fed['routed']) > 0 and fed['routed'] == jfed['routed']
    assert fed['rules'] == len(router_rules()) and fed['tenants']
    text = fed['text']
    for rid in ('r0', 'r1'):
        assert f'ptpu_serve_decode_tokens_total{{replica="{rid}"}}' in text
        assert f'ptpu_cluster_replica_beat_age_seconds{{replica="{rid}"}}' \
            in text
    assert '# age ' in text
    # the federated registry is the router's own
    assert 'ptpu_serve_decode_tokens_total{replica=' \
        not in fed['process_text']

    def series(txt):
        return sorted(line.split(' ')[0] for line in txt.splitlines()
                      if line.startswith('ptpu_'))
    assert series(text) == series(jfed['text'])


def test_hang_alert_precedes_watchdog_drain(fed_hang):
    (_jf, jhang), (_f, hang) = fed_hang['jax'], fed_hang['port']
    assert hang['active'] == [('replica_heartbeat_stale', ['r1'], 6.0)]
    assert hang['drained_at_alert'] == [] and hang['gauge'] == 1
    assert hang['drained'] == ['r1']
    assert hang == jhang


def test_federation_http_endpoint(pair):
    import urllib.request
    router, reps = _cluster(PORT, pair, refresh_interval_s=0.0)
    router.serve([[1, 2, 3], [4, 5, 6]], max_new_tokens=2, top_k=0)
    router.federate()
    srv = router.serve_metrics_http(port=0)
    try:
        url = f'http://127.0.0.1:{srv.port}/metrics'
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert 'ptpu_serve_decode_tokens_total{replica="r0"}' in body
        snap = json.loads(urllib.request.urlopen(
            url + '.json', timeout=10).read().decode())
        assert 'ptpu_cluster_replica_queue_depth' in json.dumps(snap)
    finally:
        srv.close()
        router.shutdown()


def test_drain_resubmit_goodput(clusters):
    """The prefix a peer re-prefills after a drain is priced wasted
    (cause drain_recompute), moved from delivered, as the reference's."""
    (jrouter, _jr, _j), (router, _r, _rec) = (clusters['drain']['jax'],
                                               clusters['drain']['port'])
    g, jg = router.snapshot()['goodput'], jrouter.snapshot()['goodput']
    assert g == jg
    assert g['drain_recompute_tokens'] > 0
    assert g['wasted_by_cause']['drain_recompute'] > 0
    assert g['delivered_tokens'] + g['wasted_tokens'] == g['emitted_tokens']
    reps = [row['goodput'] for row in router.snapshot()['replicas'].values()
            if row.get('goodput')]
    moved = g['wasted_by_cause']['drain_recompute']
    assert g['emitted_tokens'] == sum(r['emitted_tokens'] for r in reps)
    assert g['delivered_tokens'] == sum(r['delivered_tokens']
                                        for r in reps) - moved
    assert cluster_snapshot()['ptpu_route_drain_recompute_tokens_total'] \
        >= g['drain_recompute_tokens']


def _tenancy(pkg, pair, case):
    """One replica behind the router: 'backpressure' (max_queue 1),
    'deadline' (an engine-side deadline refusal, then a request with
    tenant options) or 'serve' (max_queue 2, serve() to completion)."""
    model = _model(pair, pkg)
    eng = pkg['Engine'](model, page_size=8, max_batch_size=2,
                        prefill_chunk=8)
    rep = pkg['Local'](eng, 'r0')
    kw = {'backpressure': dict(max_queue=1, refresh_interval_s=0.0),
          'deadline': dict(max_queue=64), 'serve': dict(max_queue=2)}[case]
    router = pkg['Router']([rep], page_size=8, **kw)
    rng = np.random.RandomState(6)
    rec = {}
    if case == 'serve':
        prompts = [list(rng.randint(1, 128, 4)) for _ in range(6)]
        rec['outs'] = router.serve(prompts, max_new_tokens=4, top_k=0,
                                   timeout_s=300)
        rec['done'] = router.snapshot()['requests_done']
        router.shutdown()
        return rec
    # a decode rate exists (the hint's input), then a backlog
    eng.generate([list(rng.randint(1, 128, 4))], max_new_tokens=4, top_k=0)
    router.submit(list(rng.randint(1, 128, 6)), max_new_tokens=8, top_k=0)
    extra = {} if case == 'backpressure' else dict(deadline_s=1e-9)
    with pytest.raises(pkg['Rejected']) as ei:
        router.submit(list(rng.randint(1, 128, 4)), max_new_tokens=4,
                      top_k=0, **extra)
    hint = ei.value.retry_after_s
    assert hint is not None and hint > 0
    rec.update(reason=ei.value.reason, healthy=router.healthy_replicas(),
               drains=len(router.snapshot()['drain_events']),
               rejects=router.snapshot()['rejects'])
    router.run(timeout_s=120)
    if case == 'deadline':
        r = router.submit(list(rng.randint(1, 128, 4)), max_new_tokens=4,
                          top_k=0, tenant_id='gold', priority=2)
        req = rep._reqs[r.remote_rid]
        rec.update(tenant=(req.tenant_id, req.priority))
        router.run(timeout_s=120)
        rec.update(done=r.done, tokens=r.tokens,
                   tenants=router.cluster_snapshot()['tenants'],
                   spills='tenant_spills' in router.snapshot())
    router.shutdown()
    return rec


@pytest.fixture(scope='module')
def tenancy(pair):
    return {case: {tag: _tenancy(pkg, pair, case)
                   for tag, pkg in (('jax', JAX), ('port', PORT))}
            for case in ('backpressure', 'deadline', 'serve')}


@pytest.mark.parametrize('case,key,want', [
    ('backpressure', 'reason', 'backpressure'),
    ('deadline', 'reason', 'deadline_unmet'),
    ('deadline', 'tenant', ('gold', 2)),
    ('serve', 'done', 6)])
def test_tenancy_through_router_equals_reference(tenancy, case, key, want):
    """Structured rejections (reason and a positive hint; the hint's
    value follows each engine's measured decode rate), an engine-side
    deadline refusal that drains nothing, tenant options reaching the
    engine, and serve() backing off by the hint to completion."""
    got = tenancy[case]['port']
    assert got == tenancy[case]['jax']
    assert got[key] == want
    if case == 'deadline':
        assert got['healthy'] == ['r0'] and got['drains'] == 0
        assert got['done'] and len(got['tokens']) == 4


# ---------------------------------------------------------------------------
# the package surface and the disaggregation knobs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('name,module', [
    ('RemoteReplica', 'replica'), ('ReplicaWorker', 'replica'),
    ('DisaggregatedEngine', 'disagg'), ('build_engine', 'disagg'),
    ('stream_kv_pages', 'page_stream')])
def test_cluster_names_resolve(name, module):
    """Each name the reference package exports resolves to the ported
    object of its module; an unknown name raises AttributeError."""
    import importlib
    mod = importlib.import_module(f'paddle_tpu_torch.serving.cluster.'
                                  f'{module}')
    obj = getattr(tcluster, name)
    assert obj is getattr(mod, name) and callable(obj)
    assert name in tcluster.__all__
    with pytest.raises(AttributeError):
        tcluster.no_such_name


def test_cluster_all_equals_reference():
    import paddle_tpu.serving.cluster as jcluster
    assert tcluster.__all__ == jcluster.__all__
    assert all(hasattr(tcluster, n) for n in tcluster.__all__)


@pytest.mark.parametrize('knob', [{'disaggregate': True},
                                  {'disaggregate': True, 'prefill_slots': 1},
                                  {'disaggregate': True,
                                   'stream_chunk_pages': 1}])
def test_disaggregation_knobs_serve_through_build_engine(pair, knob):
    """Each knob builds an engine through build_engine that serves two
    requests to the end with both pools drained."""
    eng = tcluster.build_engine(pair[1], ServingConfig(**ENGINE_KW, **knob),
                                device='cpu')
    assert isinstance(eng, tcluster.DisaggregatedEngine)
    assert eng.prefill.config.max_batch_size == knob.get('prefill_slots', 2)
    out = eng.generate([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [2, 7, 1, 8]],
                       max_new_tokens=4, top_k=0)
    assert [len(o) for o in out] == [14, 8]
    st = eng.stats()
    assert st['requests_completed_total'] == 2 and \
        st['pd_handoffs_total'] == 2
    assert eng.decode.pool.pages_in_use == eng.prefill.pool.pages_in_use == 0
    eng.shutdown()
