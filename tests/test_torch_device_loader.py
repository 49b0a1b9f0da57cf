"""The port's DeviceLoader (io/device_loader.py) and host async
(core/async_step.py) against the JAX package's, on the CPU.

- `DeviceLoader` yields the same batches in the same order as the
  reference's over the same upstream loader, with the same counters;
  the staging ring never changes a batch already handed out; a second
  iteration after an early break, `close()` and an upstream error end
  their staging thread (every test that starts one joins it).
- The prefetch and window knobs resolve as the reference's; the gap
  monitor's snapshot equals the reference's on the same injected clock;
  `host_snapshot` carries the prefetch totals.
- The headline loop in miniature: the pipeline engine's windowed loop
  through a DeviceLoader gives the synchronous loop's losses bit for bit,
  and with the metric history, the alert pack, the ledger and the
  loader on it makes exactly the host fetches it makes with them off.
"""
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.core import async_step as jasync
from paddle_tpu.io import DeviceLoader as JLoader
from paddle_tpu_torch.core import alerts as talerts
from paddle_tpu_torch.core import async_step as tasync
from paddle_tpu_torch.core import ledger as tledger
from paddle_tpu_torch.core import monitor as tmon
from paddle_tpu_torch.core import numerics as tnum
from paddle_tpu_torch.io import DeviceLoader
from torch_threads import one_intra_op_thread  # noqa: F401


def _batches(n, seed=0, shape=(4, 8)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 100, shape).astype(np.int32),
             rng.normal(0, 1, shape[:1]).astype(np.float32))
            for _ in range(n)]


def _threads():
    return {t for t in threading.enumerate()
            if t.name == 'ptpu-device-prefetch'}


@pytest.fixture(autouse=True)
def _joined():
    before = _threads()
    yield
    for t in _threads() - before:
        t.join(timeout=5)
        assert not t.is_alive()


@pytest.mark.parametrize('depth', [1, 2, 3])
def test_same_batches_order_and_stats_as_the_reference(depth):
    src = _batches(7, seed=depth)
    jl = JLoader(src, depth=depth)
    tl = DeviceLoader(src, device='cpu', depth=depth)
    want = [[np.asarray(a) for a in b] for b in jl]
    got = [[t.numpy() for t in b] for b in tl]
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    js, ts = jl.stats(), tl.stats()
    for k in ('batches', 'h2d_bytes', 'ring_reuses', 'depth'):
        assert ts[k] == js[k], k
    assert len(tl) == 7


def test_ring_reuse_never_changes_a_handed_out_batch():
    src = _batches(9, seed=4)
    loader = DeviceLoader(src, device='cpu', depth=1)
    kept = [b for b in loader]          # the ring (2 slots) wraps 4 times
    for b, (ids, y) in zip(kept, src):
        assert np.array_equal(b[0].numpy(), ids)
        assert np.array_equal(b[1].numpy(), y)
    assert loader.stats()['ring_reuses'] == 7
    single = DeviceLoader([np.arange(3)], device='cpu')
    assert [b[0].tolist() for b in single] == [[0, 1, 2]]   # a 1-tuple


def test_reiteration_after_an_early_break_and_close():
    loader = DeviceLoader(_batches(20), device='cpu', depth=2)
    for i, _b in enumerate(loader):
        if i == 2:
            break
    again = [b[0].numpy() for b in loader]
    assert len(again) == 20
    gate = threading.Event()

    def slow():
        yield _batches(1)[0]
        gate.wait(10)
        yield _batches(1)[0]
    loader = DeviceLoader(slow(), device='cpu')
    it = iter(loader)
    next(it)
    threading.Timer(0.05, lambda: (loader.close(), gate.set())).start()
    assert list(it) == []               # close() ends the waiting consumer


def test_upstream_error_surfaces():
    def bad():
        yield _batches(1)[0]
        raise RuntimeError('upstream broke')
    with pytest.raises(RuntimeError, match='upstream broke'):
        list(DeviceLoader(bad(), device='cpu'))


def test_knobs_resolve_as_the_reference(monkeypatch):
    for env in (None, '', '3', 'x', '0'):
        for var in ('PTPU_DEVICE_PREFETCH', 'PTPU_DISPATCH_WINDOW'):
            if env is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, env)
        assert tasync.resolve_prefetch_depth() == \
            jasync.resolve_prefetch_depth()
        assert tasync.resolve_dispatch_window() == \
            jasync.resolve_dispatch_window()
        assert tasync.resolve_prefetch_depth(4) == 4


def test_gap_monitor_snapshot_equals_the_reference():
    snaps = []
    for mod in (jasync, tasync):
        t = [0.0]
        mon = mod.HostGapMonitor('gap_parity', clock=lambda: t[0])
        rng = np.random.RandomState(2)
        for i in range(12):
            t[0] += float(rng.uniform(0.001, 0.01))
            mon.dispatch_begin()
            t[0] += 0.002
            mon.dispatch_end(depth=1 + i % 3)
            if i % 2:
                mon.note_gating(float(rng.uniform(0, 0.004)))
            else:
                mon.note_blocked(float(rng.uniform(0, 0.004)))
            mon.step_ready()
        snaps.append(mon.snapshot())
        mod.unregister_monitor(mon)
    assert snaps[1] == snaps[0]
    assert 'gap_parity' not in tasync.host_snapshot()['sites']


def _pipeline():
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline as tsp)
    from paddle_tpu_torch.models import gpt as tgpt
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=16, hidden_dropout=0.0,
                         attn_dropout=0.0)
    return tsp.SpmdPipelineEngine(
        *tgpt.build_gpt_pipeline(cfg, generator=torch.Generator()
                                 .manual_seed(0)),
        topt.AdamW(learning_rate=1e-3), accumulate_steps=2, device='cpu',
        dispatch_window=2)


def _windowed(eng, batches, telemetry):
    """The bench's windowed trial: DeviceLoader + train_step, one
    result() at the end; with `telemetry` the history, the default alert
    pack and a ledger publish ride along. Returns the step losses."""
    reg = tmon.metrics()
    hist = alerts = None
    if telemetry:
        hist = reg.enable_history(capacity=240)
        alerts = talerts.AlertManager(hist, rules=talerts.default_rules(),
                                      source='test')
    try:
        results = [eng.train_step(b) for b in
                   DeviceLoader(batches, engine=eng)]
        eng.flush()
        results[-1].result()
        if telemetry:
            reg.history_tick()
            hist.export(max_points=24)
            assert alerts.summary()['fired_critical'] == 0
            assert eng._ledger.account() is not None
    finally:
        if alerts is not None:
            alerts.detach()
        reg.history = None
    return results


def test_windowed_loop_bit_equal_and_no_added_fetches(monkeypatch):
    src = [(ids, np.roll(ids, -1, 1)) for ids, _y in
           _batches(3, seed=6, shape=(4, 16))]
    for i, (ids, lab) in enumerate(src):
        src[i] = (ids % 64, lab % 64)
    sync_eng = _pipeline()
    want = [float(sync_eng.train_batch(b)) for b in src]
    counts = {}
    for telemetry in (False, True):
        fetches = {'result': 0, 'numerics': 0, 'item': 0}
        real = tnum._host_fetch
        real_result = tasync.AsyncResult.result
        real_float = torch.Tensor.__float__

        def counting(tree, real=real, fetches=fetches):
            fetches['numerics'] += 1
            return real(tree)

        def result(res, fetches=fetches):
            fetches['result'] += 1
            return real_result(res)

        def to_float(t, fetches=fetches):
            fetches['item'] += 1
            return real_float(t)
        monkeypatch.setattr(tnum, '_host_fetch', counting)
        monkeypatch.setattr(tasync.AsyncResult, 'result', result)
        monkeypatch.setattr(torch.Tensor, '__float__', to_float)
        eng = _pipeline()
        results = _windowed(eng, src, telemetry)
        counts[telemetry] = dict(fetches)
        monkeypatch.undo()
        assert [float(r.loss) for r in results] == want
        snap = eng.host_gap_snapshot()
        assert snap['steps'] == 3 and snap['dispatch_depth_max'] <= 3
        eng.shutdown()
    # the one loss fetch at the trial's end (result() reads it once)
    assert counts[True] == counts[False] == \
        {'result': 1, 'numerics': 0, 'item': 1}
    host = tasync.host_snapshot()
    assert host['prefetch']['batches'] >= 6
    assert tledger.ledger_snapshot('pipeline') is not None


def test_waits_attribute_gating_and_blocked_as_the_reference():
    """A wait on the newest dispatched step (the synchronous discipline)
    is host gap (note_gating); a wait on an older step, with newer ones
    queued behind it (the window's drain), is blocked time."""
    eng = _pipeline()
    calls = []
    gap = eng._gap
    gap.note_gating = lambda s: calls.append('gating')
    gap.note_blocked = lambda s: calls.append('blocked')
    ids = np.random.RandomState(0).randint(0, 64, (4, 16)).astype('int32')
    batch = (ids, np.roll(ids, -1, 1))
    eng.train_batch(batch)
    eng.train_batch(batch)
    assert calls == ['gating', 'gating']
    calls.clear()
    for _ in range(4):                   # window 2: two drains on push
        eng.train_step(batch)
    assert calls == ['blocked', 'blocked']
    eng.flush()
    assert calls == ['blocked', 'blocked', 'blocked', 'gating']
    eng.shutdown()
