"""The port's serving ledger against the JAX package's
(tests/test_serving_ledger.py): the same call sequences through
ServeLedger give the same wall decomposition, goodput account, roofline
and rendering; the peaks are keyed on the CUDA device name (an H100's
figures, None for the CPU, a TPU name or an unknown card); and on bridged
weights the port's engine charges the reference's delivered and wasted
tokens — ample pool, preemption with speculative rejection (with the
trace pricing every request to the same totals), the ladder's spec shed
— reconciles its wall, reports a host-bound fraction from its fetches,
unregisters at shutdown and adds no host fetch."""
import json

import numpy as np
import pytest

from paddle_tpu.serving import ledger as jledger
from paddle_tpu_torch.core import async_step
from paddle_tpu_torch.core import ledger as tcore_ledger
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving import ledger as tledger
from paddle_tpu_torch.serving.metrics import serve_snapshot
from paddle_tpu_torch.serving.request_trace import load_trace, reconstruct
from torch_serving_twin import Twin, model_pair
from torch_threads import one_intra_op_thread  # noqa: F401

H100 = 'NVIDIA H100 80GB HBM3'


@pytest.fixture(scope='module')
def pair():
    return model_pair(seed=7)


@pytest.fixture(scope='module')
def mixed_prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, 128, int(n)))
            for n in (11, 5, 17, 8, 23, 6)]


@pytest.fixture
def clean_registry(monkeypatch):
    """Isolate both ledger registries from engines of other tests."""
    monkeypatch.setattr(tledger, '_ledgers', {})
    monkeypatch.setattr(jledger, '_ledgers', {})


# ---------------------------------------------------------------------------
# units: the same calls through both ServeLedgers
# ---------------------------------------------------------------------------
def _ledger_calls(mod):
    out = []
    kw = dict(n_params=10 ** 6, layers=2, hidden=64, param_bytes=1000,
              kv_bytes_per_token=10, peak_hbm_gbps=100.0, peak_tflops=1.0)
    led = mod.ServeLedger(engine='u0', **kw)
    out += [led.account(), led.roofline()]
    led.observe_iteration(wall=0.010, compute=0.004, host_fetch=0.002,
                          schedule=0.001)
    out.append(led.account())
    led.observe_iteration(wall=0.010, compute=0.020, host_fetch=0.004,
                          schedule=0.002, decode_seconds=0.004,
                          kv_read_tokens=50)
    led.note_page_stream(0.5)
    led.note_page_stream(0.25)
    led.observe_iteration(wall=2.0, compute=0.5, decode_seconds=0.004,
                          kv_read_tokens=150, prefill_tokens=32,
                          prefill_seconds=0.01, prefill_ctx_tokens=640)
    led.account_prefill(5, 2, tenant_id='a')
    led.account_decode(3, 1, tenant_id='b')
    led.account_decode(2, 0)
    led.account_spec_shed(4)
    led.account_fused_window(4, 3, 7)
    out += [led.account(), led.goodput(), led.roofline()]
    out.append(mod.render_serve_ledger(mod.serve_ledger_snapshot()))
    l2 = mod.ServeLedger(engine='u0')
    led.unregister()                    # stale: must not evict l2
    out.append(mod.serve_ledger_snapshot()['goodput'])
    l2.unregister()
    out.append(mod.serve_ledger_snapshot())
    led.reset()
    out += [led.account(), led.goodput()]
    return out


def test_ledger_units_equal_reference(clean_registry):
    got, ref = _ledger_calls(tledger), _ledger_calls(jledger)
    assert got == ref


def test_peaks_keyed_on_cuda_name():
    assert tledger.resolve_peak_hbm_gbps(H100) == 3350.0
    assert tcore_ledger.resolve_peak_tflops(H100) == 989.0
    for kind in ('cpu', 'TPU v5p', 'Trillium', 'NVIDIA A100-SXM4-80GB',
                 'Radeon'):
        assert tledger.resolve_peak_hbm_gbps(kind) is None
        assert tcore_ledger.resolve_peak_tflops(kind) is None
    # no card here: the local peak is None, so MBU/MFU read None
    assert tledger.resolve_peak_hbm_gbps() is None
    assert tcore_ledger.resolve_peak_tflops() is None
    assert all(p > 0 for p in tledger.HBM_GBPS.values())
    led = tledger.ServeLedger(engine='pk', param_bytes=64,
                              kv_bytes_per_token=4, device_kind=H100)
    led.observe_iteration(wall=0.01, decode_seconds=0.002,
                          kv_read_tokens=16)
    r = led.roofline()
    assert r['peak_hbm_gbps'] == 3350.0
    assert r['mbu'] == pytest.approx(r['hbm_gbps'] / 3350.0)
    led.unregister()
    assert tcore_ledger.model_flops_per_step(10, 4, 2, 8, 3) == \
        (6.0 * 10 * 4 + 12.0 * 2 * 8 * 3 * 4, 12.0 * 2 * 8 * 3 * 4)


# ---------------------------------------------------------------------------
# engine scenarios against the reference engine
# ---------------------------------------------------------------------------
def test_goodput_ample_pool(pair, mixed_prompts):
    tw = Twin(pair, page_size=8, max_batch_size=3, prefill_chunk=16,
              prefix_cache=False)
    outs = tw.generate(mixed_prompts, max_new_tokens=6)
    tw.check()
    g = tw.port.ledger.goodput()
    expect = sum(len(o) - 1 for o in outs)
    assert g['delivered_tokens'] == g['emitted_tokens'] == expect
    assert g['wasted_tokens'] == 0 and g['spec_shed_tokens'] == 0
    tw.shutdown()


def test_goodput_under_preemption_and_spec(pair, tmp_path):
    prompts = [[7, 8, 9] * 5, [3, 4] * 6, [5, 6, 7] * 6, [9, 2] * 7]
    tw = Twin(pair, page_size=8, max_batch_size=3, prefill_chunk=8,
              num_pages=4, spec_k=4)
    tw.generate(prompts, max_new_tokens=8)
    tw.check()
    st, g = tw.port.stats(), tw.port.ledger.goodput()
    assert st['preemptions_total'] > 0
    assert st['spec_proposed_tokens_total'] > 0
    assert g['delivered_tokens'] + g['wasted_tokens'] == g['emitted_tokens']
    assert g['wasted_by_cause']['preempt_recompute'] > 0
    path = str(tmp_path / 'serve.jsonl')
    tw.port.export_trace(jsonl_path=path)
    _h, events = load_trace(path)
    table = reconstruct(events)
    assert sum(r['delivered_tokens'] for r in table.values()) \
        == g['delivered_tokens']
    assert sum(r['wasted_tokens'] for r in table.values()) \
        == g['wasted_tokens']
    assert sum(r['recompute_tokens'] for r in table.values()) \
        == g['wasted_by_cause']['preempt_recompute']
    tw.shutdown()


@pytest.mark.parametrize('fused_k', [1, 4])
def test_degrade_shed_outside_identity(pair, fused_k):
    prompts = [[7, 8, 9] * 5, [3, 4] * 6]
    tw = Twin(pair, page_size=8, max_batch_size=2, prefill_chunk=8,
              spec_k=4, fused_k=fused_k, degrade=True, tenants={},
              degrade_hold=10 ** 9)
    tw.ref._ladder.stage = tw.port._ladder.stage = 1
    tw.generate(prompts, max_new_tokens=8)
    tw.check()
    g = tw.port.ledger.goodput()
    st = tw.port.stats()
    assert st['spec_proposed_tokens_total'] == 0
    assert st['fused_windows_total'] == 0           # stage 1 sheds both
    assert g['spec_shed_tokens'] > 0
    assert g['wasted_by_cause']['spec_rejected'] == 0
    tw.shutdown()


def test_ledger_reconciles_and_unregisters(pair, mixed_prompts,
                                           clean_registry):
    eng = ServingEngine(pair[1], ServingConfig(
        page_size=8, max_batch_size=3, prefill_chunk=16), device='cpu')
    eng.generate(mixed_prompts, max_new_tokens=6)
    a = eng.ledger.account()
    assert a['iterations'] > 0 and a['wall_seconds'] > 0.0
    assert abs(sum(a['components'].values()) - a['wall_seconds']) \
        <= 0.10 * a['wall_seconds']
    assert a['components']['compute'] > 0.0
    assert a['components']['host_fetch'] > 0.0
    assert 0.0 <= a['host_bound_fraction'] <= 1.0
    roof = eng.ledger.roofline()
    assert roof['decode_bytes_per_iteration'] > 0
    assert roof['mbu'] is None and roof['peak_hbm_gbps'] is None
    assert roof['prefill_tflops'] > 0.0 and roof['prefill_mfu'] is None
    eng.publish_metrics()
    s = serve_snapshot()
    assert s['ledger']['serve']['wall_seconds'] > 0
    g = s['goodput']
    assert g['delivered_tokens'] + g['wasted_tokens'] \
        == g['emitted_tokens'] > 0
    reg = monitor.metrics()
    assert reg.get('ptpu_serve_goodput_emitted_tokens').value(
        engine='serve') == g['emitted_tokens']
    assert reg.get('ptpu_serve_ledger_wall_seconds').value(
        engine='serve') > 0
    assert 'serve' in async_step._monitors
    eng.shutdown()
    assert tledger.serve_ledger_snapshot() is None
    assert 'serve' not in async_step._monitors


def test_ledger_adds_no_host_fetch(pair, mixed_prompts, monkeypatch):
    count = [0]
    real = engine_mod._host_fetch

    def counting(x):
        count[0] += 1
        return real(x)
    monkeypatch.setattr(engine_mod, '_host_fetch', counting)
    eng = ServingEngine(pair[1], ServingConfig(
        page_size=8, max_batch_size=3, prefill_chunk=8, num_pages=4),
        device='cpu')
    eng.generate(mixed_prompts, max_new_tokens=6)
    n = count[0]
    st = eng.stats()
    eng.ledger.account()
    eng.ledger.goodput()
    eng.ledger.roofline()
    eng.publish_metrics()
    assert count[0] == n
    assert n == eng.prefill_fetches + st['decode_steps_total']
    eng.shutdown()


@pytest.mark.parametrize('version', [1, 2, 3, 4, 5, 6])
def test_older_schemas_still_load(version, tmp_path):
    p = tmp_path / f'v{version}.jsonl'
    events = [
        {'event': 'submit', 'req': 0, 't': 1.0, 'prompt_tokens': 4},
        {'event': 'admit', 'req': 0, 't': 1.1},
        {'event': 'prefill_chunk', 'req': 0, 't': 1.2, 'tokens': 4},
        {'event': 'first_token', 'req': 0, 't': 1.3, 'tokens_generated': 1},
        {'event': 'decode', 'req': 0, 't': 1.4, 'tokens_generated': 2},
        {'event': 'retire', 'req': 0, 't': 1.5, 'tokens_generated': 2}]
    with open(p, 'w') as f:
        f.write(json.dumps({'schema': f'paddle_tpu.serve_trace/{version}',
                            'dropped_events': 0}) + '\n')
        for e in events:
            f.write(json.dumps(e) + '\n')
    hdr, evs = load_trace(str(p))
    assert hdr['schema'].endswith(f'/{version}')
    (r,) = reconstruct(evs).values()
    assert r['recompute_tokens'] == 0 and r['spec_discarded'] == 0
    assert r['delivered_tokens'] == 4 + (2 - 1)
    assert r['wasted_tokens'] == 0
    bad = tmp_path / 'v99.jsonl'
    bad.write_text(json.dumps({'schema': 'paddle_tpu.serve_trace/99'}))
    with pytest.raises(ValueError, match='unsupported'):
        load_trace(str(bad))
