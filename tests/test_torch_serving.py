"""paddle_tpu_torch serving vs the JAX package's serving engine.

The port's ServingEngine(device='cpu') must emit greedy tokens
IDENTICAL to paddle_tpu's ServingEngine on the same bridged weights —
for a mixed-length stream, under preemption (a pool too small for the
concurrent contexts), with shared prompt prefixes, and with the prefix
cache off; with int8 KV pages, int8 weights and both; with speculative
decoding (spec_k 2 and 4, on the mixed stream and on a repetitive one
the n-gram proposer fires on); with fused decode windows (fused_k 4 and
8: mixed, eos and budget cuts inside a window, page boundaries crossed
inside a window, preempt/resume) — and make the same scheduling
decisions (preemptions, prefix hits, prefill chunks, decode steps,
drafts proposed and accepted, fused windows and their iterations). The
page allocator's invariants (tests/test_serving.py's TestPageAllocator
and TestPrefixCacheAllocator, and try_reserve) are held on the port's
KVPagePool as one parametrised test.

Sampled tokens cannot match JAX's (threefry draws); sampling is held
within the port: the same seed gives the same tokens, fused and serial
windows and preempted and unpressured runs agree, top_k=1 is greedy,
every token lies in its row's top-k set, another seed gives another
stream, and the top-k mask is the JAX function's own on the same
logits.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.quantization import quantize_to_int8 as jquantize_to_int8
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import kv_pool as jkv_pool
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.quantization import quantize_to_int8
from paddle_tpu_torch.serving import (KVPagePool, PoolExhausted, Request,
                                      RequestState, Scheduler,
                                      ServingConfig, ServingEngine,
                                      chain_hash, chain_hashes)
from paddle_tpu_torch.serving import engine as tengine
from torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=128, hidden_dropout=0.0, attn_dropout=0.0,
            use_flash_attention=False)


@pytest.fixture(scope='module')
def models():
    paddle.seed(7)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    load_jax_params(tm, {n: np.asarray(p.data)
                         for n, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _mixed_prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, 128, n)) for n in (5, 11, 3, 17, 8)]


def _shared_prefix_prompts():
    rng = np.random.RandomState(11)
    system = list(rng.randint(1, 128, 24))
    return [system + list(rng.randint(1, 128, n)) for n in (4, 7, 5, 9)]


def _repetitive_prompts():
    """Prompts that repeat a short phrase: the n-gram proposer drafts
    from the first decode step on."""
    rng = np.random.RandomState(5)
    return [list(rng.randint(1, 128, n)) * r for n, r in ((3, 4), (5, 3),
                                                           (2, 6))]


MIXED = dict(page_size=8, max_batch_size=3, prefill_chunk=8)
STREAMS = {
    'mixed': (_mixed_prompts, dict(page_size=8, max_batch_size=3,
                                   prefill_chunk=8), {}),
    'int8_kv_mixed': (_mixed_prompts, dict(MIXED, kv_dtype='int8'), {}),
    'int8_kv_preempt': (_mixed_prompts, dict(MIXED, num_pages=4,
                                             kv_dtype='int8'), {}),
    'int8_kv_shared_prefix': (_shared_prefix_prompts, dict(
        page_size=8, max_batch_size=2, prefill_chunk=8, kv_dtype='int8'),
        {}),
    'int8_weights': (_mixed_prompts, dict(MIXED, weight_dtype='int8'), {}),
    'int8_weights_kv': (_mixed_prompts, dict(MIXED, weight_dtype='int8',
                                             kv_dtype='int8'), {}),
    'spec2_mixed': (_mixed_prompts, dict(MIXED, spec_k=2),
                    {'max_new_tokens': 16}),
    'spec4_mixed': (_mixed_prompts, dict(MIXED, spec_k=4),
                    {'max_new_tokens': 16}),
    'spec2_repetitive': (_repetitive_prompts, dict(MIXED, spec_k=2),
                         {'max_new_tokens': 12}),
    'spec4_repetitive': (_repetitive_prompts, dict(MIXED, spec_k=4),
                         {'max_new_tokens': 12}),
    'preempt': (_mixed_prompts, dict(page_size=8, max_batch_size=3,
                                     prefill_chunk=8, num_pages=4), {}),
    'no_prefix_cache': (_mixed_prompts, dict(
        page_size=8, max_batch_size=3, prefill_chunk=8,
        prefix_cache=False), {}),
    'eos': (_mixed_prompts, dict(page_size=8, max_batch_size=3,
                                 prefill_chunk=8), {'eos_token_id': 22}),
    'shared_prefix': (_shared_prefix_prompts, dict(
        page_size=8, max_batch_size=2, prefill_chunk=8), {}),
    'shared_prefix_preempt': (_shared_prefix_prompts, dict(
        page_size=8, max_batch_size=3, prefill_chunk=8, num_pages=7), {}),
}

SAME_STATS = ('requests_completed_total', 'preemptions_total',
              'decode_steps_total', 'decode_tokens_total',
              'prefill_tokens_total', 'prefill_chunks_total',
              'prefix_hits_total', 'prefix_hit_tokens_total',
              'weight_dtype', 'quantized_params',
              'spec_proposed_tokens_total', 'spec_accepted_tokens_total',
              'spec_steps_total', 'spec_acceptance_rate',
              'fused_windows_total', 'fused_iterations_total',
              'fused_tokens_total')


def _both(models, prompts, cfg, **gen_kw):
    """(port tokens, port stats, JAX tokens, JAX stats) of one greedy
    stream through both engines; the port's pool must drain."""
    jm, tm = models
    gen = dict({'max_new_tokens': 6}, **gen_kw)
    jeng = JEngine(jm, JConfig(**cfg))
    ref = jeng.generate(prompts, top_k=0, **gen)
    jst = jeng.stats()
    jeng.shutdown()
    teng = ServingEngine(tm, ServingConfig(**cfg), device='cpu')
    out = teng.generate(prompts, **gen)
    tst = teng.stats()
    assert teng.pool.pages_in_use == 0
    assert teng.pool.free_pages == teng.pool.num_pages
    assert tst['pool']['kv_dtype'] == jst['pool']['kv_dtype']
    assert tst['pool']['bytes_per_token'] == jst['pool']['bytes_per_token']
    teng.shutdown()
    assert teng.pool.kv is None
    return out, tst, ref, jst


@pytest.mark.parametrize('stream', sorted(STREAMS))
def test_engine_tokens_identical_to_jax(models, stream):
    prompts_fn, cfg, gen_kw = STREAMS[stream]
    prompts = prompts_fn()
    out, tst, ref, jst = _both(models, prompts, cfg, **gen_kw)
    assert out == ref
    for key in SAME_STATS:
        assert tst[key] == jst[key], key
    if 'preempt' in stream:
        assert tst['preemptions_total'] > 0
    if stream == 'eos':                        # one request stops early
        assert any(len(o) < len(p) + 6 for o, p in zip(out, prompts))
    if 'shared_prefix' in stream:
        assert tst['prefix_hits_total'] >= 3
        assert tst['prefix_cached_pages'] > 0
    if 'int8_kv' in stream:
        assert tst['pool']['kv_dtype'] == 'int8'
    if 'weights' in stream:
        assert tst['quantized_params'] == 4 * TINY['num_layers']
    if 'repetitive' in stream:
        assert tst['spec_accepted_tokens_total'] > 0
        assert tst['decode_steps_total'] < tst['decode_tokens_total']


FUSED_PROMPTS = (5, 11, 3, 8)


def _fused_prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, 128, n)) for n in FUSED_PROMPTS]


FUSED_SCENARIOS = {
    # name: (engine knobs beyond MIXED-like defaults, generate knobs)
    'mixed': ({}, {'max_new_tokens': 12}),
    'eos_mid_window': ({}, {'max_new_tokens': 12, 'eos_token_id': 'auto'}),
    'budget_cut': ({}, {'max_new_tokens': 11}),
    'page_boundary': ({'page_size': 2, 'num_pages': 256},
                      {'max_new_tokens': 12}),
    'preempt_resume': ({'max_batch_size': 3, 'num_pages': 4},
                       {'max_new_tokens': 6}),
}


@pytest.mark.parametrize('scenario', sorted(FUSED_SCENARIOS))
@pytest.mark.parametrize('fused_k', [4, 8])
def test_fused_windows_identical_to_jax(models, fused_k, scenario):
    """tests/test_serving_fused.py's scenarios on both engines: fused
    windows emit the JAX engine's tokens with its window counters, and
    the serial engine's tokens."""
    knobs, gen_kw = FUSED_SCENARIOS[scenario]
    cfg = dict(dict(page_size=8, max_batch_size=4, prefill_chunk=8,
                    seed=11), **knobs)
    prompts = _fused_prompts()
    gen_kw = dict(gen_kw)
    if gen_kw.get('eos_token_id') == 'auto':
        # an eos from the reference stream itself, third generated token
        # of the first row: it cuts that row inside a window
        base, _st, _r, _j = _both(models, prompts, dict(cfg, fused_k=1),
                                  max_new_tokens=12)
        gen_kw['eos_token_id'] = base[0][len(prompts[0]) + 2]
    serial, _st, _r, _j = _both(models, prompts, dict(cfg, fused_k=1),
                                **gen_kw)
    out, tst, ref, jst = _both(models, prompts, dict(cfg, fused_k=fused_k),
                               **gen_kw)
    assert out == ref == serial
    for key in SAME_STATS:
        assert tst[key] == jst[key], key
    assert tst['fused_windows_total'] > 0 and tst['fused_k'] == fused_k
    if scenario == 'eos_mid_window':
        assert any(o[-1] == gen_kw['eos_token_id'] and len(o) - len(p) < 12
                   for o, p in zip(out, prompts))
    if scenario == 'budget_cut':
        assert all(len(o) - len(p) == 11 for o, p in zip(out, prompts))
    if scenario == 'preempt_resume':
        assert tst['preemptions_total'] > 0


def test_fused_window_fetches_once_and_spares_page_0(models, monkeypatch):
    # one host fetch per window (tests/test_serving_fused.py:174), and
    # the idle slot's q_len-0 writes land in the sink page, never in
    # page 0, which the live request owns (the pool hands out page 0
    # first): page 0 ends bit-equal to the serial run's
    _jm, tm = models
    prompt = _fused_prompts()[:1]
    pools = {}
    for k in (1, 4):
        counts = [0]
        real = tengine._host_fetch

        def counting(x, real=real, counts=counts):
            counts[0] += 1
            return real(x)
        monkeypatch.setattr(tengine, '_host_fetch', counting)
        eng = ServingEngine(tm, ServingConfig(
            page_size=8, max_batch_size=2, prefill_chunk=8, fused_k=k),
            device='cpu')
        eng.generate(prompt, max_new_tokens=9)
        monkeypatch.setattr(tengine, '_host_fetch', real)
        st = eng.stats()
        serial_steps = st['decode_steps_total'] - st['fused_iterations_total']
        assert counts[0] == (eng.prefill_fetches + serial_steps
                             + st['fused_windows_total'])
        pools[k] = [t.clone() for t in eng.pool.kv[0]]
        if k > 1:
            assert st['fused_windows_total'] == 2
            assert counts[0] < st['prefill_chunks_total'] + 8
    N = pools[1][0].shape[0] - 1                   # the sink page index
    for serial, fused in zip(pools[1], pools[4]):
        assert torch.equal(fused[0], serial[0])    # page 0: the live row
        assert torch.equal(fused[:N], serial[:N])
        assert serial[N].any() and fused[N].any()  # padding lands there


def test_generate_batch_matches_jax_and_reuses_engine(models):
    jm, tm = models
    prompts = _mixed_prompts()
    kw = dict(page_size=8, max_batch_size=3, prefill_chunk=8)
    ref = jm.generate_batch(prompts, max_new_tokens=6, top_k=0, **kw)
    out = tm.generate_batch(prompts, max_new_tokens=6, device='cpu', **kw)
    assert out == ref
    eng = tm._serving_engines
    assert tm.generate_batch(prompts[:2], max_new_tokens=6, device='cpu',
                             **kw) == ref[:2]
    assert tm._serving_engines is eng          # cached, not rebuilt
    (old,) = eng.values()
    tm.generate_batch(prompts[:1], max_new_tokens=2, device='cpu',
                      page_size=16, max_batch_size=2)
    (new,) = tm._serving_engines.values()
    assert new is not old and old.pool.kv is None


def test_prompt_logits_is_the_prefill_step(models):
    _jm, tm = models
    eng = ServingEngine(tm, ServingConfig(page_size=8, max_batch_size=2,
                                          prefill_chunk=8), device='cpu')
    p = _mixed_prompts()[3]                    # 17 tokens: 3 chunks
    logits = eng.prompt_logits(p)
    assert logits.shape == (128,) and logits.dtype == torch.float32
    assert eng.pool.pages_in_use == 0          # scratch pages released
    out = eng.generate([p], max_new_tokens=1)
    assert out[0][-1] == int(logits.argmax())
    # chunking changes nothing: one 32-token chunk gives the same logits
    eng32 = ServingEngine(tm, ServingConfig(page_size=8, max_batch_size=2,
                                            prefill_chunk=32), device='cpu')
    torch.testing.assert_close(eng32.prompt_logits(p), logits,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('knob,value,want', [
    ('disaggregate', 1, True), ('prefill_slots', '4', 4),
    ('stream_chunk_pages', 2.0, 2)])
def test_disaggregation_knobs_validate_as_reference(knob, value, want):
    """The disaggregated engine's knobs coerce as the reference's do, and
    refuse what it refuses."""
    cfg, jcfg = ServingConfig(**{knob: value}), JConfig(**{knob: value})
    assert getattr(cfg, knob) == getattr(jcfg, knob) == want
    assert type(getattr(cfg, knob)) is type(getattr(jcfg, knob))
    if knob != 'disaggregate':
        with pytest.raises(ValueError):
            JConfig(**{knob: 'many'})
        with pytest.raises(ValueError):
            ServingConfig(**{knob: 'many'})


@pytest.mark.parametrize('knob', [
    {'tenants': {'a': {'priority': 1}, 'b': {'quota_tokens_per_s': 50.0}}},
    {'trace': True}, {'host_tier_pages': 8}, {'degrade': True},
    {'request_deadline_s': 1.0}])
def test_served_knobs_build(models, knob):
    """The knobs this port serves build an engine that runs a
    two-request stream to the end with the pool drained."""
    _jm, tm = models
    eng = ServingEngine(tm, ServingConfig(page_size=8, max_batch_size=2,
                                          prefill_chunk=8, **knob),
                        device='cpu')
    prompts = _mixed_prompts()[:2]
    out = eng.generate(prompts, max_new_tokens=4)
    assert [len(o) for o in out] == [len(p) + 4 for p in prompts]
    assert eng.pool.pages_in_use == 0
    assert eng.stats()['requests_completed_total'] == 2
    eng.shutdown()


def test_config_takes_every_reference_knob_at_its_default():
    """A config written for the reference builds in the port: every
    parameter of the JAX ServingConfig.__init__ at its default, trace
    (on by default in both) included."""
    params = inspect.signature(JConfig.__init__).parameters
    defaults = {name: p.default for name, p in params.items()
                if name != 'self'}
    assert all(d is not inspect.Parameter.empty for d in defaults.values())
    assert defaults['trace'] is True
    cfg = ServingConfig(**defaults)
    assert cfg.trace is True and ServingConfig().trace is True
    assert (cfg.page_size, cfg.max_batch_size, cfg.prefill_chunk) == (
        defaults['page_size'], defaults['max_batch_size'],
        defaults['prefill_chunk'])
    # every reference knob is kept as the reference keeps it
    jcfg = JConfig(**defaults)
    for name in defaults:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    # and the served knobs validate as the reference's do
    for knob, value in (('deadline_action', 'cancel'),
                        ('spill_watermark', 0.0), ('host_tier_pages', -1),
                        ('degrade', 'yes'), ('tenants', [('a', {})])):
        with pytest.raises(ValueError):
            ServingConfig(**{knob: value})
        with pytest.raises(ValueError):
            JConfig(**{knob: value})


def test_unserved_sampling_and_unknown_knobs_raise(models):
    with pytest.raises(TypeError, match='unknown knob'):
        ServingConfig(no_such_knob=1)


def test_config_validation_and_fused_k_env(monkeypatch):
    # tests/test_serving_fused.py:334 and test_serving.py's weight_dtype
    # check, on the port's config
    assert ServingConfig(fused_k=4).fused_k == 4
    with pytest.raises(ValueError, match='fused_k'):
        ServingConfig(fused_k=0)
    monkeypatch.setenv('PTPU_SERVE_FUSED_K', '16')
    assert ServingConfig().fused_k == 16
    assert ServingConfig(fused_k=2).fused_k == 2      # explicit wins
    with pytest.raises(ValueError, match='weight_dtype'):
        ServingConfig(weight_dtype='int4')
    with pytest.raises(ValueError, match='spec_k'):
        ServingConfig(spec_k=-1)
    assert ServingConfig().seed == 0


def test_request_validation(models):
    _jm, tm = models
    eng = ServingEngine(tm, ServingConfig(page_size=8, max_batch_size=2,
                                          max_pages_per_seq=2), device='cpu')
    with pytest.raises(ValueError, match='page table holds'):
        eng.submit(list(range(1, 15)), max_new_tokens=8)
    with pytest.raises(ValueError, match='empty prompt'):
        eng.submit([], max_new_tokens=4)
    small = ServingEngine(tm, ServingConfig(
        page_size=8, max_batch_size=2, prefill_chunk=16, num_pages=1),
        device='cpu')
    with pytest.raises(PoolExhausted, match='raise num_pages'):
        small.submit(list(range(1, 11)), max_new_tokens=0)
    assert not small.scheduler.has_work
    big = ServingEngine(tm, ServingConfig(page_size=64, max_batch_size=1,
                                          max_pages_per_seq=4),
                        device='cpu')
    with pytest.raises(ValueError, match='max_seq_len'):
        big.submit(list(range(1, 100)), max_new_tokens=40)


def test_model_on_another_device_is_refused(models):
    _jm, tm = models
    with pytest.raises(ValueError, match='model lives on'):
        ServingEngine(tm, ServingConfig(), device='meta')


def test_max_new_tokens_zero_emits_nothing(models):
    _jm, tm = models
    eng = ServingEngine(tm, ServingConfig(page_size=8, max_batch_size=2,
                                          prefill_chunk=8), device='cpu')
    assert eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=0) == \
        [[1, 2, 3], [4, 5]]
    assert eng.pool.pages_in_use == 0


def test_admission_respects_page_budget(models):
    # 3 free slots but pages for only ONE first chunk
    _jm, tm = models
    eng = ServingEngine(tm, ServingConfig(page_size=8, max_batch_size=3,
                                          prefill_chunk=8, num_pages=1),
                        device='cpu')
    for p in ([1] * 6, [2] * 6, [3] * 6):
        eng.submit(list(p), max_new_tokens=2)
    eng._admit()
    assert len(eng.scheduler.running()) == 1
    assert len(eng.scheduler.waiting) == 2


def test_admit_skips_oversized_head_and_bounds_bypass(models):
    # head-of-line fairness (engine.py:913 in the JAX package): a head
    # over this sweep's page budget keeps its place while a fitting
    # follower goes in; after HOL_BYPASS_LIMIT bypasses the sweep blocks
    # at the head
    _jm, tm = models
    eng = ServingEngine(tm, ServingConfig(
        page_size=8, max_batch_size=2, prefill_chunk=16, num_pages=3,
        prefix_cache=False), device='cpu')
    eng.pool.ensure_capacity('pin', 16)     # 1 page of budget left
    head = eng.submit(list(range(1, 18)), max_new_tokens=2)
    eng.submit([7] * 6, max_new_tokens=2)
    assert eng._admit() == 1
    assert eng.scheduler.waiting == [head]
    assert head.admit_bypasses == 1
    head.admit_bypasses = ServingEngine.HOL_BYPASS_LIMIT
    follower2 = eng.submit([8] * 6, max_new_tokens=2)
    assert eng._admit() == 0
    assert follower2.state == RequestState.WAITING
    eng.pool.release('pin')
    assert eng._admit() == 1
    assert head.state == RequestState.PREFILL
    assert eng.scheduler.waiting == [follower2]
    while eng.scheduler.has_work:
        eng.step()
    assert eng.pool.pages_in_use == 0


def test_stats_and_reset(models):
    _jm, tm = models
    eng = ServingEngine(tm, ServingConfig(page_size=8, max_batch_size=3,
                                          prefill_chunk=8), device='cpu')
    eng.generate(_mixed_prompts(), max_new_tokens=4)
    st = eng.stats()
    assert st['device'] == 'cpu'
    assert st['decode_tokens_per_sec'] > 0 and 0 < st['batch_occupancy'] <= 1
    assert st['ttft_ms_p50'] <= st['ttft_ms_p99']
    assert st['requests_completed_total'] == 5
    eng.reset_stats()
    st = eng.stats()
    assert st['decode_steps_total'] == 0 and st['ttft_ms_p50'] is None


def test_chain_hash_matches_jax():
    toks = list(range(40, 77))
    assert chain_hash(-1, toks[:8]) == jkv_pool.chain_hash(-1, toks[:8])
    assert chain_hashes(toks, 8, limit=30) == \
        jkv_pool.chain_hashes(toks, 8, limit=30)


# ---------------------------------------------------------------------------
# page allocator invariants (tests/test_serving.py TestPageAllocator and
# TestPrefixCacheAllocator, on the port's pool)
# ---------------------------------------------------------------------------
def _partition_ok(pool):
    """free + cached + mapped partitions the pool at all times."""
    return (len(pool._free) + len(pool._cached) + len(pool._ref)
            == pool.num_pages)


def _alloc_free_reuse_and_occupancy():
    pool = KVPagePool(num_pages=8, page_size=4)
    assert pool.pages_for(1) == 1 and pool.pages_for(4) == 1
    assert pool.pages_for(5) == 2 and pool.pages_for(0) == 1
    pool.ensure_capacity('a', 9)
    pool.ensure_capacity('b', 4)
    assert pool.pages_in_use == 4 and pool.free_pages == 4
    assert pool.utilization() == 0.5
    assert len(pool.page_table('a')) == 3
    pool.ensure_capacity('a', 10)
    assert len(pool.page_table('a')) == 3
    pool.ensure_capacity('a', 13)
    assert len(pool.page_table('a')) == 4
    assert pool.release('a') == 4
    assert pool.pages_in_use == 1 and pool.free_pages == 7
    assert pool.release('a') == 0
    pool.ensure_capacity('c', 8 * 4 - 4)
    assert pool.free_pages == 0
    st = pool.stats()
    assert st['high_water'] == 8 and st['pages_in_use'] == 8
    assert st['alloc_total'] == 4 + 1 + 7 and st['free_total'] == 4


def _no_double_mapping():
    pool = KVPagePool(num_pages=6, page_size=2)
    pool.ensure_capacity('a', 6)
    pool.ensure_capacity('b', 6)
    pages_a, pages_b = set(pool.page_table('a')), set(pool.page_table('b'))
    assert not pages_a & pages_b
    assert pages_a | pages_b == set(range(6))
    assert pool.pages_in_use + pool.free_pages == pool.num_pages


def _exhaustion_raises_and_partial_growth_kept():
    pool = KVPagePool(num_pages=3, page_size=4)
    pool.ensure_capacity('a', 8)
    with pytest.raises(PoolExhausted):
        pool.ensure_capacity('b', 12)
    assert pool.pages_in_use == 3
    pool.release('a')
    pool.ensure_capacity('b', 12)
    assert len(pool.page_table('b')) == 3


def _refcount_share_and_exact_once_release():
    pool = KVPagePool(num_pages=8, page_size=4, prefix_cache=True)
    toks = list(range(100, 112))
    pool.ensure_capacity('a', 12)
    pool.register_prefix('a', toks, written=12)
    assert pool.match_and_map('b', toks + [7, 8]) == 12
    assert pool.page_table('b') == pool.page_table('a')
    assert pool.shared_pages == 3 and pool.pages_in_use == 3
    assert _partition_ok(pool)
    assert pool.release('a') == 0
    assert pool.shared_pages == 0 and pool.pages_in_use == 3
    assert pool.release('b') == 3
    assert pool.pages_in_use == 0 and pool.cached_pages == 3
    assert pool.free_pages == 8 and _partition_ok(pool)
    assert pool.release('a') == 0 and pool.release('b') == 0
    assert pool.match_and_map('c', toks) == 12
    assert pool.cached_pages == 0 and pool.pages_in_use == 3
    assert pool.prefix_hits == 2 and pool.prefix_hit_tokens == 24


def _fork_on_divergence_shares_only_common_blocks():
    pool = KVPagePool(num_pages=16, page_size=4, prefix_cache=True)
    common = [1, 2, 3, 4, 5, 6, 7, 8]
    pool.ensure_capacity('a', 12)
    pool.register_prefix('a', common + [9, 10, 11, 12], written=12)
    b_toks = common + [99, 98, 97, 96]
    assert pool.match_and_map('b', b_toks) == 8
    pool.ensure_capacity('b', 12)
    ta, tb = pool.page_table('a'), pool.page_table('b')
    assert tb[:2] == ta[:2] and tb[2] != ta[2]
    assert pool.shared_pages == 2
    pool.register_prefix('b', b_toks, written=12)
    assert pool._match_pages(b_toks) == tb[:3]
    assert pool._match_pages(common + [9, 10, 11, 12]) == ta[:3]


def _match_is_capped_and_block_granular():
    pool = KVPagePool(num_pages=8, page_size=4, prefix_cache=True)
    toks = list(range(50, 58))
    pool.ensure_capacity('a', 8)
    pool.register_prefix('a', toks, written=8)
    assert pool.peek_prefix(toks, limit=7) == (4, 1, 0, 0)
    assert pool.match_and_map('b', toks, limit=7) == 4
    assert pool.peek_prefix(toks[:6]) == (4, 1, 0, 0)
    off = KVPagePool(num_pages=4, page_size=4)
    off.ensure_capacity('x', 4)
    off.register_prefix('x', [1, 2, 3, 4], written=4)
    assert off.peek_prefix([1, 2, 3, 4]) == (0, 0, 0, 0)
    assert off.match_and_map('y', [1, 2, 3, 4]) == 0
    assert off.prefix_misses == 0


def _eviction_reclaims_cached_subtree_lru():
    pool = KVPagePool(num_pages=4, page_size=4, prefix_cache=True)
    chain = list(range(10, 22))
    pool.ensure_capacity('a', 12)
    pool.register_prefix('a', chain, written=12)
    pool.release('a')
    assert pool.cached_pages == 3 and pool.free_pages == 4
    pool.ensure_capacity('b', 8)
    assert pool.pages_in_use == 2 and pool.prefix_evictions == 3
    assert pool._match_pages(chain) == [] and _partition_ok(pool)
    pool.ensure_capacity('b', 16)
    assert pool.free_pages == 0
    with pytest.raises(PoolExhausted):
        pool.ensure_capacity('c', 4)


def _match_after_partial_allocation_is_noop():
    pool = KVPagePool(num_pages=8, page_size=4, prefix_cache=True)
    toks = list(range(40, 48))
    pool.ensure_capacity('a', 8)
    pool.register_prefix('a', toks, written=8)
    pool.ensure_capacity('b', 4)
    assert pool.match_and_map('b', toks) == 0
    assert len(pool.page_table('b')) == 1


def _deep_chain_eviction_is_iterative():
    n = 1200
    pool = KVPagePool(num_pages=n, page_size=1, prefix_cache=True)
    toks = list(range(n))
    pool.ensure_capacity('a', n)
    pool.register_prefix('a', toks, written=n)
    pool.release('a')
    assert pool.cached_pages == n
    pool.ensure_capacity('b', 2)
    assert pool.prefix_evictions == n
    assert pool._match_pages(toks) == [] and _partition_ok(pool)


def _trim_returns_private_tail_only():
    pool = KVPagePool(num_pages=8, page_size=4, prefix_cache=True)
    toks = list(range(60, 68))
    pool.ensure_capacity('a', 16)
    pool.register_prefix('a', toks, written=8)
    assert pool.trim('a', 9) == 1
    assert len(pool.page_table('a')) == 3
    pool2 = KVPagePool(num_pages=8, page_size=4, prefix_cache=True)
    pool2.ensure_capacity('x', 8)
    pool2.register_prefix('x', toks, written=8)
    pool2.match_and_map('y', toks, limit=None)
    assert pool2.trim('y', 1) == 0
    assert len(pool2.page_table('y')) == 2


def _materialize_layers_on_device():
    # each tensor holds the 5 pages the allocator hands out and the sink
    pool = KVPagePool(num_pages=5, page_size=4, num_layers=3, num_heads=2,
                      head_dim=8, dtype='bfloat16')
    kv = pool.materialize('cpu')
    assert len(kv) == 3 and pool.materialize('cpu') is kv
    assert all(k.shape == (6, 4, 16) and k.dtype == torch.bfloat16
               and not k.any() for pair in kv for k in pair)
    assert not pool.quantized
    assert pool.bytes_per_token() == 2 * 16 * 2 * 3
    assert pool.pool_bytes() == 5 * 4 * pool.bytes_per_token()
    pool.drop_arrays()
    assert pool.kv is None
    q = KVPagePool(num_pages=5, page_size=4, num_layers=3, num_heads=2,
                   head_dim=8, dtype='int8')
    kv = q.materialize('cpu')
    assert q.quantized and q.stats()['kv_dtype'] == 'int8'
    assert all(len(layer) == 4 for layer in kv)
    assert [(t.shape, t.dtype) for t in kv[0]] == [
        ((6, 4, 16), torch.int8), ((6, 4, 16), torch.int8),
        ((6, 4, 2), torch.float32), ((6, 4, 2), torch.float32)]


def _int8_bytes_exact():
    # tests/test_serving.py:913-935: int8 pages plus fp32 per-(slot,
    # head) scales, exactly; at least half the fp32 pool's bytes
    kw = dict(num_pages=6, page_size=8, num_layers=2, num_heads=2,
              head_dim=32)
    dense = KVPagePool(dtype='float32', **kw)
    quant = KVPagePool(dtype='int8', **kw)
    per_tok = 2 * (2 * 32 + 2 * 4) * 2
    assert quant.bytes_per_token() == per_tok
    assert quant.pool_bytes() == 6 * 8 * per_tok
    assert dense.bytes_per_token() / quant.bytes_per_token() >= 2.0
    assert jkv_pool.KVPagePool(dtype='int8', **kw).bytes_per_token() \
        == per_tok


def _try_reserve_all_or_nothing():
    # tests/test_serving_fused.py:322
    pool = KVPagePool(num_pages=3, page_size=4)
    pool.ensure_capacity('a', 4)
    assert pool.try_reserve('a', 12)
    assert pool.pages_in_use == 3
    assert not pool.try_reserve('b', 12)
    assert pool.pages_in_use == 3 and pool.free_pages == 0
    assert _partition_ok(pool)
    pool.release('a')
    assert pool.try_reserve('b', 12)
    assert pool.pages_in_use == 3


ALLOCATOR_CASES = [
    _alloc_free_reuse_and_occupancy, _no_double_mapping,
    _exhaustion_raises_and_partial_growth_kept,
    _refcount_share_and_exact_once_release,
    _fork_on_divergence_shares_only_common_blocks,
    _match_is_capped_and_block_granular,
    _eviction_reclaims_cached_subtree_lru,
    _match_after_partial_allocation_is_noop,
    _deep_chain_eviction_is_iterative, _trim_returns_private_tail_only,
    _materialize_layers_on_device, _int8_bytes_exact,
    _try_reserve_all_or_nothing,
]


@pytest.mark.parametrize('case', ALLOCATOR_CASES,
                         ids=[c.__name__.strip('_') for c in ALLOCATOR_CASES])
def test_page_allocator_invariants(case):
    case()


# ---------------------------------------------------------------------------
# int8 weights, the n-gram proposer, quiescence
# ---------------------------------------------------------------------------
def test_int8_weights_quantized_like_jax(models):
    # the engine's codes and scales are the JAX package's
    # quantize_to_int8 on the same weights, bit for bit; the embeddings
    # (and so the tied LM head) stay full precision
    jm, tm = models
    eng = ServingEngine(tm, ServingConfig(page_size=8, max_batch_size=2,
                                          weight_dtype='int8'), device='cpu')
    st = eng.stats()
    assert st['weight_dtype'] == 'int8'
    assert st['quantized_params'] == 4 * TINY['num_layers']
    jparams = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    for name, (_mod, _attr, q, s) in eng._qweights.items():
        assert 'embed' not in name and q.dtype == torch.int8
        jq, js = jquantize_to_int8(jparams[name], quant_axis=1)
        np.testing.assert_array_equal(q.numpy(), jq)
        np.testing.assert_array_equal(s.numpy(), js)
    rng = np.random.RandomState(12)
    a = (rng.randn(33, 40) * rng.rand(33, 40) * 3).astype(np.float32)
    for axis in (None, 0):
        q, s = quantize_to_int8(torch.from_numpy(a), quant_axis=axis)
        jq, js = jquantize_to_int8(a, quant_axis=axis)
        np.testing.assert_array_equal(q.numpy(), jq)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js, np.float32))
    # the parameters are the model's own again after every dispatch
    before = {n: p for n, p in tm.named_parameters()}
    eng.generate([[3, 4, 5]], max_new_tokens=2)
    assert all(p is before[n] for n, p in tm.named_parameters())


def test_ngram_proposer_matches_jax():
    # tests/test_serving.py:672's cases, on both packages' proposers
    t = [1, 2, 3, 4, 5, 6, 3, 4]
    cases = [((t, 2, 3), [5, 6, 3]), (([1, 2, 5, 6], 2, 3), []),
             (([7, 1, 2, 7, 3, 7], 2, 2), [3, 7]), (([9, 9, 9], 2, 4), [9]),
             (([5], 2, 4), []), ((t, 2, 0), [])]
    for args, want in cases:
        assert tengine._ngram_propose(*args) == want
        assert jengine._ngram_propose(*args) == want
    rng = np.random.RandomState(4)
    for _ in range(200):
        toks = list(rng.randint(0, 4, rng.randint(1, 20)))
        n, k = int(rng.randint(1, 4)), int(rng.randint(0, 5))
        assert tengine._ngram_propose(toks, n, k) == \
            jengine._ngram_propose(toks, n, k)


def test_scheduler_quiescent_predicate():
    # tests/test_serving_fused.py:285
    def req(state):
        r = Request([1, 2], max_new_tokens=4)
        r.state = state
        return r
    s = Scheduler(num_slots=2)
    assert not s.quiescent()                    # empty: nothing to fuse
    s.slots[0] = req(RequestState.RUNNING)
    assert s.quiescent()
    s.slots[1] = req(RequestState.PREFILL)
    assert not s.quiescent()                    # prefill due mid-window
    s.slots[1] = req(RequestState.RUNNING)
    assert s.quiescent()
    s.waiting.append(req(RequestState.WAITING))
    assert not s.quiescent()                    # admission due


# ---------------------------------------------------------------------------
# sampling, held within the port
# ---------------------------------------------------------------------------
def _sampled(models, prompts=None, max_new=10, top_k=5, temperature=0.8,
             **knobs):
    _jm, tm = models
    cfg = dict(dict(page_size=8, max_batch_size=4, prefill_chunk=8,
                    seed=11), **knobs)
    eng = ServingEngine(tm, ServingConfig(**cfg), device='cpu')
    out = eng.generate(prompts or _fused_prompts(), max_new_tokens=max_new,
                       top_k=top_k, temperature=temperature)
    st = eng.stats()
    assert eng.pool.pages_in_use == 0
    return out, st, eng


def test_sampling_is_a_function_of_seed_ordinal_and_position(models):
    ref, _st, _e = _sampled(models)
    again, _st, _e = _sampled(models)
    assert again == ref                                 # same seed
    fused, st8, _e = _sampled(models, fused_k=8)
    assert fused == ref and st8['fused_windows_total'] > 0
    squeezed, stp, _e = _sampled(models, max_new=6, max_batch_size=3,
                                 num_pages=4)
    plain6, _st, _e = _sampled(models, max_new=6)
    assert stp['preemptions_total'] > 0 and squeezed == plain6
    spec, sts, _e = _sampled(models, spec_k=4)          # greedy-only spec:
    assert spec == ref and sts['spec_proposed_tokens_total'] == 0
    other, _st, _e = _sampled(models, seed=12)
    assert other != ref                                 # another stream
    greedy, _st, _e = _sampled(models, top_k=0)
    assert ref != greedy
    top1, _st, _e = _sampled(models, top_k=1)
    assert top1 == greedy


def test_sampled_tokens_lie_in_the_top_k_set(models):
    # every drawn token is among its row's k largest logits (ties with
    # the k-th included), recomputed by the engine's own prefill
    out, _st, eng = _sampled(models, top_k=3, temperature=1.5,
                             max_new=8)
    hits = 0
    for o, p in zip(out, _fused_prompts()):
        for j in range(len(p), len(o)):
            logits = eng.prompt_logits(o[:j])
            kth = torch.sort(logits, descending=True).values[2]
            assert logits[o[j]] >= kth
            hits += int(o[j] != int(logits.argmax()))
    assert hits > 0                     # not greedy in disguise


def _tie_logits():
    rng = np.random.RandomState(13)
    logits = rng.randn(6, 40).astype(np.float32) * 3
    logits[1, [4, 9, 17]] = logits[1].max() + 1.0   # a three-way tie on top
    top = np.sort(logits[2])[::-1]
    logits[2, np.argsort(logits[2])[:2]] = top[3]   # ties at the 4th value
    return logits


def test_device_sample_mask_is_the_jax_function_s(monkeypatch):
    # the kth threshold and the masked set of the JAX _device_sample,
    # captured from its own call of jax.random.categorical, equal the
    # port's on the same logits; only the draw differs
    logits = _tie_logits()
    temps = np.asarray([1.0, 0.7, 1.3, 0.0, 2.0, 1e-9], np.float32)
    top_ks = np.asarray([5, 2, 4, 1, 40, 3], np.int32)
    seen = []
    real_vmap = jax.vmap

    def spy_vmap(f, *a, **kw):
        if f is jax.random.categorical:
            def run(keys, masked):
                seen.append(np.asarray(masked))
                return real_vmap(f, *a, **kw)(keys, masked)
            return run
        return real_vmap(f, *a, **kw)
    monkeypatch.setattr(jax, 'vmap', spy_vmap)
    jengine._device_sample(jnp.asarray(logits), jax.random.key(0),
                           jnp.arange(6, dtype=jnp.int32),
                           jnp.arange(6, dtype=jnp.int32) + 7,
                           jnp.asarray(temps), jnp.asarray(top_ks))
    monkeypatch.setattr(jax, 'vmap', real_vmap)
    (jmasked,) = seen
    kth, masked = tengine.top_k_mask(torch.from_numpy(logits),
                                     torch.from_numpy(temps),
                                     torch.from_numpy(top_ks).long())
    np.testing.assert_array_equal(masked.numpy(), jmasked)
    kept = jmasked > -1e30
    np.testing.assert_array_equal(
        kth[:, 0].numpy(), np.where(kept, jmasked, np.inf).min(-1))
    assert kept[1].sum() == 3 and kept[2].sum() == 6   # ties stay in


def test_device_sample_draws_within_the_mask_and_by_the_softmax():
    logits = torch.from_numpy(_tie_logits())
    B, V = logits.shape
    temps = torch.full((B,), 0.9)
    top_ks = torch.tensor([5, 2, 4, 1, 40, 3])
    _kth, masked = tengine.top_k_mask(logits, temps, top_ks)
    draws = []
    for pos in range(400):
        draws.append(tengine._device_sample(
            logits, 5, torch.arange(B), torch.full((B,), pos), temps,
            top_ks))
    draws = torch.stack(draws)                               # [400, B]
    kept = masked > -1e30
    assert bool(kept.gather(1, draws.t()).all())
    assert set(draws[:, 1].tolist()) == {4, 9, 17}          # every tie drawn
    assert bool((draws[:, 3] == logits[3].argmax()).all())   # top_k 1
    # the draw follows the masked softmax: row 4 (k = V) against its
    # probabilities, within 5 standard errors a token
    p = torch.softmax(masked[4], -1)
    freq = torch.bincount(draws[:, 4], minlength=V).float() / 400
    assert bool(((freq - p).abs() <= 5 * (p * (1 - p) / 400).sqrt()
                 + 1e-3).all())
    greedy = tengine._device_sample(logits, 5, torch.arange(B),
                                    torch.zeros(B, dtype=torch.long),
                                    temps, torch.zeros(B, dtype=torch.long))
    assert torch.equal(greedy, logits.argmax(-1))


def test_sample_uniforms_are_pure_and_open():
    ords = torch.tensor([0, 0, 1, 7])
    pos = torch.tensor([5, 6, 5, 5])
    u = tengine.sample_uniforms(3, ords, pos, 1000)
    assert u.dtype == torch.float32 and u.shape == (4, 1000)
    assert bool(((u > 0) & (u < 1)).all())
    assert torch.equal(u, tengine.sample_uniforms(3, ords, pos, 1000))
    assert torch.equal(u[1:2], tengine.sample_uniforms(
        3, ords[1:2], pos[1:2], 1000))                    # batch-free
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert not torch.equal(u, tengine.sample_uniforms(4, ords, pos, 1000))
    assert abs(float(u.mean()) - 0.5) < 0.02
