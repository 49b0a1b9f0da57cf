"""Helpers for the port's serving parity tests
(tests/test_torch_serving_{tenants,trace,kvtier,ledger,disagg}.py): one
call sequence through the JAX package's ServingEngine (or, with
disaggregate=True, its DisaggregatedEngine) and the port's on bridged
weights, each engine under its own deterministic clock, and the
comparison of everything the two decided — tokens, stats counters,
ladder transitions, per-tenant rows, per-request trace event sequences,
the timeline and the goodput account. Not a test module itself."""
import numpy as np

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.cluster import DisaggregatedEngine as JDisagg
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.cluster import DisaggregatedEngine

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=128, hidden_dropout=0.0, attn_dropout=0.0,
            use_flash_attention=False)

# stats() counters both engines keep, compared exactly
STAT_KEYS = (
    'requests_submitted_total', 'requests_completed_total',
    'requests_aborted_total', 'preemptions_total', 'decode_steps_total',
    'decode_tokens_total', 'prefill_tokens_total', 'prefill_chunks_total',
    'batch_occupancy', 'kv_page_utilization', 'in_flight', 'waiting',
    'prefix_hits_total', 'prefix_misses_total', 'prefix_hit_tokens_total',
    'prefix_shared_pages', 'prefix_cached_pages', 'prefix_evictions_total',
    'spec_proposed_tokens_total', 'spec_accepted_tokens_total',
    'spec_steps_total', 'fused_windows_total', 'fused_iterations_total',
    'fused_tokens_total', 'quota_deferrals_total',
    'preemptions_charged_total', 'deadline_rejects_total',
    'deadline_misses_total', 'degrade_stage', 'tenancy')
POOL_KEYS = ('num_pages', 'bytes_per_token', 'pool_bytes', 'pages_in_use',
             'free_pages', 'high_water', 'alloc_total', 'free_total',
             'sequences', 'cached_pages', 'shared_pages',
             'prefix_evictions_total', 'weighted_eviction')
# trace fields that are times (the clocks agree, but a field read off a
# clock is not a decision)
TIME_FIELDS = ('t', 'retry_after_s', 'e2e_s')


class FakeClock:
    """Deterministic monotonic clock: every read advances `tick`, and
    tests jump it explicitly (bucket refills, deadline aging)."""

    def __init__(self, tick=0.0):
        self.now = 0.0
        self.tick = tick

    def __call__(self):
        self.now += self.tick
        return self.now


def model_pair(seed=11, **over):
    """(JAX model, port model) with the JAX model's weights bridged into
    the port's (models/convert.py:load_jax_params)."""
    cfg = dict(TINY, **over)
    paddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
    load_jax_params(tm, {n: np.asarray(p.data)
                         for n, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def has_work(eng):
    """A ServingEngine's or a DisaggregatedEngine's pending work."""
    if hasattr(eng, 'decode'):
        return eng.has_work
    return eng.scheduler.has_work


def engines(eng):
    """The ServingEngines behind an engine: (prefill, decode) for a
    disaggregated one."""
    return (eng.prefill, eng.decode) if hasattr(eng, 'decode') else (eng,)


class Twin:
    """The reference engine (`ref`) and the port's (`port`), built from
    the same config, driven by the same calls.

    `settle_spills`: after every step, wait until both engines' host-tier
    spills have landed. An engine submits its async spills at the end of
    a step, and the device pages a spill pins count as in use until it
    lands, so without this a loaded machine's transfer threads decide
    when pages come free, and the two engines' admissions drift apart."""

    def __init__(self, pair, tick=0.0, settle_spills=False, **cfg):
        jm, tm = pair
        self.settle_spills = settle_spills
        self.clocks = (FakeClock(tick), FakeClock(tick))
        if cfg.get('disaggregate'):
            self.ref = JDisagg(jm, JConfig(clock=self.clocks[0], **cfg))
            self.port = DisaggregatedEngine(
                tm, ServingConfig(clock=self.clocks[1], **cfg),
                device='cpu')
        else:
            self.ref = JEngine(jm, JConfig(clock=self.clocks[0], **cfg))
            self.port = ServingEngine(
                tm, ServingConfig(clock=self.clocks[1], **cfg),
                device='cpu')
        self.reqs = []                  # [(ref request, port request)]

    def submit(self, prompt, **kw):
        """Submit to both engines. A rejection must come from both, with
        the same exception type and reason; it is re-raised (the port's).
        Returns the port's request."""
        kw.setdefault('top_k', 0)
        out = []
        for eng in (self.ref, self.port):
            try:
                out.append(eng.submit(prompt, **kw))
            except Exception as e:      # compared below, then re-raised
                out.append(e)
        ref, port = out
        if isinstance(ref, Exception) or isinstance(port, Exception):
            assert type(ref).__name__ == type(port).__name__, (ref, port)
            assert getattr(ref, 'reason', None) == \
                getattr(port, 'reason', None)
            raise port
        self.reqs.append((ref, port))
        return port

    def step(self, n=1):
        for _ in range(n):
            self.ref.step()
            self.port.step()
            if self.settle_spills:
                for eng in (self.ref, self.port):
                    if eng.pool.host_tier is not None:
                        eng.pool.host_tier.drain()
            assert has_work(self.ref) == has_work(self.port)

    def jump(self, dt):
        for c in self.clocks:
            c.now += dt

    def drain(self, cap=3000):
        steps = 0
        while has_work(self.ref):
            self.step()
            steps += 1
            assert steps < cap, 'engines did not drain'
        return steps

    def generate(self, prompts, **kw):
        for p in prompts:
            self.submit(p, **kw)
        self.drain()
        return [p.output_ids() for _r, p in self.reqs[-len(prompts):]]

    # -- comparison ----------------------------------------------------------
    def _journal(self, eng, which):
        """{request index or -1: [(event, fields without times)]} with
        request ids (`req`, `for_req`) replaced by submission index."""
        index = {r[which].id: i for i, r in enumerate(self.reqs)}
        out = {}
        for e in eng.tracer.events():
            key = index.get(e['req'], e['req'])
            fields = {k: (index.get(v, v) if k == 'for_req' else v)
                      for k, v in e.items()
                      if k not in TIME_FIELDS + ('req', 'event')}
            out.setdefault(key, []).append((e['event'], fields))
        return out

    def check(self):
        """Everything both engines decided is equal."""
        ref, port = self.ref, self.port
        for r, p in self.reqs:
            assert p.output_ids() == r.output_ids(), (r.id, p.id)
            assert (p.state, p.preemptions, p.quota_defers,
                    p.quota_charged) == (r.state, r.preemptions,
                                         r.quota_defers, r.quota_charged)
        rs, ps = ref.stats(), port.stats()
        for k in STAT_KEYS:
            assert ps[k] == rs[k], (k, ps[k], rs[k])
        for k in POOL_KEYS:
            assert ps['pool'][k] == rs['pool'][k], (k, ps['pool'][k],
                                                     rs['pool'][k])
        assert [(h['from'], h['to'], h['pressure'])
                for h in engines(port)[-1].ladder_history()] == \
            [(h['from'], h['to'], h['pressure'])
             for h in engines(ref)[-1].ladder_history()]
        if ref.tracer is not None:
            assert self._journal(port, 1) == self._journal(ref, 0)
        strip = ('t',)
        assert [{k: v for k, v in e.items() if k not in strip}
                for e in port.timeline.snapshot()] == \
            [{k: v for k, v in e.items() if k not in strip}
             for e in ref.timeline.snapshot()]
        for r, p in zip(engines(ref), engines(port)):
            rg, pg = r.ledger.goodput(), p.ledger.goodput()
            assert pg == rg, (pg, rg)

    def shutdown(self):
        self.ref.shutdown()
        self.port.shutdown()
