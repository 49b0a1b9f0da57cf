"""Serving engine: continuous batching over the paged KV pool —
counterpart of `paddle_tpu/serving/engine.py`.

Four step shapes serve every request mix, as in the JAX engine:

  * chunked prefill — B=1, T=prefill_chunk: one prompt chunk streams
    through the model, its K/V landing in the sequence's pool pages;
  * batched decode  — B=max_batch_size, T=1: every RUNNING request
    advances one token in one dispatch;
  * batched verify  — B=max_batch_size, T=spec_k+1 (speculative
    decoding, spec_k > 0): each greedy request carries the draft tokens
    an n-gram proposer found in its own history as extra ragged query
    rows; the argmax at every position comes back in the one fetch, the
    longest agreeing draft prefix is accepted plus the next token, and
    pages grown for rejected drafts are trimmed back. Greedy output is
    the one-token path's;
  * fused decode    — fused_k > 1: K iterations of the [B, 1] step with
    the carry (last token, seq_len, done mask, emitted count) on the
    card, eos and budget checked there, and ONE fetch of the sampled ids
    for the window. Taken when the scheduler is quiescent, the ladder
    has no transition due within the window, no drafts ride this step
    and every row's window of pages can be reserved; otherwise the
    [B, 1] step runs. Tokens equal serial decode's.

Every step runs `GPTModel.forward_paged` (ragged paged attention + the
in-place K/V scatter) eagerly under `torch.inference_mode()` with the
model in eval mode, picks the next token ON DEVICE from fp32 logits
(the LM-head product upcasts the tied weight once a dispatch, as the
JAX product's `preferred_element_type`), and fetches only the chosen ids
through `_host_fetch` — one host round-trip per prefill that completes
and samples (its last chunk; earlier chunks stay queued on the card),
per serial decode step and per fused window. Idle decode slots ride along with q_len=0:
their K/V writes land in the pool's sink page and their outputs are
ignored.

Sampling (`top_k > 0`): the logits are divided by max(temperature,
1e-6), every logit below the k-th largest (after a full sort, so ties
with it stay in) is masked to -1e30, and the token is the argmax of the
masked logits plus Gumbel noise, which is how `jax.random.categorical`
samples. The noise of (row, vocab index) is a counter-based hash in
integer torch ops of (seed, the request's engine-local ordinal, the
absolute position of the token drawn, the vocab index), turned into a
uniform on (0, 1): the same bits on the CPU and on the card, whatever
the batch or the dispatch. So fused, serial, verify and preempt/resume
runs draw identical tokens. JAX folds a threefry key with the same
inputs; the two packages' sampled tokens differ, their greedy tokens do
not. `top_k <= 0` is greedy, temperature ignored.

`kv_dtype='int8'`: the pool stores int8 K/V and one fp32 abs-max scale
per (slot, head); rows are quantized as they are written and the paged
attention kernel dequantizes inside (`paged_attention_int8`).
`weight_dtype='int8'`: every 2-D floating weight whose name lacks
`embed` (the four matmul weights of each layer; the tied LM head stays
full precision) is kept as int8 codes with per-out-channel fp32 scales
(`quantization.quantize_to_int8`), and each is dequantized to the
model's dtype just before its module runs and dropped after it, inside
the engine's forward. The model's own full-precision weights stay where
they are, as in the JAX engine.

Prefix caching rides in the pool (kv_pool.py): prompts sharing a prefix
map the same physical pages and skip the prefill compute for them. With
`host_tier_pages` the pool spills cached subtrees to pinned host memory
under pressure (proactively past `spill_watermark`, or inline when an
allocation finds no free page) and a later prefix match fetches them
back instead of re-running their prefill (host_tier.py).

Tenancy (`tenants`): priority-then-FCFS admission, token-bucket quotas
debited at first admit (over-quota requests defer, never drop),
deadline-aware admission at submit (`AdmissionRejected`), preemption of
the youngest request of the lowest class below the one that needs
room, charged to its tenant's bucket, and a request that only outranked
peers hold yields. The degradation ladder (`degrade`, on by default when
tenants are declared) sheds fused windows and speculative decoding at
stage 1, halves the prefill chunk at stage 2 and arms the pool's
weighted eviction at stage 3. With no tenants, scheduling is the
untenanted engine's, decision for decision.

Observability: per-request lifecycle journals and the scheduler
timeline (request_trace.py, `trace`, on by default), the stalled-request
watchdog (`request_deadline_s`, a serve_report artifact, `abort` on
request), the serving ledger (ledger.py: wall decomposition, goodput,
roofline) over a `HostGapMonitor` whose gating wait is the time spent in
`_host_fetch`, the ptpu_serve_* metrics (metrics.py, published on retire,
on drain and every PUBLISH_INTERVAL_S), and `serve::*` `RecordEvent`
ranges that show in a torch profile. None of it adds a host sync.
Scheduling follows the JAX engine decision for decision, so the two
engines emit identical greedy tokens, stats, ladder transitions and
trace events on the same weights under the same clock.

The engine runs on `device`: the card unless the caller passes
device='cpu'; without a card and without device='cpu' it raises.

Prefill/decode disaggregation (`disaggregate`, `prefill_slots`,
`stream_chunk_pages`) is served by `serving.cluster.DisaggregatedEngine`
over two of these engines; the hooks it calls are `adopt_request`,
`deadline_admission`, `_stage3_pools` and the `ledger_site` argument.
Not ported yet: the mp-sharded route (ROADMAP Queue 1 item 7).
"""
import contextlib
import math
import os
import time

import numpy as np
import torch

from ..core import monitor as _monitor
from ..core.async_step import HostGapMonitor, unregister_monitor
from ..device import resolve_device
from ..profiler import RecordEvent
from ..quantization import dequantize_weight, quantize_to_int8
from . import metrics as _metrics
from .kv_pool import KVPagePool, PoolExhausted
from .ledger import ServeLedger
from .request_trace import (ENGINE_REQ, RequestTracer, build_serve_report,
                            write_serve_report)
from .scheduler import (AdmissionRejected, DegradeLadder, Request,
                        RequestState, Scheduler, SchedulerTimeline,
                        TenantTable)

def _host_fetch(x):
    """Every fetch of chosen token ids from the device funnels through
    here, so tests can count the engine's host syncs (engine.py:69 in
    the JAX package). Tracing and the ledger add no call here."""
    return x.cpu().numpy()


class ServingConfig:
    """Knobs (docs/serving.md#tuning in the JAX package):

    page_size          tokens per KV page
    max_batch_size     decode slots = max concurrent requests
    num_pages          pool capacity; default fits every slot at
                       max_pages_per_seq (no preemption pressure)
    max_pages_per_seq  page-table width; default covers max_seq_len
    prefill_chunk      prompt tokens per prefill dispatch
    kv_dtype           pool dtype (default: the model's parameter
                       dtype); 'int8' stores int8 pages with one fp32
                       abs-max scale per (slot, head)
    weight_dtype       None or 'int8': weight-only int8 matmul weights,
                       dequantized at use
    prefix_cache       copy-on-write prefix sharing over the pool
    spec_k             speculative draft length (0 = off)
    spec_ngram         the proposer's trailing n-gram length
    fused_k            decode iterations fused into one window with one
                       host fetch (default $PTPU_SERVE_FUSED_K, else 1
                       = off); ladder stage 1+ sheds it
    seed               the sampling draw's seed
    trace              per-request lifecycle journals (default on)
    trace_events_per_request / trace_requests   journal caps
    timeline_capacity  scheduler-timeline ring size (iterations)
    request_deadline_s stalled-request watchdog deadline (None = off): a
                       request older than this produces a serve_report
    deadline_action    'report' (default) or 'abort' (also drop it)
    report_dir         serve_report directory (default
                       $PTPU_SERVE_REPORT_DIR, then $FLEET_LOG_DIR)
    clock              the clock for ALL request timing (tests inject a
                       deterministic one)
    disaggregate       prefill/decode disaggregation: build through
                       serving.cluster.build_engine, which returns a
                       DisaggregatedEngine (a plain ServingEngine refuses
                       the flag)
    prefill_slots      the prefill engine's slot count
    stream_chunk_pages pages per KV-page stream copy (0 = one copy)
    tenants            {tenant_id: {priority, quota_tokens_per_s,
                       burst_tokens, weight}} or None
    degrade            the ladder: None = on exactly when tenants are
                       set, or an explicit bool
    degrade_window / degrade_up / degrade_down / degrade_hold
                       the ladder's window, stage thresholds and dwell
    host_tier_pages    host-RAM tier capacity in pages (0 = no tier)
    spill_watermark    pool utilization that starts proactive spills
    spill_chunk_pages  pages per transfer chunk (0 = one chunk)
    spill_window       spill jobs in flight at most
    """

    def __init__(self, page_size=16, max_batch_size=4, num_pages=None,
                 max_pages_per_seq=None, prefill_chunk=32, kv_dtype=None,
                 weight_dtype=None, prefix_cache=True, spec_k=0,
                 spec_ngram=2, fused_k=None, seed=0, trace=True,
                 trace_events_per_request=512, trace_requests=512,
                 timeline_capacity=2048, request_deadline_s=None,
                 deadline_action='report', report_dir=None, clock=None,
                 disaggregate=False, prefill_slots=2, stream_chunk_pages=0,
                 tenants=None, degrade=None, degrade_window=8,
                 degrade_up=(0.85, 0.92, 0.97),
                 degrade_down=(0.60, 0.70, 0.80), degrade_hold=4,
                 host_tier_pages=0, spill_watermark=0.92,
                 spill_chunk_pages=0, spill_window=2, **unknown):
        if unknown:
            raise TypeError(f'ServingConfig: unknown knob '
                            f'{sorted(unknown)[0]!r}')
        if page_size <= 0 or max_batch_size <= 0 or prefill_chunk <= 0:
            raise ValueError("page_size, max_batch_size and "
                             "prefill_chunk must be positive")
        if spec_k < 0 or spec_ngram < 1:
            raise ValueError("spec_k must be >= 0 and spec_ngram >= 1")
        if fused_k is None:
            fused_k = int(os.environ.get('PTPU_SERVE_FUSED_K', '1'))
        if int(fused_k) < 1:
            raise ValueError("fused_k must be >= 1 (1 = per-token "
                             "decode, k > 1 = fused k-step windows)")
        if deadline_action not in ('report', 'abort'):
            raise ValueError("deadline_action must be 'report' or "
                             "'abort'")
        if weight_dtype is not None and \
                str(weight_dtype).replace('torch.', '') != 'int8':
            raise ValueError("weight_dtype must be None or 'int8', got "
                             f"{weight_dtype!r}")
        if tenants is not None and not isinstance(tenants, dict):
            raise ValueError("tenants must be a {tenant_id: policy} "
                             "dict or None")
        if degrade not in (None, True, False):
            raise ValueError("degrade must be None (auto), True or "
                             "False")
        if int(host_tier_pages) < 0:
            raise ValueError("host_tier_pages must be >= 0 (0 = no "
                             "host tier)")
        if not (0.0 < float(spill_watermark) <= 1.0):
            raise ValueError("spill_watermark must be in (0, 1]")
        self.page_size = int(page_size)
        self.max_batch_size = int(max_batch_size)
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq
        self.prefill_chunk = int(prefill_chunk)
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.prefix_cache = bool(prefix_cache)
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.fused_k = int(fused_k)
        self.seed = int(seed)
        self.trace = bool(trace)
        self.trace_events_per_request = int(trace_events_per_request)
        self.trace_requests = int(trace_requests)
        self.timeline_capacity = int(timeline_capacity)
        self.request_deadline_s = request_deadline_s
        self.deadline_action = deadline_action
        self.report_dir = report_dir
        self.clock = clock
        self.disaggregate = bool(disaggregate)
        self.prefill_slots = int(prefill_slots)
        self.stream_chunk_pages = int(stream_chunk_pages)
        self.tenants = dict(tenants) if tenants is not None else None
        self.degrade = degrade
        self.degrade_window = int(degrade_window)
        self.degrade_up = tuple(degrade_up)
        self.degrade_down = tuple(degrade_down)
        self.degrade_hold = int(degrade_hold)
        self.host_tier_pages = int(host_tier_pages)
        self.spill_watermark = float(spill_watermark)
        self.spill_chunk_pages = int(spill_chunk_pages)
        self.spill_window = int(spill_window)

    @property
    def degrade_enabled(self):
        """The ladder's switch: an explicit bool wins; None means on
        exactly when tenants are declared."""
        if self.degrade is None:
            return self.tenants is not None
        return self.degrade


class ServingEngine:
    """Continuous-batching inference over a GPTForCausalLM on `device`."""

    # followers a budget-blocked queue head tolerates being admitted
    # past it before the admission sweep reverts to blocking at the head
    HOL_BYPASS_LIMIT = 8

    # seconds between periodic metric publishes on a busy engine
    # (retire and drain always publish at once)
    PUBLISH_INTERVAL_S = 0.5

    def __init__(self, model, config=None, device=None, ledger_site=None,
                 **cfg_kw):
        if config is None:
            config = ServingConfig(**cfg_kw)
        elif cfg_kw:
            raise ValueError("pass either config or knobs, not both")
        if config.disaggregate:
            # the flag selects another engine class: serving it unified
            # would silently ignore it
            raise ValueError(
                "config.disaggregate=True needs the disaggregated engine: "
                "build it with serving.cluster.build_engine(...) or "
                "serving.cluster.DisaggregatedEngine(...)")
        self.device = resolve_device(device)
        param = model.gpt.embeddings.word_embeddings.weight
        if param.device.type != self.device.type or (
                self.device.index is not None
                and param.device.index != self.device.index):
            raise ValueError(
                f'the model lives on {param.device}, the engine on '
                f'{self.device}: move the model (model.to(device)) first')
        self.model = model
        self.config = config
        mcfg = model.config
        ps = config.page_size
        self.max_pages_per_seq = int(
            config.max_pages_per_seq or math.ceil(mcfg.max_seq_len / ps))
        num_pages = int(config.num_pages
                        or config.max_batch_size * self.max_pages_per_seq)
        attn0 = model.gpt.layers[0].attn
        self.pool = KVPagePool(
            num_pages, ps, num_layers=mcfg.num_layers,
            num_heads=attn0.local_heads, head_dim=attn0.head_dim,
            dtype=config.kv_dtype or param.dtype,
            prefix_cache=config.prefix_cache)
        self.pool.materialize(param.device)
        # host-RAM tier: pinned host buffers + one transfer thread under
        # the pool; None (the default) makes every tier hook one check
        self._host_tier = None
        self._tier_spilled_seen = 0
        if config.host_tier_pages > 0:
            from .host_tier import HostTier
            self._host_tier = self.pool.attach_host_tier(HostTier(
                config.host_tier_pages, chunk_pages=config.spill_chunk_pages,
                window=config.spill_window))
        self._clock = config.clock or time.perf_counter
        self.scheduler = Scheduler(config.max_batch_size, clock=self._clock)
        self.tracer = RequestTracer(
            capacity_requests=config.trace_requests,
            events_per_request=config.trace_events_per_request,
            clock=self._clock) if config.trace else None
        self.timeline = SchedulerTimeline(config.timeline_capacity)
        self.last_serve_report = None
        self._stall_reported = set()        # req ids already reported
        # weight-only int8 (engine.py:368-390): {param name: (module,
        # attribute, codes, scales)}, quantized once here
        self._qweights = {}
        if config.weight_dtype is not None:
            for name, p in model.named_parameters():
                if p.ndim != 2 or 'embed' in name \
                        or not p.is_floating_point():
                    continue
                mod_name, _, attr = name.rpartition('.')
                q, s = quantize_to_int8(p, quant_axis=1)
                self._qweights[name] = (model.get_submodule(mod_name),
                                        attr, q, s)
        self._next_sample_ord = 0
        self._submitted = 0
        self._completed = 0
        self._aborted = 0
        self._fused_last = None
        # this iteration's measured phases (host perf_counter segments;
        # step() zeroes them, the prefill and decode steps add to them)
        self._it_compute = self._it_fetch = self._it_decode_s = 0.0
        self._it_prefill_s = 0.0
        self._it_kv_read_tokens = self._it_prefill_tokens = 0
        self._it_prefill_ctx = 0
        self._new_slo = {'queue_wait_s': [], 'tpot_s': [], 'e2e_s': [],
                         'preemptions': []}
        self._new_tenant_slo = {}
        self._last_publish = 0.0
        # the periodic publish keys to the monitor's clock (the one gauge
        # staleness stamps read), never to config.clock
        self._last_publish_wall = 0.0
        self._tenants = (TenantTable(config.tenants, clock=self._clock)
                         if config.tenants is not None else None)
        self._ladder = (DegradeLadder(
            window=config.degrade_window, up=config.degrade_up,
            down=config.degrade_down, hold=config.degrade_hold,
            clock=self._clock) if config.degrade_enabled else None)
        self._quota_deferrals = 0
        self._preemptions_charged = 0
        self._deadline_rejects = 0
        self._deadline_misses = 0
        self._tenant_stats = {}
        # pools armed and disarmed with self.pool on stage-3 transitions:
        # under a ladder shared by a prefill and a decode engine, the
        # engine that observes the transition arms both pools
        self._stage3_pools = ()
        # deadline-aware admission at submit; the disaggregated facade
        # turns it off on its prefill engine and gates the whole
        # pipeline's backlog itself
        self.deadline_admission = True
        # the serving ledger over a host-gap monitor: the chosen-id fetch
        # is the engine's one host sync, so its wait is the gating time.
        # Registries are latest-wins per site, so a second engine in the
        # process (the prefill side) takes a site of its own
        self.ledger_site = ledger_site or 'serve'
        self._gap = HostGapMonitor(site=self.ledger_site)
        param_bytes = 0
        n_params = 0
        for name, p in model.named_parameters():
            n_params += p.numel()
            if name in self._qweights:
                _m, _a, q, s = self._qweights[name]
                param_bytes += q.numel() * q.element_size() \
                    + s.numel() * s.element_size()
            else:
                param_bytes += p.numel() * p.element_size()
        self.ledger = ServeLedger(
            engine=self.ledger_site, gap=self._gap, n_params=n_params,
            layers=mcfg.num_layers, hidden=mcfg.hidden_size,
            param_bytes=param_bytes,
            kv_bytes_per_token=self.pool.bytes_per_token(),
            device_kind=(torch.cuda.get_device_name(self.device)
                         if self.device.type == 'cuda' else 'cpu'))
        self.reset_stats()

    # -- tenancy helpers -----------------------------------------------------
    @staticmethod
    def _blank_tstat():
        return {'submitted': 0, 'completed': 0, 'aborted': 0,
                'quota_deferrals': 0, 'preemptions_charged': 0,
                'charge_tokens': 0, 'deadline_rejects': 0,
                'deadline_misses': 0, 'tokens_billed': 0}

    def _tstat(self, tenant_id):
        """Per-tenant lifetime accounting row, created on first write."""
        tid = str(tenant_id)
        st = self._tenant_stats.get(tid)
        if st is None:
            st = self._tenant_stats[tid] = self._blank_tstat()
        return st

    def decode_rate(self):
        """Observed decode throughput (generated tokens/sec), 0.0 until
        the first measured decode step."""
        return (self._decode_tokens / self._decode_time
                if self._decode_time else 0.0)

    def pending_tokens(self):
        """Tokens of accepted work not yet computed: un-prefilled prompt
        + remaining generation budget over the queue and the slots."""
        reqs = ([r for r in self.scheduler.slots if r is not None]
                + list(self.scheduler.waiting))
        return sum(max(r.max_new_tokens - len(r.generated), 0)
                   + max(len(r.tokens) - r.prefilled, 0)
                   for r in reqs)

    def _estimate_completion_s(self, extra_tokens):
        """Seconds until a request of `extra_tokens` total work would
        complete behind the backlog; None while no decode rate has been
        observed (a cold engine admits)."""
        rate = self.decode_rate()
        if rate <= 0.0:
            return None
        return (self.pending_tokens() + extra_tokens) / rate

    def degrade_stage(self):
        return self._ladder.stage if self._ladder is not None else 0

    def _effective_spec_k(self):
        """Ladder stage 1+ sheds speculative decoding (outputs are
        spec-invariant, so shedding is invisible in tokens)."""
        if self._ladder is not None and self._ladder.stage >= 1:
            return 0
        return self.config.spec_k

    def _effective_prefill_chunk(self):
        """Ladder stage 2+ halves the prefill chunk (floor: one page,
        never larger than the configured chunk)."""
        C = self.config.prefill_chunk
        if self._ladder is not None and self._ladder.stage >= 2:
            return min(C, max(self.pool.page_size, C // 2))
        return C

    def _effective_fused_k(self):
        """Ladder stage 1+ sheds the fused window (outputs are
        fused-invariant)."""
        if self._ladder is not None and self._ladder.stage >= 1:
            return 1
        return self.config.fused_k

    def _fused_ok(self, k):
        """A k-iteration fused window needs a quiescent scheduler and no
        ladder transition reachable within k observations of the current
        pressure."""
        if not self.scheduler.quiescent():
            return False
        if self._ladder is not None:
            p = DegradeLadder.pressure_of(
                self.pool.utilization(), len(self.scheduler.waiting),
                self.config.max_batch_size, spill=self._spill_pressure())
            if self._ladder.would_transition(p, k):
                return False
        return True

    def ladder_history(self):
        """Stage transitions [{t, from, to, pressure}]."""
        return list(self._ladder.history) if self._ladder else []

    # -- request intake ------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
               temperature=1.0, top_k=0, tenant_id=None, priority=None,
               deadline_s=None):
        """Queue one request: greedy at top_k <= 0 (temperature
        ignored), else sampled from the temperature-scaled top-k set.
        `priority` defaults to the tenant's class; a `deadline_s` the
        backlog already makes unmeetable raises AdmissionRejected
        ('deadline_unmet', with a retry_after_s hint)."""
        if priority is None:
            priority = (self._tenants.priority_of(tenant_id)
                        if self._tenants is not None else 0)
        req = Request(prompt_ids, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, temperature=temperature,
                      top_k=top_k, tenant_id=tenant_id, priority=priority,
                      deadline_s=deadline_s)
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_pages_per_seq * self.pool.page_size:
            raise ValueError(
                f"request needs {total} tokens; page table holds "
                f"{self.max_pages_per_seq} pages of {self.pool.page_size}")
        if self.pool.pages_for(total) > self.pool.num_pages:
            # admission's page budget would skip it forever
            raise PoolExhausted(
                f"KV pool ({self.pool.num_pages} pages x "
                f"{self.pool.page_size}) cannot hold one request of "
                f"{total} tokens — raise num_pages")
        if total > self.model.config.max_seq_len:
            raise ValueError(
                f"prompt({len(req.prompt)}) + max_new_tokens"
                f"({req.max_new_tokens}) exceeds max_seq_len"
                f"({self.model.config.max_seq_len})")
        if req.deadline_s is not None and self.deadline_admission:
            est = self._estimate_completion_s(total)
            if est is not None and est > req.deadline_s:
                self._deadline_rejects += 1
                if req.tenant_id is not None:
                    self._tstat(req.tenant_id)['deadline_rejects'] += 1
                raise AdmissionRejected(
                    'deadline_unmet', retry_after_s=est - req.deadline_s,
                    estimated_s=est, deadline_s=req.deadline_s)
        # engine-local ordinal in submission order: identically seeded
        # engines fed the same prompts draw identical tokens. A request
        # adopted from a prefill engine keeps the ordinal it got there
        if req.sample_ord is None:
            req.sample_ord = self._next_sample_ord
            self._next_sample_ord += 1
        self.scheduler.submit(req)
        self._submitted += 1
        if req.tenant_id is not None:
            self._tstat(req.tenant_id)['submitted'] += 1
        fields = {}
        if req.tenant_id is not None:
            fields['tenant_id'] = req.tenant_id
        if req.priority:
            fields['priority'] = req.priority
        if req.deadline_s is not None:
            fields['deadline_s'] = req.deadline_s
        self._trace(req, 'submit', t=req.submit_time,
                    prompt_tokens=len(req.prompt),
                    max_new_tokens=req.max_new_tokens, **fields)
        return req

    def _trace(self, req, event, t=None, **fields):
        if self.tracer is not None:
            self.tracer.record(req.id, event, t=t, **fields)

    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 temperature=1.0, top_k=0, max_steps=None):
        """Submit every prompt, drive step() until drained, return the
        per-prompt token lists (prompt + generated) in submission
        order."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens,
                            eos_token_id=eos_token_id,
                            temperature=temperature, top_k=top_k)
                for p in prompts]
        guard = max_steps or 16 * (max_new_tokens + 4) * max(
            1, math.ceil(len(reqs) / self.config.max_batch_size))
        steps = 0
        while self.scheduler.has_work:
            self.step()
            steps += 1
            if steps > guard:
                raise RuntimeError(
                    f"serving loop did not drain in {guard} steps")
        return [r.output_ids() for r in reqs]

    # -- engine iteration ----------------------------------------------------
    def step(self):
        """One scheduler iteration: run the watchdog and admit waiting
        requests, advance one prefill chunk per prefilling request, then
        one batched decode step (or fused window) for the running set.
        Records one timeline entry (and one ledger iteration) per decode
        iteration, feeds the ladder, and publishes metrics on retire, on
        drain and every PUBLISH_INTERVAL_S (engine.py:732)."""
        completed_before = self._completed
        preempt_before = self.scheduler.preemptions
        t_begin = self._gap.dispatch_begin()
        self._it_compute = 0.0
        self._it_fetch = 0.0
        self._it_decode_s = 0.0
        self._it_kv_read_tokens = 0
        self._it_prefill_tokens = 0
        self._it_prefill_s = 0.0
        self._it_prefill_ctx = 0
        t_sched = time.perf_counter()
        with RecordEvent('serve::schedule', event_type='serve'):
            self._check_stalled()
            admitted = self._admit()
        sched_dt = time.perf_counter() - t_sched
        prefilling = [r for r in self.scheduler.slots
                      if r is not None and r.state == RequestState.PREFILL]
        prefill_tokens = 0
        for req in prefilling:
            with RecordEvent('serve::prefill_chunk', event_type='serve',
                             req=req.id):
                prefill_tokens += self._prefill_chunk_step(req)
        running = [r for r in self.scheduler.slots
                   if r is not None and r.state == RequestState.RUNNING]
        decode_slots = decode_tokens = 0
        if running:
            with RecordEvent('serve::decode', event_type='serve'):
                # post-preemption counts: slots are the surviving rows,
                # tokens what they emitted
                decode_slots, decode_tokens = self._decode_step()
        # one record per decode ITERATION: a fused window of n_iter
        # iterations gives n_iter entries with that iteration's rows,
        # walls amortized over the window; admissions, preemptions and
        # prefill go to the first
        fused = self._fused_last
        self._fused_last = None
        n_iter = fused['iters'] if fused else 1
        wall = time.perf_counter() - t_begin
        for j in range(n_iter):
            first = (j == 0)
            self._observe_pressure()
            entry = dict(
                t=self._clock(),
                decode_slots_occupied=(fused['rows'][j] if fused
                                       else decode_slots),
                decode_slots=self.config.max_batch_size,
                prefill_tokens=prefill_tokens if first else 0,
                decode_tokens=(fused['rows'][j] if fused
                               else decode_tokens),
                admissions=admitted if first else 0,
                preemptions=(self.scheduler.preemptions - preempt_before
                             if first else 0),
                waiting=len(self.scheduler.waiting),
                pool_pages_in_use=self.pool.pages_in_use,
                pool_pages_total=self.pool.num_pages,
                degrade_stage=self.degrade_stage())
            if fused:
                entry['fused'] = True
                entry['fused_k'] = fused['k']
            self.timeline.record(**entry)
            self.ledger.observe_iteration(
                wall=wall / n_iter,
                compute=self._it_compute / n_iter,
                host_fetch=self._it_fetch / n_iter,
                schedule=sched_dt / n_iter,
                decode_seconds=self._it_decode_s / n_iter,
                kv_read_tokens=self._it_kv_read_tokens // n_iter,
                prefill_tokens=self._it_prefill_tokens if first else 0,
                prefill_seconds=self._it_prefill_s if first else 0.0,
                prefill_ctx_tokens=self._it_prefill_ctx if first else 0)
        # host-tier close-out: transfer wall since the last step goes to
        # the ledger's page_stream, newly spilled pages to one
        # engine-scope `spill` trace event
        if self._host_tier is not None:
            tier_wall = self._host_tier.take_wall()
            if tier_wall > 0.0:
                self.ledger.note_page_stream(tier_wall)
            spilled = self._host_tier.spilled_pages
            if spilled > self._tier_spilled_seen:
                if self.tracer is not None:
                    self.tracer.record(
                        ENGINE_REQ, 'spill',
                        pages=spilled - self._tier_spilled_seen,
                        host_used_pages=self._host_tier.used_slots)
                self._tier_spilled_seen = spilled
        # dispatch_end BEFORE note_gating: dispatch_end zeroes the pending
        # gating, and the fetch wait belongs to the span that just closed
        self._gap.dispatch_end(depth=1)
        if self._it_fetch > 0.0:
            self._gap.note_gating(self._it_fetch)
        if (self._completed != completed_before
                or not self.scheduler.has_work
                or (_monitor._time_fn() - self._last_publish_wall
                    >= self.PUBLISH_INTERVAL_S)):
            self.publish_metrics()

    def _observe_pressure(self):
        """Feed the ladder this iteration's pressure and apply a stage
        transition: the gauge at once, an engine-scope `degrade_stage`
        trace event, and stage 3 arming (or leaving it disarming) the
        pool's weighted eviction. Stages 1 and 2 act through the
        _effective_* helpers at their use sites."""
        self._observe_spill_pressure()
        if self._ladder is None:
            return
        ev = self._ladder.observe(self.pool.utilization(),
                                  len(self.scheduler.waiting),
                                  self.config.max_batch_size,
                                  spill=self._spill_pressure())
        if ev is None:
            return
        _metrics.publish_degrade_stage(self._ladder.stage,
                                       self._ladder.pressure())
        if self.tracer is not None:
            self.tracer.record(
                ENGINE_REQ, 'degrade_stage', t=ev['t'],
                from_stage=ev['from'], stage=ev['to'],
                stage_name=DegradeLadder.STAGE_NAMES[ev['to']],
                pressure=ev['pressure'])
        if ev['to'] >= 3 and self._tenants is not None:
            weights = self._tenants.eviction_weights()
            for pool in (self.pool, *self._stage3_pools):
                pool.set_eviction_weights(weights)
        elif ev['from'] >= 3 > ev['to']:
            for pool in (self.pool, *self._stage3_pools):
                pool.set_eviction_weights(None)

    def _spill_pressure(self):
        """Host-tier occupancy in [0, 1], the ladder's spill input (0.0
        without a tier)."""
        t = self._host_tier
        return t.used_slots / t.host_pages if t is not None else 0.0

    def _observe_spill_pressure(self):
        """The proactive spiller: pool utilization past the watermark
        starts an async spill of LRU-parked cached subtrees, so the free
        list restocks off the critical path."""
        if self._host_tier is None:
            return
        if self.pool.utilization() >= self.config.spill_watermark \
                and self.pool.cached_pages > 0:
            self.pool.spill_lru(max_pages=max(self.pool.num_pages // 8, 1))

    def _admit(self):
        """Admit waiting requests one at a time against a free-page
        budget: each admission reserves its FIRST chunk's pages, net of
        pages a live sibling already maps (prefix hits). A head whose
        first chunk exceeds this sweep's budget is skipped, keeping its
        queue position, and admissible followers behind it go in — at
        most HOL_BYPASS_LIMIT of them past one head, after which the
        sweep blocks at the head so freed pages accumulate for it.

        Tenancy: the sweep runs in priority-then-FCFS order; with every
        slot held, a request above some running tenant's class displaces
        the youngest of the lowest class below it (charged). A quota'd
        tenant's request debits its whole token bill at FIRST admit;
        insufficient quota defers it (a `quota_defer` trace event on the
        defer edge) without spending the bypass bound (engine.py:913 in
        the JAX package)."""
        sched = self.scheduler
        budget = self.pool.free_pages
        n_admitted = 0
        n_bypassed = 0
        blocked_head = None
        skipped_before = False
        for req in sched.admission_order():
            victim = None
            if None not in sched.slots:
                if self._tenants is None:
                    break
                victim = sched.preempt_victim(below_priority=req.priority)
                if victim is None:
                    break
            cached, live, _resv, _host = self.pool.peek_prefix(
                req.tokens, limit=len(req.tokens) - 1)
            need = max(self.pool.pages_for(
                min(len(req.tokens),
                    cached + self._effective_prefill_chunk())) - live, 0)
            # feasibility BEFORE any side effect: count only what the
            # victim's release would actually free
            avail = budget + (self.pool.reclaimable_pages(victim.id)
                              if victim is not None else 0)
            if avail < need:
                if not skipped_before:
                    if req.admit_bypasses >= self.HOL_BYPASS_LIMIT:
                        break       # starvation bound: block at the head
                    blocked_head = req
                skipped_before = True
                continue
            if not self._try_debit_quota(req):
                skipped_before = True
                continue            # over quota: deferred, not dropped
            if victim is not None:
                budget += self._charge_and_preempt(req, victim)
            if sched.admit_request(req) is None:
                skipped_before = True
                continue
            req.quota_deferred = False
            budget -= need
            n_admitted += 1
            if blocked_head is not None:
                n_bypassed += 1
            self._trace(req, 'resume' if req.preemptions else 'admit',
                        t=(req.admit_time if not req.preemptions else None),
                        slot=sched.slot_of(req), waiting=len(sched.waiting))
        if blocked_head is not None:
            blocked_head.admit_bypasses += n_bypassed
        return n_admitted

    def _try_debit_quota(self, req):
        """Debit req's token bill (prompt + generation budget) from its
        tenant's bucket at first admit. True = admit may proceed; False =
        defer this sweep (the defer edge counts once and emits one
        quota_defer trace event with the bucket's retry estimate)."""
        if self._tenants is None or req.quota_charged:
            return True
        bucket = self._tenants.bucket(req.tenant_id)
        if bucket is None:
            return True
        bill = len(req.prompt) + req.max_new_tokens
        if bucket.try_debit(bill):
            req.quota_charged = True
            if req.tenant_id is not None:
                self._tstat(req.tenant_id)['tokens_billed'] += bill
            return True
        if not req.quota_deferred:
            req.quota_deferred = True
            req.quota_defers += 1
            self._quota_deferrals += 1
            self._tstat(req.tenant_id)['quota_deferrals'] += 1
            self._trace(req, 'quota_defer', tenant_id=req.tenant_id,
                        bill_tokens=bill,
                        retry_after_s=bucket.seconds_until(bill))
        return False

    def adopt_request(self, req):
        """Adopt a request prefilled elsewhere (the disaggregated
        engine's handoff): its pages are already allocated in this pool
        under req.id with their rows streamed in, and its first token is
        in req.generated, so it goes straight to a RUNNING slot. False
        when no slot is free (the caller keeps it pending). Its pages
        join this pool's prefix index like locally prefilled ones
        (engine.py:1059 in the JAX package)."""
        if self.scheduler.adopt(req) is None:
            return False
        req.prefilled = len(req.tokens)
        self._submitted += 1
        # every token but the newest has its K/V resident; the next decode
        # step writes that one
        self.pool.register_prefix(req.id, req.tokens, req.context_len - 1,
                                  owner=req.tenant_id)
        self._trace(req, 'admit', slot=self.scheduler.slot_of(req),
                    handoff=True, pages=len(self.pool.page_table(req.id)))
        if req.done:
            self._retire(req)
        return True

    def _ensure_or_preempt(self, req, n_tokens):
        """Grow req's pages, preempting other requests until the
        allocation fits. A victim whose pages are all shared frees
        nothing, so the loop moves on. With tenants the victim is the
        youngest of the lowest class strictly below req's, else a
        same-class peer; when every other slot holder outranks req, req
        YIELDS (released and re-queued, returns False). Returns True when
        capacity was ensured (engine.py:1085)."""
        sched = self.scheduler
        while True:
            try:
                self.pool.ensure_capacity(req.id, n_tokens)
                return True
            except PoolExhausted:
                if self._tenants is not None:
                    victim = sched.preempt_victim(
                        exclude=req, below_priority=req.priority)
                    if victim is None:
                        victim = sched.preempt_victim(
                            exclude=req, below_priority=req.priority + 1)
                else:
                    victim = sched.preempt_victim(exclude=req)
                if victim is None:
                    if (self._tenants is not None and req in sched.slots
                            and any(r is not None and r is not req
                                    for r in sched.slots)):
                        released = self.pool.release(req.id)
                        sched.preempt(req)
                        self._trace(
                            req, 'preempt', pages_released=released,
                            tokens_generated=len(req.generated),
                            reason='yield_to_higher_priority')
                        return False
                    raise PoolExhausted(
                        f"KV pool ({self.pool.num_pages} pages x "
                        f"{self.pool.page_size}) cannot hold one request "
                        f"of {n_tokens} tokens — raise num_pages")
                self._charge_and_preempt(req, victim)

    def _charge_and_preempt(self, req, victim):
        """Preempt `victim` on behalf of `req`: with tenants, charge the
        victim's destroyed prefill work to req's tenant bucket; release
        the victim's pages and re-queue it at the front of its class.
        Returns the pages released."""
        charge = 0
        if self._tenants is not None:
            charge = max(victim.prefilled, 1)
            bucket = self._tenants.bucket(req.tenant_id)
            if bucket is not None:
                bucket.charge(charge)
            self._preemptions_charged += 1
            if req.tenant_id is not None:
                st = self._tstat(req.tenant_id)
                st['preemptions_charged'] += 1
                st['charge_tokens'] += charge
        released = self.pool.release(victim.id)
        self.scheduler.preempt(victim)
        self._trace(victim, 'preempt', pages_released=released,
                    for_req=req.id, tokens_generated=len(victim.generated),
                    **({'charged_to': req.tenant_id, 'charge_tokens': charge}
                       if self._tenants is not None else {}))
        return released

    def _page_row(self, req):
        row = self.pool.page_table(req.id)
        return row + [0] * (self.max_pages_per_seq - len(row))

    # -- device work ---------------------------------------------------------
    @contextlib.contextmanager
    def _serving(self):
        """The model in eval mode under inference_mode, with int8
        weights dequantized one module at a time: each weight is
        replaced by its dequantized copy just before its module runs
        and put back just after, so no full-precision copy of the model
        is ever built."""
        model = self.model
        was_training = model.training
        model.eval()
        handles, originals = [], []
        for mod, attr, q, s in self._qweights.values():
            param = mod._parameters[attr]
            originals.append((mod, attr, param))
            handles.append(mod.register_forward_pre_hook(
                _dequantize_hook(attr, q, s, param.dtype)))
            handles.append(mod.register_forward_hook(
                _restore_hook(attr, param)))
        try:
            with torch.inference_mode():
                yield
        finally:
            for h in handles:
                h.remove()
            for mod, attr, param in originals:
                mod._parameters[attr] = param
            if was_training:
                model.train()

    def _head(self):
        """The tied LM head in fp32, upcast once per dispatch: the
        logits are fp32 products of the activations and the embedding,
        as the JAX step's `preferred_element_type` gives them."""
        return self.model.gpt.embeddings.word_embeddings.weight.float()

    def _hidden(self, tokens, page_tables, seq_lens, q_lens):
        """One paged forward from host numpy int32 inputs: tokens [B, T],
        page_tables [B, max_pages_per_seq], seq_lens and q_lens [B].
        Returns hidden [B, T, H] on the device (call under _serving)."""
        T = tokens.shape[1]
        max_pos = self.model.config.max_seq_len - 1
        pos = np.clip(seq_lens[:, None] - q_lens[:, None]
                      + np.arange(T, dtype=np.int32)[None, :], 0, max_pos)
        h, _ = self.model.gpt.forward_paged(
            torch.from_numpy(tokens), torch.from_numpy(pos), self.pool.kv,
            torch.from_numpy(page_tables), torch.from_numpy(seq_lens),
            torch.from_numpy(q_lens))
        return h

    def _logits(self, tokens, page_tables, seq_lens, q_lens):
        """fp32 logits [B, V] of each row's last new token (call under
        _serving)."""
        h = self._hidden(tokens, page_tables, seq_lens, q_lens)
        B, T = tokens.shape
        last = torch.from_numpy(np.clip(q_lens - 1, 0, T - 1)).to(h.device)
        h_last = h[torch.arange(B, device=h.device), last]
        return torch.matmul(h_last.float(), self._head().t())

    def _choose(self, logits, ords, positions, temps, top_ks):
        """Next token per row of fp32 logits [B, V], on the device:
        greedy unless a row samples. The row metadata is host numpy."""
        if not (top_ks > 0).any():
            return torch.argmax(logits, dim=-1)
        dev = logits.device
        return _device_sample(
            logits, self.config.seed,
            torch.from_numpy(ords.astype(np.int64)).to(dev),
            torch.from_numpy(positions.astype(np.int64)).to(dev),
            torch.from_numpy(temps.astype(np.float32)).to(dev),
            torch.from_numpy(top_ks.astype(np.int64)).to(dev))

    def _step_ids(self, tokens, page_tables, seq_lens, q_lens, ords,
                  temps, top_ks, verify=False):
        """One dispatch: [B] next tokens on the device; with `verify`,
        [B, T] greedy argmax at every query position (the drafts'
        verdicts), plus a column T holding the sampled token of rows that
        sample (engine.py:1238-1263). Nothing here waits for the card."""
        with self._serving():
            if verify:
                h = self._hidden(tokens, page_tables, seq_lens, q_lens)
                logits = torch.matmul(h.float(), self._head().t())
                nxt = torch.argmax(logits, dim=-1)              # [B, T]
                if (top_ks > 0).any():
                    B, T = tokens.shape
                    last = torch.from_numpy(np.clip(q_lens - 1, 0, T - 1))
                    rows = torch.arange(B)
                    samp = self._choose(
                        logits[rows.to(h.device), last.to(h.device)],
                        ords, seq_lens, temps, top_ks)
                    nxt = torch.cat([nxt, samp[:, None]], 1)
                return nxt
            return self._choose(
                self._logits(tokens, page_tables, seq_lens, q_lens),
                ords, seq_lens, temps, top_ks)

    def _fetch(self, nxt):
        """The chosen-id fetch of one dispatch: `_host_fetch` under the
        serve::sample_fetch range, its wait added to this iteration's
        fetch time. Returns the ids as host numpy."""
        t0 = time.perf_counter()
        with RecordEvent('serve::sample_fetch', event_type='serve'):
            out = _host_fetch(nxt)
        self._it_fetch += time.perf_counter() - t0
        return out

    def prompt_logits(self, prompt_ids):
        """fp32 logits of the token after `prompt_ids`, computed by the
        engine's own prefill steps on scratch pages that are released
        afterwards (nothing is registered in the prefix index). Returns
        a CPU tensor [V]."""
        toks = [int(t) for t in prompt_ids]
        C = self.config.prefill_chunk
        seq = ('prompt_logits', id(toks))
        try:
            self.pool.ensure_capacity(seq, len(toks))
            row = self.pool.page_table(seq)
            row = np.asarray([row + [0] * (self.max_pages_per_seq
                                           - len(row))], np.int32)
            with self._serving():
                for start in range(0, len(toks), C):
                    n = min(C, len(toks) - start)
                    chunk = toks[start:start + n] + [0] * (C - n)
                    logits = self._logits(
                        np.asarray([chunk], np.int32), row,
                        np.asarray([start + n], np.int32),
                        np.asarray([n], np.int32))
                return logits[0].cpu()
        finally:
            self.pool.release(seq)

    def _prefill_chunk_step(self, req):
        C = self._effective_prefill_chunk()
        if req.state != RequestState.PREFILL:
            return 0        # preempted earlier in this same sweep
        toks = req.tokens
        if req.prefilled == 0 and self.pool.prefix_cache:
            # first chunk of a fresh admit (or a resume): map the longest
            # indexed prefix, capped one short of the context so the
            # step still computes the logits the first token needs
            cached = self.pool.match_and_map(req.id, toks,
                                             limit=len(toks) - 1)
            if cached:
                req.prefilled = cached
                self._trace(req, 'prefix_hit', cached_tokens=cached,
                            pages=len(self.pool.page_table(req.id)))
                # pages the match fetched back from the host tier
                rz = (self.pool.pop_resurrect_stats()
                      if self._host_tier is not None else None)
                if rz:
                    self._trace(req, 'resurrect', pages=rz['pages'],
                                tokens=rz['tokens'])
        start = req.prefilled
        n = min(C, len(toks) - start)
        if not self._ensure_or_preempt(req, start + n):
            return 0        # yielded to higher-priority pool pressure
        chunk = toks[start:start + n] + [0] * (C - n)
        tc0 = time.perf_counter()
        with RecordEvent('serve::compiled_step', event_type='serve',
                         shape='prefill'):
            ids = self._step_ids(
                np.asarray([chunk], np.int32),
                np.asarray([self._page_row(req)], np.int32),
                np.asarray([start + n], np.int32), np.asarray([n], np.int32),
                np.asarray([_ord_of(req)]), np.asarray([req.temperature]),
                np.asarray([req.top_k]))
        tc1 = time.perf_counter()
        self._prefill_time += tc1 - tc0
        self._it_compute += tc1 - tc0
        self._it_prefill_s += tc1 - tc0
        self._it_prefill_tokens += n
        self._it_prefill_ctx += n * (start + n)
        req.prefilled = start + n
        self._prefill_tokens += n
        self._prefill_chunks += 1
        # goodput: positions below the request's computed high-water mark
        # were computed before (then destroyed by a preemption) — this
        # chunk re-derives them, priced as preempt_recompute waste
        prev_high = getattr(req, '_computed_high', 0)
        recompute = max(0, min(prev_high, start + n) - start)
        req._computed_high = max(prev_high, start + n)
        self.ledger.account_prefill(n - recompute, recompute,
                                    tenant_id=req.tenant_id)
        # every prefilled token's K/V is resident: index the newly
        # completed full pages so siblings (and our own resume) share
        self.pool.register_prefix(req.id, toks, req.prefilled,
                                  owner=req.tenant_id)
        extra = {'recompute_tokens': recompute} if recompute else {}
        if req.prefilled == len(toks) and req.max_new_tokens > 0:
            extra['sampled'] = 1
        self._trace(req, 'prefill_chunk', tokens=n, prefilled=start + n,
                    pages=len(self.pool.page_table(req.id)), **extra)
        if req.prefilled == len(toks):
            if req.max_new_tokens <= 0:
                self._retire(req)   # prefill-only request
                return n
            # the sampled-token fetch: only the chunk that completes the
            # prefill reads its ids back; an earlier chunk stays queued
            tf0 = time.perf_counter()
            req.generated.append(int(self._fetch(ids)[0]))
            self._prefill_time += time.perf_counter() - tf0
            self.prefill_fetches += 1
            if req.first_token_time is None:
                req.first_token_time = self._clock()
                ttft = req.first_token_time - req.submit_time
                self._ttfts_s.append(ttft)
                self._new_ttfts_s.append(ttft)
                self._trace(req, 'first_token', t=req.first_token_time,
                            tokens_generated=1,
                            pages=len(self.pool.page_table(req.id)))
            if req.done:
                self._retire(req)
            else:
                req.state = RequestState.RUNNING
        return n

    def _decode_step(self):
        """One batched decode dispatch (engine.py:1666-1848). With
        spec_k > 0 (and the ladder below stage 1), greedy requests whose
        history yields an n-gram proposal carry up to spec_k drafts into
        the [B, spec_k+1] verify step; the longest agreeing draft prefix
        plus the next token is accepted, and pages grown for rejected
        drafts are handed back (their slots are rewritten in place before
        any step can read them: the seq_len mask hides them until then).
        With fused_k > 1 and no drafts, a quiescent scheduler runs a
        fused window instead. Returns (rows, tokens emitted)."""
        sched = self.scheduler
        K = self._effective_spec_k()
        if self.config.spec_k > 0 and K == 0:
            # the ladder shed the draft capacity this step: price the
            # foregone draft columns as shed capacity (never computed)
            for req in sched.slots:
                if req is None or req.state != RequestState.RUNNING \
                        or req.top_k > 0:
                    continue
                budget = req.max_new_tokens - len(req.generated) - 1
                if budget > 0:
                    self.ledger.account_spec_shed(
                        min(self.config.spec_k, budget),
                        tenant_id=req.tenant_id)
        proposals = {}
        if K > 0:
            for req in sched.slots:
                if req is None or req.state != RequestState.RUNNING \
                        or req.top_k > 0:
                    continue        # spec verify is greedy-only
                budget = req.max_new_tokens - len(req.generated) - 1
                drafts = _ngram_propose(req.tokens, self.config.spec_ngram,
                                        min(K, budget))
                if drafts:
                    proposals[req.id] = drafts
        FK = self._effective_fused_k()
        if FK > 1 and not proposals and self._fused_ok(FK):
            res = self._fused_decode_window(FK)
            if res is not None:
                return res
        # capacity first (may preempt, or yield the request itself); then
        # snapshot the running set — a yielded request left its slot
        for req in list(sched.slots):
            if req is not None and req.state == RequestState.RUNNING:
                if not self._ensure_or_preempt(
                        req, req.context_len
                        + len(proposals.get(req.id, ()))):
                    proposals.pop(req.id, None)
        B = self.config.max_batch_size
        verify = any(req is not None and req.state == RequestState.RUNNING
                     and req.id in proposals for req in sched.slots)
        T = K + 1 if verify else 1
        with RecordEvent('serve::prepare', event_type='serve'):
            tokens = np.zeros((B, T), np.int32)
            page_tables = np.zeros((B, self.max_pages_per_seq), np.int32)
            seq_lens = np.ones((B,), np.int32)
            q_lens = np.zeros((B,), np.int32)
            ords = np.zeros((B,), np.int64)
            temps = np.zeros((B,), np.float32)
            top_ks = np.zeros((B,), np.int64)
            active = []
            for i, req in enumerate(sched.slots):
                if req is None or req.state != RequestState.RUNNING:
                    continue
                drafts = list(proposals.get(req.id, ())) if verify else []
                active.append((i, req, drafts))
                # decode roofline: KV tokens this row's attention reads
                self._it_kv_read_tokens += req.context_len + len(drafts)
                tokens[i, 0] = (req.generated[-1] if req.generated
                                else req.prompt[-1])
                tokens[i, 1:1 + len(drafts)] = drafts
                page_tables[i, :] = self._page_row(req)
                seq_lens[i] = req.context_len + len(drafts)
                q_lens[i] = 1 + len(drafts)
                ords[i] = _ord_of(req)
                temps[i] = req.temperature
                top_ks[i] = req.top_k
        if not active:
            return 0, 0
        t0 = time.perf_counter()
        with RecordEvent('serve::compiled_step', event_type='serve',
                         shape='verify' if verify else 'decode',
                         batch=len(active)):
            ids = self._step_ids(tokens, page_tables, seq_lens, q_lens, ords,
                                 temps, top_ks, verify=verify)
        t1 = time.perf_counter()
        nxt = self._fetch(ids)
        self._it_compute += t1 - t0
        self._it_decode_s += t1 - t0
        self._decode_time += time.perf_counter() - t0
        self._decode_steps += 1
        self._occupancy_sum += len(active) / B
        self._util_sum += self.pool.utilization()
        emitted_total = 0
        for i, req, drafts in active:
            spec_m = None
            if not verify:
                appended = [int(nxt[i])]
            elif req.top_k > 0:
                appended = [int(nxt[i, T])]         # the sampled column
            else:
                g = nxt[i]
                m = 0
                while m < len(drafts) and int(g[m]) == drafts[m]:
                    m += 1
                appended = drafts[:m] + [int(g[m])]
                if drafts:
                    self._spec_proposed += len(drafts)
                    self._spec_accepted += m
                    self._spec_steps += 1
                    spec_m = m
            # emit in order, stopping at eos or the budget exactly where
            # the one-token path would
            delivered_row = 0
            for tok in appended:
                req.generated.append(tok)
                emitted_total += 1
                delivered_row += 1
                if req.done:
                    break
            # goodput: this row computed 1 + len(drafts) query columns;
            # those that never reached the request are spec_rejected
            self.ledger.account_decode(
                delivered_row, 1 + len(drafts) - delivered_row,
                tenant_id=req.tenant_id)
            if spec_m is not None:
                self._trace(req, 'spec_verify', proposed=len(drafts),
                            accepted=spec_m,
                            discarded=len(appended) - delivered_row)
            prev_high = getattr(req, '_computed_high', 0)
            req._computed_high = max(prev_high, req.context_len - 1)
            if drafts:
                # speculative rollback: hand back pages grown for
                # rejected drafts beyond the accepted context
                self.pool.trim(req.id, req.context_len)
            # K/V is resident for everything but the newest token
            self.pool.register_prefix(req.id, req.tokens,
                                      req.context_len - 1,
                                      owner=req.tenant_id)
            self._trace(req, 'decode', tokens_generated=len(req.generated),
                        seq_len=req.context_len,
                        pages=len(self.pool.page_table(req.id)))
            if req.done:
                self._retire(req)
        self._decode_tokens += emitted_total
        return len(active), emitted_total

    # -- fused decode windows --------------------------------------------------
    def _fused_decode_window(self, K):
        """Up to K decode iterations on the card and ONE host fetch
        (engine.py:1431). Every row's whole window of pages is reserved
        up front (pool.try_reserve, all or nothing); the host replays
        the serial append-then-check loop on the fetched [B, K] ids, so
        eos and budget cuts land exactly where K serial steps stop, and
        the unused tail of each reservation is trimmed back. Returns
        (rows, tokens emitted), or None when a reservation fails and the
        [B, 1] step should run instead."""
        sched = self.scheduler
        B = self.config.max_batch_size
        rows = []
        for i, req in enumerate(sched.slots):
            if req is None or req.state != RequestState.RUNNING:
                continue
            w = min(K, req.max_new_tokens - len(req.generated))
            if not self.pool.try_reserve(req.id, req.context_len + w):
                # roll the earlier rows' fresh reservations back so the
                # serial step sees the pool it would have seen
                for _i, r, _w in rows:
                    self.pool.trim(r.id, r.context_len)
                return None
            rows.append((i, req, w))
        if not rows:
            return 0, 0
        with RecordEvent('serve::prepare', event_type='serve'):
            meta = {'tokens': np.zeros((B,), np.int64),
                    'page_tables': np.zeros((B, self.max_pages_per_seq),
                                            np.int32),
                    'seq_lens': np.ones((B,), np.int32),
                    'ords': np.zeros((B,), np.int64),
                    'rems': np.zeros((B,), np.int32),
                    'eos_ids': np.full((B,), -1, np.int64),
                    'live': np.zeros((B,), bool),
                    'temps': np.zeros((B,), np.float32),
                    'top_ks': np.zeros((B,), np.int64)}
            for i, req, w in rows:
                meta['tokens'][i] = (req.generated[-1] if req.generated
                                     else req.prompt[-1])
                meta['page_tables'][i, :] = self._page_row(req)
                meta['seq_lens'][i] = req.context_len
                meta['ords'][i] = _ord_of(req)
                meta['rems'][i] = w
                if req.eos_token_id is not None:
                    meta['eos_ids'][i] = req.eos_token_id
                meta['live'][i] = True
                meta['temps'][i] = req.temperature
                meta['top_ks'][i] = req.top_k
                # decode roofline: iteration j of this row reads
                # context_len + j KV tokens
                self._it_kv_read_tokens += \
                    w * req.context_len + w * (w - 1) // 2
        t0 = time.perf_counter()
        with RecordEvent('serve::compiled_step', event_type='serve',
                         shape='fused', batch=len(rows), k=K):
            with self._serving():
                ys = self._fused_steps(K, meta)
        t1 = time.perf_counter()
        nxt = self._fetch(ys)               # ONE fetch for the window
        self._it_compute += t1 - t0
        self._it_decode_s += t1 - t0
        self._decode_time += time.perf_counter() - t0
        emitted_total = 0
        per_iter_rows = [0] * K
        accepted = {}
        for i, req, _w in rows:
            a = 0
            for j in range(K):
                if req.done:
                    break
                req.generated.append(int(nxt[i, j]))
                per_iter_rows[j] += 1
                a += 1
            accepted[i] = a
            emitted_total += a
        iters_run = max(accepted.values())
        util = self.pool.utilization()
        for j in range(iters_run):
            self._occupancy_sum += per_iter_rows[j] / B
            self._util_sum += util
        self._decode_steps += iters_run
        self._decode_tokens += emitted_total
        self._fused_windows += 1
        self._fused_iterations += iters_run
        self._fused_tokens += emitted_total
        self.ledger.account_fused_window(K, iters_run, emitted_total)
        for i, req, _w in rows:
            a = accepted[i]
            self.ledger.account_decode(a, 0, tenant_id=req.tenant_id)
            prev_high = getattr(req, '_computed_high', 0)
            req._computed_high = max(prev_high, req.context_len - 1)
            # hand back the reserved-but-unused tail (early eos or a
            # budget cut), as the speculative rollback does
            self.pool.trim(req.id, req.context_len)
            self.pool.register_prefix(req.id, req.tokens,
                                      req.context_len - 1,
                                      owner=req.tenant_id)
            self._trace(req, 'fused_decode', k=K, accepted=a,
                        tokens_generated=len(req.generated),
                        seq_len=req.context_len,
                        pages=len(self.pool.page_table(req.id)))
            if req.done:
                self._retire(req)
        self._fused_last = {'k': K, 'iters': iters_run,
                            'rows': per_iter_rows[:iters_run]}
        return len(rows), emitted_total

    def _fused_steps(self, K, meta):
        """K iterations of the [B, 1] decode step with the carry on the
        card (engine.py:1320 `_build_fused_step`): each is exactly the
        serial step — same forward, positions and draw — and a row that
        hits eos or its budget turns done and rides the rest with q_len
        0, its K/V writes sent to the pool's sink page. Returns the
        [B, K] chosen ids on the device; nothing here waits for it."""
        dev = self.device
        B = meta['tokens'].shape[0]
        max_pos = self.model.config.max_seq_len - 1
        on_dev = {k: torch.from_numpy(v).to(dev) for k, v in meta.items()}
        tok = on_dev['tokens']
        seq = on_dev['seq_lens']
        done = ~on_dev['live']
        emitted = torch.zeros(B, dtype=torch.int32, device=dev)
        rems, eos_ids = on_dev['rems'], on_dev['eos_ids']
        sample = bool((meta['top_ks'] > 0).any())
        w = self._head()
        ys = []
        for _ in range(K):
            q = (~done).to(torch.int32)
            pos = (seq - q).clamp(0, max_pos)[:, None]
            h, _ = self.model.gpt.forward_paged(
                tok[:, None], pos, self.pool.kv, on_dev['page_tables'], seq, q)
            logits = torch.matmul(h[:, 0].float(), w.t())
            if sample:
                nxt = _device_sample(logits, self.config.seed,
                                     on_dev['ords'], seq.long(),
                                     on_dev['temps'], on_dev['top_ks'])
            else:
                nxt = torch.argmax(logits, dim=-1)
            # the emitted token counts before the eos/budget check
            # (append-then-check), as the serial path
            emitted = emitted + q
            done = done | ((eos_ids >= 0) & (nxt == eos_ids)) \
                | (emitted >= rems)
            tok = torch.where(q.bool(), nxt, tok)
            seq = seq + q
            ys.append(nxt)
        return torch.stack(ys, 1)

    # -- request end ---------------------------------------------------------
    def _retire(self, req):
        self.pool.release(req.id)
        self.scheduler.retire(req)
        self._completed += 1
        if req.tenant_id is not None:
            self._tstat(req.tenant_id)['completed'] += 1
        self._observe_slo(req)
        self._trace(req, 'retire', t=req.finish_time,
                    tokens_generated=len(req.generated),
                    preemptions=req.preemptions)

    def abort(self, req, reason='aborted'):
        """Drop a request wherever it sits: pages released, slot or queue
        entry cleared, journal closed with an `abort` event. False (and
        nothing done) for a request already retired or aborted."""
        if not self.scheduler.abort(req):
            return False
        self.pool.release(req.id)
        self._aborted += 1
        if req.tenant_id is not None:
            self._tstat(req.tenant_id)['aborted'] += 1
        self._observe_slo(req)
        self._trace(req, 'abort', t=req.finish_time, reason=reason,
                    tokens_generated=len(req.generated),
                    preemptions=req.preemptions)
        return True

    def _observe_slo(self, req):
        """Queue the request's SLO samples (queue-wait, TPOT, e2e,
        preemptions; per tenant too) for the next histogram publish, and
        record a deadline_miss when it finished past its own
        deadline."""
        slo = self._new_slo
        qw = e2e = None
        if req.submit_time is not None and req.admit_time is not None:
            qw = req.admit_time - req.submit_time
            slo['queue_wait_s'].append(qw)
        if (req.first_token_time is not None
                and req.finish_time is not None
                and len(req.generated) > 1):
            slo['tpot_s'].append(
                (req.finish_time - req.first_token_time)
                / (len(req.generated) - 1))
        if req.submit_time is not None and req.finish_time is not None:
            e2e = req.finish_time - req.submit_time
            slo['e2e_s'].append(e2e)
        slo['preemptions'].append(req.preemptions)
        if req.tenant_id is not None:
            ts = self._new_tenant_slo.setdefault(
                req.tenant_id, {'queue_wait_s': [], 'e2e_s': []})
            if qw is not None:
                ts['queue_wait_s'].append(qw)
            if e2e is not None:
                ts['e2e_s'].append(e2e)
        if (req.deadline_s is not None and e2e is not None
                and e2e > req.deadline_s):
            self._deadline_misses += 1
            if req.tenant_id is not None:
                self._tstat(req.tenant_id)['deadline_misses'] += 1
            self._trace(req, 'deadline_miss', t=req.finish_time,
                        e2e_s=e2e, deadline_s=req.deadline_s)

    # -- stalled-request watchdog --------------------------------------------
    def _check_stalled(self):
        """A request older than config.request_deadline_s produces a
        serve_report (journal + timeline tail + pool census) once; with
        deadline_action='abort' it is also dropped."""
        deadline = self.config.request_deadline_s
        if not deadline:
            return
        now = self._clock()
        stalled = [r for r in (list(self.scheduler.waiting)
                               + [s for s in self.scheduler.slots
                                  if s is not None])
                   if r.submit_time is not None
                   and now - r.submit_time > deadline
                   and r.id not in self._stall_reported]
        for req in stalled:
            self._stall_reported.add(req.id)
            self.last_serve_report = self._build_report(
                req, age_s=now - req.submit_time)
            self.last_serve_report['path'] = write_serve_report(
                self.last_serve_report, self.config.report_dir)
            if self.config.deadline_action == 'abort':
                self.abort(req, reason='deadline_exceeded')

    def _build_report(self, req, age_s):
        events = (self.tracer.events(req.id)
                  if self.tracer is not None else [])
        return build_serve_report(
            reason=f'request exceeded deadline '
                   f'({self.config.request_deadline_s}s)',
            request_summary={
                'req': req.id, 'state': req.state, 'age_s': age_s,
                'deadline_s': self.config.request_deadline_s,
                'prompt_tokens': len(req.prompt),
                'tokens_generated': len(req.generated),
                'preemptions': req.preemptions,
            },
            trace_events=events,
            timeline_tail=self.timeline.tail(32),
            pool_stats=self.pool.stats(),
            pool_census=self.pool.census(),
            engine_stats={
                'in_flight': len(self.scheduler.running()),
                'waiting': len(self.scheduler.waiting),
                'submitted': self._submitted,
                'completed': self._completed,
                'aborted': self._aborted,
            })

    # -- stats / metrics -----------------------------------------------------
    def reset_stats(self):
        """Zero the rate/occupancy accounting and the trace, timeline and
        ledger (not the pool or queue) — call after warm-up so steady-
        state numbers exclude it."""
        self._decode_time = 0.0
        self._decode_tokens = 0
        self._decode_steps = 0
        self._prefill_time = 0.0
        self._occupancy_sum = 0.0
        self._util_sum = 0.0
        self._prefill_tokens = 0
        self._prefill_chunks = 0
        self.prefill_fetches = 0     # prefills completed with a sample
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_steps = 0
        self._fused_windows = 0
        self._fused_iterations = 0
        self._fused_tokens = 0
        self._ttfts_s = []
        self._new_ttfts_s = []
        for v in self._new_slo.values():
            v.clear()
        for d in self._new_tenant_slo.values():
            for v in d.values():
                v.clear()
        if self.tracer is not None:
            self.tracer.reset()
        self.timeline.reset()
        self.ledger.reset()
        self._gap.reset()

    def stats(self):
        steps = max(self._decode_steps, 1)
        ttft = np.asarray(self._ttfts_s) * 1000.0
        return {
            'device': str(self.device),
            'decode_tokens_per_sec': self.decode_rate(),
            'ttft_ms_mean': float(ttft.mean()) if ttft.size else None,
            'ttft_ms_p50':
                float(np.percentile(ttft, 50)) if ttft.size else None,
            'ttft_ms_p99':
                float(np.percentile(ttft, 99)) if ttft.size else None,
            'batch_occupancy': self._occupancy_sum / steps,
            'kv_page_utilization': self._util_sum / steps,
            'slots': self.config.max_batch_size,
            'in_flight': len(self.scheduler.running()),
            'waiting': len(self.scheduler.waiting),
            'pool': self.pool.stats(),
            'requests_submitted_total': self._submitted,
            'requests_completed_total': self._completed,
            'requests_aborted_total': self._aborted,
            'preemptions_total': self.scheduler.preemptions,
            'decode_steps_total': self._decode_steps,
            'decode_tokens_total': self._decode_tokens,
            'decode_seconds_total': self._decode_time,
            'prefill_tokens_total': self._prefill_tokens,
            'prefill_chunks_total': self._prefill_chunks,
            'prefill_seconds_total': self._prefill_time,
            'weight_dtype': (str(self.config.weight_dtype)
                             if self.config.weight_dtype else None),
            'quantized_params': len(self._qweights),
            'prefix_cache': self.pool.prefix_cache,
            'prefix_hits_total': self.pool.prefix_hits,
            'prefix_misses_total': self.pool.prefix_misses,
            'prefix_hit_tokens_total': self.pool.prefix_hit_tokens,
            'prefix_shared_pages': self.pool.shared_pages,
            'prefix_cached_pages': self.pool.cached_pages,
            'prefix_evictions_total': self.pool.prefix_evictions,
            'spec_k': self.config.spec_k,
            'spec_proposed_tokens_total': self._spec_proposed,
            'spec_accepted_tokens_total': self._spec_accepted,
            'spec_steps_total': self._spec_steps,
            'spec_acceptance_rate':
                (self._spec_accepted / self._spec_proposed
                 if self._spec_proposed else None),
            'fused_k': self.config.fused_k,
            'fused_windows_total': self._fused_windows,
            'fused_iterations_total': self._fused_iterations,
            'fused_tokens_total': self._fused_tokens,
            'quota_deferrals_total': self._quota_deferrals,
            'preemptions_charged_total': self._preemptions_charged,
            'deadline_rejects_total': self._deadline_rejects,
            'deadline_misses_total': self._deadline_misses,
            'degrade_stage': self.degrade_stage(),
            'tenancy': self._tenancy_stats(),
        }

    def _tenancy_stats(self):
        """Per-tenant lifetime view: policy (priority, quota, weight),
        live bucket level and the accounting rows."""
        out = {
            'enabled': self._tenants is not None,
            'degrade_enabled': self._ladder is not None,
            'degrade_stage': self.degrade_stage(),
            'pressure': (round(self._ladder.pressure(), 4)
                         if self._ladder is not None else 0.0),
            'stage_transitions': (self._ladder.transitions
                                  if self._ladder is not None else 0),
            'tenants': {},
        }
        tids = set(self._tenant_stats)
        if self._tenants is not None:
            tids.update(self._tenants.tenants())
        for tid in sorted(tids):
            row = dict(self._tenant_stats.get(tid) or self._blank_tstat())
            if self._tenants is not None:
                pol = self._tenants.policy(tid)
                if pol is not None:
                    row['priority'] = pol['priority']
                    row['quota_tokens_per_s'] = pol['quota_tokens_per_s']
                    row['weight'] = pol['weight']
                bucket = self._tenants.bucket(tid)
                if bucket is not None:
                    row['bucket_level'] = round(bucket.level, 3)
            out['tenants'][tid] = row
        return out

    def publish_metrics(self):
        s = self.stats()
        s['_new_ttfts_s'] = list(self._new_ttfts_s)
        self._new_ttfts_s.clear()
        s['_new_slo'] = {k: list(v) for k, v in self._new_slo.items()}
        for v in self._new_slo.values():
            v.clear()
        s['_new_tenant_slo'] = {t: {k: list(v) for k, v in d.items()}
                                for t, d in self._new_tenant_slo.items()}
        for d in self._new_tenant_slo.values():
            for v in d.values():
                v.clear()
        s['timeline'] = self.timeline.summary()
        # read the engine clock here as the reference does, so a ticking
        # test clock gives both engines the same journal timestamps
        self._last_publish = self._clock()
        self._last_publish_wall = _monitor._time_fn()
        _metrics.publish(s)
        self.ledger.publish()
        self._gap.publish()

    def request_table(self):
        """Per-request SLO reconstruction from the journals
        (request_trace.reconstruct) — empty when tracing is off."""
        return self.tracer.request_table() if self.tracer else {}

    def export_trace(self, jsonl_path=None, chrome_path=None):
        """Export the request journals: JSON-lines (schema header + one
        event per line) and/or chrome-trace. The chrome export folds in
        the serve::* spans in the port profiler's buffer, so requests
        render as tracks next to the engine steps that served them."""
        if self.tracer is None:
            raise RuntimeError("tracing is off — build the engine with "
                               "ServingConfig(trace=True)")
        out = {}
        if jsonl_path:
            out['jsonl'] = self.tracer.export_jsonl(jsonl_path)
        if chrome_path:
            from .. import profiler as _prof
            spans = [s for s in _prof._buffer.snapshot()
                     if s.get('cat') == 'serve']
            out['chrome'] = self.tracer.export_chrome_tracing(
                chrome_path, extra_spans=spans)
        return out

    def shutdown(self):
        """Drain and drop the host tier, drop the pool's device pages and
        the int8 weights, and unregister the gap monitor and the ledger
        so a dead engine stops reporting."""
        if self._host_tier is not None:
            self._host_tier.shutdown()
        self.pool.drop_arrays()
        self._qweights = {}
        unregister_monitor(self._gap)
        self.ledger.unregister()
        return {'released': True}


def _dequantize_hook(attr, q, s, dtype):
    """Forward pre-hook: the module's weight becomes its dequantized
    int8 copy for this call."""
    def hook(mod, _args):
        mod._parameters[attr] = dequantize_weight(q, s, dtype)
    return hook


def _restore_hook(attr, param):
    """Forward hook: the module's own weight back, the copy dropped."""
    def hook(mod, _args, _out):
        mod._parameters[attr] = param
    return hook


def _ngram_propose(tokens, ngram, k):
    """Prompt-lookup draft proposer (engine.py:2147): find the most
    recent earlier occurrence of the context's trailing n-gram and
    propose the up-to-k tokens that followed it, backing off to shorter
    n-grams; [] when nothing matches. Host work on the token list."""
    L = len(tokens)
    if k <= 0 or L < 2:
        return []
    for n in range(min(int(ngram), L - 1), 0, -1):
        # the rightmost candidate ends one short of the trailing gram,
        # so the continuation (which may overlap the suffix: that is how
        # repetition loops propose) is never empty
        first = tokens[L - n]
        for j in range(L - n - 1, -1, -1):
            if tokens[j] != first:
                continue
            if all(tokens[j + t] == tokens[L - n + t] for t in range(1, n)):
                return [int(t) for t in tokens[j + n:j + n + k]]
    return []


def _ord_of(req):
    """The request's sampling ordinal: the engine-local one submit
    assigned, else (a request injected past submit) its global id."""
    o = req.sample_ord
    return int(o if o is not None else req.id)


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix32(x):
    """A 32-bit integer finalizer (xorshift-multiply) on int64 tensors
    holding values in [0, 2^32): every product stays below 2^63, so the
    int64 arithmetic is exact on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def sample_uniforms(seed, ords, positions, V):
    """[B, V] uniforms on (0, 1), a pure function of (seed, ords[b],
    positions[b], vocab index): counter-based, 24 bits each, exact in
    fp32, bit-identical on the CPU and the card."""
    row = _mix32(torch.full_like(ords, (int(seed) * _GOLDEN + 1) & _M32))
    row = _mix32(row ^ (ords & _M32))
    row = _mix32(row ^ (positions & _M32))[:, None]            # [B, 1]
    idx = torch.arange(V, device=ords.device, dtype=torch.int64)[None]
    h = _mix32((row + idx * _GOLDEN) & _M32)
    h = _mix32(h ^ row)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def top_k_mask(logits, temps, top_ks):
    """(kth, masked): the temperature-scaled logits with every value
    below the row's k-th largest set to -1e30 — the threshold from a
    full sort, so values tied with it stay in (engine.py:2208-2212)."""
    V = logits.shape[-1]
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    k = top_ks.clamp(1, V)
    srt = torch.sort(scaled, dim=-1).values                   # ascending
    kth = torch.gather(srt, 1, (V - k)[:, None])
    masked = torch.where(scaled < kth, torch.full_like(scaled, -1e30),
                         scaled)
    return kth, masked


def _device_sample(logits, seed, ords, positions, temps, top_ks):
    """Next token per row of fp32 logits [B, V] (engine.py:2184): greedy
    argmax where top_k <= 0; elsewhere the argmax of the top-k-masked,
    temperature-scaled logits plus Gumbel noise from `sample_uniforms`,
    a draw from their softmax. `positions` is the absolute index of the
    token drawn (the rows' seq_lens). No host sync."""
    greedy = torch.argmax(logits, dim=-1)
    _kth, masked = top_k_mask(logits, temps, top_ks)
    u = sample_uniforms(seed, ords, positions, logits.shape[-1])
    sampled = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    return torch.where(top_ks > 0, sampled, greedy)
