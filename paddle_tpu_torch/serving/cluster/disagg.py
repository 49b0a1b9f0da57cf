"""Prefill/decode disaggregation — counterpart of
`paddle_tpu/serving/cluster/disagg.py`.

Two engines over one model, each with its own paged pool:

  * the PREFILL engine runs chunked prefill only: requests are submitted
    here, stream through their prefill chunks and emit their first token
    as on the unified engine;
  * once a request finishes prefill (state RUNNING) its KV pages are
    STREAMED into the decode pool (page_stream.py: a gather and a
    scatter on the page axis, int8 scales with their pages, rows as
    stored) and the request is ADOPTED into a decode slot
    (`ServingEngine.adopt_request`); its prefill-side pages release.

On one card both pools live in the card's memory and the stream is a
device copy. Decode-side prefix sharing still works: pages the decode
pool already holds for a shared prefix are mapped instead of streamed
(only the uncovered tail moves), and streamed pages join the decode
pool's prefix index, so the second request behind a system prompt
streams almost nothing.

Greedy tokens equal one unified ServingEngine's on the same stream. A
preemption on the decode side re-prefills on the decode engine (the
resurrect path), as the reference does.
"""
import inspect
import math
import time

from ...core import monitor as _m
from ..engine import ServingConfig, ServingEngine
from ..kv_pool import PoolExhausted
from ..scheduler import AdmissionRejected, RequestState
from .page_stream import stream_kv_pages


def build_engine(model, config=None, device=None, **cfg_kw):
    """ServingEngine, or DisaggregatedEngine when config.disaggregate:
    the one constructor replicas use."""
    if config is None:
        config = ServingConfig(**cfg_kw)
    elif cfg_kw:
        raise ValueError("pass either config or knobs, not both")
    if config.disaggregate:
        return DisaggregatedEngine(model, config, device=device)
    return ServingEngine(model, config, device=device)


class DisaggregatedEngine:
    """An engine facade: submit/step/generate/abort/stats/... as on
    ServingEngine, prefill work on the prefill engine and decode work on
    the decode engine, both on `device` (the card unless the caller
    passes device='cpu')."""

    def __init__(self, model, config=None, device=None, **cfg_kw):
        if config is None:
            config = ServingConfig(**cfg_kw)
        elif cfg_kw:
            raise ValueError("pass either config or knobs, not both")
        self.model = model
        self.config = config
        self.decode = ServingEngine(
            model, _variant(config, disaggregate=False), device=device)
        self.device = self.decode.device
        # the prefill side: its own smaller slot table and pool, trace off
        # at build, then the decode engine's tracer and clock, so a
        # request's journal is one stream across the handoff. Its own
        # ledger site: registries are latest-wins per site, and both
        # engines live in this process
        pcfg = _variant(config, disaggregate=False,
                        max_batch_size=config.prefill_slots, trace=False,
                        clock=self.decode._clock)
        self.prefill = ServingEngine(model, pcfg, device=self.device,
                                     ledger_site='serve_prefill')
        self.prefill.tracer = self.decode.tracer
        # the facade gates deadlines over both backlogs (submit below);
        # the prefill engine's own estimate sees neither
        self.prefill.deadline_admission = False
        # ONE ladder for the pipeline: both engines feed it and read one
        # stage; stage-3 weighted eviction arms on both pools whichever
        # engine observes the transition
        if self.decode._ladder is not None:
            self.prefill._ladder = self.decode._ladder
            self.decode._stage3_pools = (self.prefill.pool,)
            self.prefill._stage3_pools = (self.decode.pool,)

        # one publisher: the ptpu_serve_* gauges follow the decode engine;
        # the prefill side's pending samples (TTFT is stamped in prefill)
        # move into the decode engine's buffers
        def _forward_publish(eng=self.prefill):
            self.decode._new_ttfts_s.extend(eng._new_ttfts_s)
            eng._new_ttfts_s.clear()
            for k, v in eng._new_slo.items():
                self.decode._new_slo[k].extend(v)
                v.clear()
            for tid, d in eng._new_tenant_slo.items():
                dst = self.decode._new_tenant_slo.setdefault(
                    tid, {'queue_wait_s': [], 'e2e_s': []})
                for k, v in d.items():
                    dst[k].extend(v)
                    v.clear()
            eng._last_publish = eng._clock()
            eng._last_publish_wall = _m._time_fn()
        self.prefill.publish_metrics = _forward_publish
        self._pending = []          # prefilled, waiting for a decode slot
        self._handoffs = 0
        self._streamed_pages = 0

    # -- engine surface ------------------------------------------------------
    @property
    def pool(self):
        return self.decode.pool

    @property
    def timeline(self):
        return self.decode.timeline

    @property
    def tracer(self):
        return self.decode.tracer

    @property
    def scheduler(self):
        # occupancy views read the decode side; the queue lives on the
        # prefill side (has_work, waiting_requests)
        return self.decode.scheduler

    @property
    def has_work(self):
        return (self.prefill.scheduler.has_work or bool(self._pending)
                or self.decode.scheduler.has_work)

    def waiting_requests(self):
        return list(self.prefill.scheduler.waiting)

    def live_requests(self):
        return ([r for r in self.prefill.scheduler.slots if r is not None]
                + list(self._pending)
                + [r for r in self.decode.scheduler.slots if r is not None])

    def submit(self, prompt_ids, **kw):
        # deadline-aware admission over the WHOLE pipeline: both backlogs
        # at the decode engine's observed rate; the prefill engine's own
        # check is off, so this is the one gate
        deadline = kw.get('deadline_s')
        if deadline is not None:
            rate = self.decode.decode_rate()
            if rate > 0.0:
                bill = len(prompt_ids) + int(kw.get('max_new_tokens', 32))
                est = (self.prefill.pending_tokens()
                       + self.decode.pending_tokens() + bill) / rate
                if est > deadline:
                    self.decode._deadline_rejects += 1
                    tid = kw.get('tenant_id')
                    if tid is not None:
                        self.decode._tstat(tid)['deadline_rejects'] += 1
                    raise AdmissionRejected(
                        'deadline_unmet', retry_after_s=est - deadline,
                        estimated_s=est, deadline_s=deadline)
        return self.prefill.submit(prompt_ids, **kw)

    def step(self):
        """One iteration: a prefill sweep, the handoff scan, then a
        decode sweep."""
        if self.prefill.scheduler.has_work:
            self.prefill.step()
        for req in list(self.prefill.scheduler.slots):
            if req is not None and req.state == RequestState.RUNNING:
                self._handoff(req)
        while self._pending:
            if not self.decode.adopt_request(self._pending[0]):
                break
            self._pending.pop(0)
        if self.decode.scheduler.has_work:
            self.decode.step()

    def _handoff(self, req):
        """Stream req's prefilled pages into the decode pool and queue it
        for adoption. Decode-resident shared-prefix pages are mapped, not
        streamed: only the uncovered tail moves."""
        src_pool, dst_pool = self.prefill.pool, self.decode.pool
        L = len(req.prompt)
        src_pages = src_pool.page_table(req.id)
        cached = dst_pool.match_and_map(req.id, req.tokens, limit=L)
        n_cached = cached // src_pool.page_size
        # decode-pool pressure preempts decode-side victims as a local
        # allocation would. When no victim exists (with tenants every
        # decode resident may outrank req) the handoff is DEFERRED: req
        # keeps its prefill slot and pages and the next sweep retries.
        # An empty decode slot table will never free pages: that
        # too-big case still raises
        try:
            self.decode._ensure_or_preempt(req, L)
        except PoolExhausted:
            if not any(r is not None for r in self.decode.scheduler.slots):
                raise
            dst_pool.release(req.id)    # drop the mapped or partial pages
            return
        dst_pages = dst_pool.page_table(req.id)
        n = min(len(src_pages), len(dst_pages))
        if n > n_cached:
            t0 = time.perf_counter()
            dst_pool.kv = stream_kv_pages(
                src_pool.kv, dst_pool.kv, src_pages[n_cached:n],
                dst_pages[n_cached:n],
                chunk_pages=self.config.stream_chunk_pages)
            # the handoff runs between the two sweeps, so the stream's wall
            # lands in the decode engine's next iteration as page_stream
            self.decode.ledger.note_page_stream(time.perf_counter() - t0)
            self._streamed_pages += n - n_cached
        # release the prefill side WITHOUT retiring: the request lives on
        # and its journal continues on the decode engine
        i = self.prefill.scheduler.slot_of(req)
        self.prefill.scheduler.slots[i] = None
        src_pool.release(req.id)
        self._handoffs += 1
        _m.counter('ptpu_serve_pd_handoffs_total',
                   help='prefill->decode request handoffs '
                        '(lifetime)').inc()
        self._pending.append(req)

    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 temperature=1.0, top_k=0, max_steps=None):
        reqs = [self.submit(p, max_new_tokens=max_new_tokens,
                            eos_token_id=eos_token_id,
                            temperature=temperature, top_k=top_k)
                for p in prompts]
        guard = max_steps or 16 * (max_new_tokens + 4) * max(
            1, math.ceil(len(reqs) / self.config.max_batch_size))
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > guard:
                raise RuntimeError(
                    f"disaggregated loop did not drain in {guard} steps")
        return [r.output_ids() for r in reqs]

    def abort(self, req, reason='aborted'):
        if req in self._pending:
            self._pending.remove(req)
            return self.decode.abort(req, reason=reason)
        if req in self.prefill.scheduler.waiting \
                or req in self.prefill.scheduler.slots:
            return self.prefill.abort(req, reason=reason)
        return self.decode.abort(req, reason=reason)

    def stats(self):
        s = self.decode.stats()
        ps = self.prefill.stats()
        s['pd_disaggregated'] = True
        s['pd_handoffs_total'] = self._handoffs
        s['pd_streamed_pages_total'] = self._streamed_pages
        s['pd_pending'] = len(self._pending)
        # prefill work happens on the other engine: surface its side
        s['prefill_tokens_total'] = ps['prefill_tokens_total']
        s['prefill_chunks_total'] = ps['prefill_chunks_total']
        s['prefix_hits_total'] += ps['prefix_hits_total']
        s['prefix_misses_total'] += ps['prefix_misses_total']
        s['prefix_hit_tokens_total'] += ps['prefix_hit_tokens_total']
        # tenancy accounting happens where admission runs (the prefill
        # engine); decode-side rows carry the handoffs' charged
        # preemptions. Both merge
        for key in ('quota_deferrals_total', 'preemptions_charged_total',
                    'deadline_rejects_total', 'deadline_misses_total'):
            s[key] += ps[key]
        for tid, row in ps['tenancy'].get('tenants', {}).items():
            dst = s['tenancy']['tenants'].setdefault(tid, {})
            for k, v in row.items():
                if k in ServingEngine._blank_tstat():
                    dst[k] = dst.get(k, 0) + v
                else:
                    dst.setdefault(k, v)
        s['pd_prefill_pool'] = {
            'pages_in_use': ps['pool']['pages_in_use'],
            'high_water': ps['pool']['high_water'],
            'num_pages': ps['pool']['num_pages'],
        }
        return s

    def request_table(self):
        return self.decode.request_table()

    def publish_metrics(self):
        self.decode.publish_metrics()

    def reset_stats(self):
        self.prefill.reset_stats()
        self.decode.reset_stats()

    def export_trace(self, jsonl_path=None, chrome_path=None):
        return self.decode.export_trace(jsonl_path=jsonl_path,
                                        chrome_path=chrome_path)

    def shutdown(self):
        self.prefill.shutdown()
        return self.decode.shutdown()


def _variant(config, **overrides):
    """A copy of a ServingConfig with overrides, rebuilt through
    __init__ so validation runs."""
    kw = {name: getattr(config, name)
          for name, p in inspect.signature(ServingConfig.__init__)
          .parameters.items()
          if name != 'self' and p.kind is not p.VAR_KEYWORD}
    kw.update(overrides)
    return ServingConfig(**kw)
