"""Per-request lifecycle tracing for the serving engine — counterpart of
`paddle_tpu/serving/request_trace.py`.

Answers "why was THIS request slow": every request carries a capped
event journal — submit / admit / prefill_chunk / first_token / decode
(per-iteration participation) / preempt / resume / retire / abort — with
timestamps from the engine's clock and the request's page-table size at
the time. All of it is host bookkeeping on data the scheduler already
holds: tracing adds no device work and no host sync (held by
tests/test_torch_serving_trace.py).

Exports:

  * JSON-lines (`RequestTracer.export_jsonl`) — one event per line,
    schema header first; `load_trace()` reads it back and `reconstruct()`
    derives the per-request SLO table (queue-wait, TTFT, TPOT, e2e,
    preemptions, pages high-water, delivered and wasted tokens);
  * chrome-trace (`RequestTracer.export_chrome_tracing`) through the
    port's profiler writer — each request renders as its own track next
    to the engine's serve::* spans.

The stalled-request watchdog (engine.py) snapshots a request's journal,
the scheduler-timeline tail and a pool census into a structured
`serve_report` JSON artifact (`build_serve_report`, `write_serve_report`);
`render_serve_report()` renders it for a reader. The schema names and
event vocabulary are the JAX package's, so traces from either package
load in the other.
"""
import collections
import json
import os
import threading
import time

from ..distributed.fleet.utils.log_util import log_json

SCHEMA = 'paddle_tpu.serve_trace/6'
# older files still load — load_trace accepts /1 (no route events),
# /2 (no tenancy/degradation events), /3 (no goodput pricing), /4
# (no fused decode), /5 (no host tier) and /6
SCHEMAS = ('paddle_tpu.serve_trace/1', 'paddle_tpu.serve_trace/2',
           'paddle_tpu.serve_trace/3', 'paddle_tpu.serve_trace/4',
           'paddle_tpu.serve_trace/5',
           SCHEMA)

# lifecycle event vocabulary. prefix_hit = cached pages mapped at
# prefill start; spec_verify = one speculative verify outcome; route =
# a cluster placement (kept for schema compatibility). submit carries
# tenant_id/priority/deadline_s; quota_defer marks a quota-deferred
# admission episode, deadline_miss a finish past the request's own
# deadline, and degrade_stage — recorded under the engine-scope
# pseudo-request ENGINE_REQ — a degradation-ladder transition.
# prefill_chunk carries `recompute_tokens` when the chunk re-derives
# positions a preemption destroyed and `sampled` when it completes
# prefill and samples a token off its final column; spec_verify carries
# `discarded` for the accepted-but-dropped burst tail. fused_decode is
# one per request per fused window (`k`, `accepted`). The host-tier
# pair: `spill` under ENGINE_REQ, one per engine step that moved pages
# to the host (`pages`, `host_used_pages`), and `resurrect`, a
# per-request event at prefill start when a prefix match fetched
# host-tier pages back instead of re-running prefill (`pages`,
# `tokens`).
EVENTS = ('submit', 'route', 'admit', 'prefix_hit', 'prefill_chunk',
          'first_token', 'decode', 'fused_decode', 'spec_verify',
          'preempt', 'resume',
          'quota_defer', 'deadline_miss', 'degrade_stage',
          'spill', 'resurrect',
          'retire', 'abort')

# engine-scope events (ladder transitions) journal under this pseudo
# request id: they export/load like any event but reconstruct() skips
# negative ids — they describe the ENGINE's state, not a request's
ENGINE_REQ = -1

# chrome-trace: request tracks live on a 'serving requests'
# pseudo-process (one virtual thread per request) beside the host
# process's engine spans — same timeline, clearly grouped
_TRACK_PID = 1 << 22
_TRACK_PNAME = 'serving requests'
_TRACK_TID_BASE = 1 << 24


class RequestTrace:
    """Capped per-request event journal. Events beyond `cap` are
    counted in `dropped` instead of appended — a runaway decode can't
    grow host memory without bound."""

    __slots__ = ('req_id', 'events', 'cap', 'dropped')

    def __init__(self, req_id, cap=512):
        self.req_id = req_id
        self.events = []
        self.cap = max(1, int(cap))   # room for the terminal event
        self.dropped = 0

    def add(self, event, t, **fields):
        if len(self.events) >= self.cap:
            if event in ('retire', 'abort'):
                # the terminal event is load-bearing (end state, e2e,
                # authoritative token count) — evict the newest
                # interior event instead of dropping the end of life
                if self.events:
                    self.events.pop()
                    self.dropped += 1
            else:
                self.dropped += 1
                return
        e = {'req': self.req_id, 'event': event, 't': float(t)}
        if fields:
            e.update(fields)
        self.events.append(e)


class RequestTracer:
    """Journal registry: live requests plus a ring of the most recently
    retired ones (`capacity_requests`), so a long-lived engine's trace
    memory is bounded. `clock` is injectable for deterministic tests —
    the engine shares ONE clock between tracer, scheduler and SLO
    accounting so cross-source timestamps compare exactly."""

    def __init__(self, capacity_requests=512, events_per_request=512,
                 clock=None):
        self.capacity_requests = int(capacity_requests)
        self.events_per_request = int(events_per_request)
        self.clock = clock or time.perf_counter
        self._live = {}                        # req_id -> RequestTrace
        self._done = collections.deque(maxlen=self.capacity_requests)
        self._lock = threading.Lock()
        self.dropped_requests = 0

    # -- recording -----------------------------------------------------------
    def record(self, req_id, event, t=None, **fields):
        """Append an event; pass `t` when the caller already stamped
        the moment (engine submit/first-token/finish times) so the
        journal's timestamp is bit-identical to the engine's — the
        reconstruction-equals-engine tests rely on it."""
        if t is None:
            t = self.clock()
        with self._lock:
            tr = self._live.get(req_id)
            if tr is None:
                tr = self._live[req_id] = RequestTrace(
                    req_id, cap=self.events_per_request)
            tr.add(event, t, **fields)
            if event in ('retire', 'abort'):
                self._live.pop(req_id, None)
                if len(self._done) == self._done.maxlen:
                    self.dropped_requests += 1
                self._done.append(tr)
        return t

    def reset(self):
        with self._lock:
            self._live.clear()
            self._done.clear()
            self.dropped_requests = 0

    # -- reading -------------------------------------------------------------
    def traces(self):
        """Every journal (retired ring first, then live), oldest first."""
        with self._lock:
            return list(self._done) + list(self._live.values())

    def events(self, req_id=None):
        out = []
        for tr in self.traces():
            if req_id is None or tr.req_id == req_id:
                out.extend(tr.events)
        out.sort(key=lambda e: e['t'])
        return out

    def request_table(self):
        return reconstruct(self.events())

    # -- exporters -----------------------------------------------------------
    def export_jsonl(self, path):
        """JSON-lines: a schema header line, then one event per line in
        timestamp order."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        dropped = sum(tr.dropped for tr in self.traces())
        with open(path, 'w') as f:
            f.write(json.dumps({'schema': SCHEMA,
                                'dropped_events': dropped,
                                'dropped_requests':
                                    self.dropped_requests}) + '\n')
            for e in self.events():
                f.write(json.dumps(e) + '\n')
        return path

    def chrome_spans(self):
        """Profiler-internal span dicts (one virtual thread per
        request): lifecycle segments between consecutive events —
        queued / prefill / decode / preempted — plus zero-duration
        markers for first_token and retire/abort. Feed them to
        profiler's chrome writer next to the engine's serve::* spans."""
        spans = []
        for tr in self.traces():
            tid = _TRACK_TID_BASE + (tr.req_id if tr.req_id >= 0
                                     else (1 << 23))
            tname = (f'req {tr.req_id}' if tr.req_id >= 0
                     else 'engine (degradation ladder)')
            evs = tr.events
            for i, e in enumerate(evs):
                t_us = int(e['t'] * 1e6)
                nxt_us = (int(evs[i + 1]['t'] * 1e6)
                          if i + 1 < len(evs) else t_us)
                ev, seg = e['event'], None
                if ev in ('submit', 'preempt'):
                    seg = 'queued' if ev == 'submit' else 'preempted'
                elif ev in ('admit', 'resume'):
                    seg = 'prefill'
                elif ev in ('prefill_chunk', 'first_token', 'decode'):
                    seg = ev
                if seg is not None and nxt_us > t_us:
                    spans.append({
                        'name': f'{tr.req_id}:{seg}',
                        'cat': 'serve_request', 'ts': t_us,
                        'dur': nxt_us - t_us, 'tid': tid, 'tname': tname,
                        'pid': _TRACK_PID, 'pname': _TRACK_PNAME,
                        'args': {k: v for k, v in e.items()
                                 if k not in ('t',)}})
                if ev in ('first_token', 'retire', 'abort',
                          'quota_defer', 'deadline_miss',
                          'degrade_stage'):
                    spans.append({
                        'name': f'{tr.req_id}:{ev}',
                        'cat': 'serve_request', 'ts': t_us, 'dur': 0,
                        'tid': tid, 'tname': tname,
                        'pid': _TRACK_PID, 'pname': _TRACK_PNAME,
                        'args': {k: v for k, v in e.items()
                                 if k not in ('t',)}})
        return spans

    def export_chrome_tracing(self, path, extra_spans=None):
        """Chrome-trace export through the port profiler's writer; pass
        the profiler span buffer (engine serve::* phases) as
        `extra_spans` to see requests as tracks next to engine steps."""
        from .. import profiler as _prof
        spans = self.chrome_spans() + list(extra_spans or ())
        return _prof._write_chrome_trace(
            path, spans, metadata={'schema': SCHEMA})


# ---------------------------------------------------------------------------
# reconstruction — trace events -> per-request SLO table
# ---------------------------------------------------------------------------
def reconstruct(events):
    """Derive the per-request lifecycle summary from a flat event list
    (live tracer or a loaded JSON-lines file). Returns {req_id: {...}}
    with queue_wait_s / ttft_s / tpot_s / e2e_s, token counts,
    preemptions, prefill chunks, decode steps, pages high-water —
    exactly the numbers the engine reports, re-derived from the journal
    (the equivalence is asserted in tests)."""
    out = {}
    for e in sorted(events, key=lambda x: x['t']):
        if isinstance(e['req'], int) and e['req'] < 0:
            continue        # engine-scope event (degrade_stage) — not
                            # a request lifecycle; see ENGINE_REQ
        r = out.setdefault(e['req'], {
            'req': e['req'], 'submit_t': None, 'admit_t': None,
            'first_token_t': None, 'end_t': None, 'state': None,
            'prompt_tokens': None, 'tokens_generated': 0,
            'preemptions': 0, 'prefill_chunks': 0, 'decode_steps': 0,
            'pages_high_water': 0, 'last_token_t': None,
            'prefix_cached_tokens': 0, 'spec_proposed': 0,
            'spec_accepted': 0, 'replica_id': None,
            'router_decision': None,
            # schema v3 tenancy/degradation columns: v1/v2
            # traces simply leave the defaults
            'tenant_id': None, 'priority': 0, 'deadline_s': None,
            'quota_defers': 0, 'deadline_miss': False,
            # schema v4 goodput pricing: computed prefill
            # positions, preempt-destroyed recompute, and the verify
            # columns that never reached the request — older traces
            # leave zeros and the derived columns degrade gracefully
            'prefill_tokens_computed': 0, 'recompute_tokens': 0,
            'spec_discarded': 0, 'prefill_samples': 0,
            # schema v5 fused decode: windows this request
            # rode and tokens it took from them — older traces leave
            # zeros (no fused engine existed to emit them)
            'fused_windows': 0, 'fused_tokens': 0,
            # schema v6 host tier: prefix pages this
            # request resurrected from host RAM instead of
            # re-prefilling, and the prompt tokens those pages carried
            # — older traces leave zeros (no tier existed)
            'resurrected_pages': 0, 'resurrected_tokens': 0,
        })
        ev, t = e['event'], e['t']
        # `pages` on a resurrect event counts pages FETCHED, not the
        # request's page-table size — keep it out of the high-water
        if 'pages' in e and e['event'] != 'resurrect':
            r['pages_high_water'] = max(r['pages_high_water'],
                                        int(e['pages']))
        if ev == 'submit':
            r['submit_t'] = t
            r['prompt_tokens'] = e.get('prompt_tokens')
            r['tenant_id'] = e.get('tenant_id')
            r['priority'] = e.get('priority', 0)
            r['deadline_s'] = e.get('deadline_s')
        elif ev == 'route':
            # schema v2: which replica got this request and why; the
            # FIRST placement wins (a drain-resubmit lands in the
            # peer's own trace file under a new request id)
            if r['replica_id'] is None:
                r['replica_id'] = e.get('replica_id')
                r['router_decision'] = e.get('router_decision')
        elif ev == 'admit' and r['admit_t'] is None:
            r['admit_t'] = t
        elif ev == 'resume':
            pass                         # re-admit after preempt
        elif ev == 'prefix_hit':
            # one hit per (re-)prefill start; resumes can hit again on
            # their own released pages, so cached tokens accumulate
            r['prefix_cached_tokens'] += int(e.get('cached_tokens', 0))
        elif ev == 'spec_verify':
            r['spec_proposed'] += int(e.get('proposed', 0))
            r['spec_accepted'] += int(e.get('accepted', 0))
            # v4: accepted-but-dropped burst tail (eos/budget) — with
            # the rejected drafts, the request's spec waste
            r['spec_discarded'] += int(e.get('discarded', 0))
        elif ev == 'prefill_chunk':
            r['prefill_chunks'] += 1
            r['prefill_tokens_computed'] += int(e.get('tokens', 0))
            r['recompute_tokens'] += int(e.get('recompute_tokens', 0))
            r['prefill_samples'] += int(e.get('sampled', 0))
        elif ev == 'first_token':
            r['first_token_t'] = t
            r['tokens_generated'] = max(r['tokens_generated'],
                                        e.get('tokens_generated', 1))
            r['last_token_t'] = t
        elif ev == 'decode':
            r['decode_steps'] += 1
            r['tokens_generated'] = max(r['tokens_generated'],
                                        e.get('tokens_generated',
                                              r['tokens_generated'] + 1))
            r['last_token_t'] = t
        elif ev == 'fused_decode':
            # v5: one event per fused window; `accepted` tokens each
            # stand in for one serial decode step, so the derived
            # decode_steps/TPOT columns stay comparable across
            # fused and serial traces
            acc = int(e.get('accepted', 1))
            r['decode_steps'] += acc
            r['fused_windows'] += 1
            r['fused_tokens'] += acc
            r['tokens_generated'] = max(r['tokens_generated'],
                                        e.get('tokens_generated',
                                              r['tokens_generated']
                                              + acc))
            r['last_token_t'] = t
        elif ev == 'resurrect':
            # v6: prefix pages fetched back from the host tier at
            # prefill start — compute the resurrect replaced
            r['resurrected_pages'] += int(e.get('pages', 0))
            r['resurrected_tokens'] += int(e.get('tokens', 0))
        elif ev == 'quota_defer':
            r['quota_defers'] += 1
        elif ev == 'deadline_miss':
            r['deadline_miss'] = True
        elif ev == 'preempt':
            r['preemptions'] += 1
        elif ev in ('retire', 'abort'):
            r['end_t'] = t
            r['state'] = 'aborted' if ev == 'abort' else 'finished'
            if 'tokens_generated' in e:
                r['tokens_generated'] = e['tokens_generated']
    for r in out.values():
        sub, adm = r['submit_t'], r['admit_t']
        ft, end = r['first_token_t'], r['end_t']
        last = r.pop('last_token_t')
        n = r['tokens_generated']
        r['queue_wait_s'] = (adm - sub) if sub is not None \
            and adm is not None else None
        r['ttft_s'] = (ft - sub) if sub is not None \
            and ft is not None else None
        # the terminal stamp closes the last token interval — the SAME
        # formula engine._observe_slo feeds the TPOT histogram, so the
        # journal-derived value matches the engine's exactly; fall back
        # to the last decode stamp for still-live requests
        stop = end if end is not None else last
        r['tpot_s'] = ((stop - ft) / (n - 1)) if ft is not None \
            and stop is not None and n > 1 else None
        r['e2e_s'] = (end - sub) if sub is not None \
            and end is not None else None
        # v4 goodput columns: delivered = first-time prefill positions
        # + appended decode tokens. Every COMPLETED prefill (the
        # initial one and each post-preemption resume) samples a token
        # off its final column — v4 marks those chunks `sampled`, so
        # the decode share is n minus all of them; pre-v4 journals only
        # know about the first token. Wasted = preempt recompute + spec
        # columns that never landed. Matches the engine ledger's
        # per-request charges exactly on a v4 trace; v1-v3 leave the
        # prefill/spec fields zero and price what the journal knows.
        decode_delivered = max(
            n - max(r['prefill_samples'],
                    1 if ft is not None else 0), 0)
        r['delivered_tokens'] = (
            max(r['prefill_tokens_computed'] - r['recompute_tokens'], 0)
            + decode_delivered)
        r['wasted_tokens'] = (
            r['recompute_tokens']
            + max(r['spec_proposed'] - r['spec_accepted'], 0)
            + r['spec_discarded'])
    return out


def percentile_of(vals, q):
    """Linear-interpolated percentile of a value list (None entries
    dropped; None when nothing remains) — how request tables are
    aggregated into p50/p90/p99."""
    vals = sorted(v for v in vals if v is not None)
    if not vals:
        return None
    pos = q / 100.0 * (len(vals) - 1)
    i = int(pos)
    frac = pos - i
    hi = vals[min(i + 1, len(vals) - 1)]
    return vals[i] * (1 - frac) + hi * frac


def load_trace(path):
    """Read an export_jsonl file back into (header, events). All
    three schema versions load — v1 traces carry no route events (so
    reconstruct() leaves replica_id/router_decision at None), v1/v2
    carry no tenancy/degradation events (tenant columns default). An
    unknown serve_trace version raises rather than silently
    mis-reading a future layout."""
    header, events = {}, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if 'schema' in doc and 'event' not in doc:
                schema = doc.get('schema', '')
                if schema.startswith('paddle_tpu.serve_trace/') \
                        and schema not in SCHEMAS:
                    raise ValueError(
                        f"unsupported serve trace schema {schema!r} "
                        f"(this build reads {SCHEMAS})")
                header = doc
            elif 'event' in doc and 'req' in doc:
                events.append(doc)
    return header, events


# ---------------------------------------------------------------------------
# stalled-request watchdog artifact (serve_report)
# ---------------------------------------------------------------------------
def build_serve_report(reason, request_summary, trace_events,
                       timeline_tail, pool_stats, pool_census,
                       engine_stats=None):
    """Structured serve_report dict (kind-tagged, renderable by
    `render_serve_report`)."""
    return {
        'kind': 'serve_report',
        'schema': SCHEMA,
        'reason': reason,
        'request': request_summary,
        'trace': list(trace_events),
        'timeline_tail': list(timeline_tail),
        'pool': dict(pool_stats or {}),
        'pool_census': dict(pool_census or {}),
        'engine': dict(engine_stats or {}),
    }


def write_serve_report(report, report_dir=None):
    """Persist a serve_report; the directory is the explicit one, else
    $PTPU_SERVE_REPORT_DIR, else $FLEET_LOG_DIR; with none the report
    stays on the engine and in the log. Also logs a structured
    `serve_request_stalled` record naming the artifact. Returns the path
    (None when there is no directory or the write failed — the report
    still reached the log)."""
    d = (report_dir or os.environ.get('PTPU_SERVE_REPORT_DIR')
         or os.environ.get('FLEET_LOG_DIR'))
    req = report.get('request') or {}
    path = None
    if d:       # no dir configured -> artifact stays on the engine
                # (last_serve_report) and in the structured log only
        path = os.path.join(d,
                            f"serve_report.req{req.get('req', 'X')}.json")
        try:
            os.makedirs(d, exist_ok=True)
            with open(path, 'w') as f:
                json.dump(report, f, indent=1)
        except OSError:
            path = None
    log_json('serve_request_stalled', level='error',
             msg=f"serving request {req.get('req')} exceeded its "
                 f"deadline ({report.get('reason')})",
             request=req.get('req'), state=req.get('state'),
             age_s=req.get('age_s'), deadline_s=req.get('deadline_s'),
             report_path=path)
    return path


def render_serve_report(doc):
    """Human rendering of a serve_report artifact."""
    req = doc.get('request') or {}
    out = [f"SERVE REPORT — {doc.get('reason', '?')}"]
    out.append(
        f"  request {req.get('req')}: state={req.get('state')} "
        f"age={_ms(req.get('age_s'))} deadline={_ms(req.get('deadline_s'))}")
    out.append(
        f"  prompt {req.get('prompt_tokens')} tokens, "
        f"{req.get('tokens_generated', 0)} generated, "
        f"{req.get('preemptions', 0)} preemptions")
    table = reconstruct(doc.get('trace') or [])
    r = table.get(req.get('req'))
    if r:
        out.append(
            f"  queue-wait {_ms(r['queue_wait_s'])}  "
            f"ttft {_ms(r['ttft_s'])}  tpot {_ms(r['tpot_s'])}  "
            f"pages high-water {r['pages_high_water']}")
    evs = doc.get('trace') or []
    out.append(f"  trace tail ({len(evs)} events):")
    for e in evs[-8:]:
        extra = ' '.join(f'{k}={v}' for k, v in e.items()
                         if k not in ('req', 'event', 't'))
        out.append(f"    t={e['t']:.6f} {e['event']}"
                   + (f' {extra}' if extra else ''))
    tl = doc.get('timeline_tail') or []
    if tl:
        out.append(f"  scheduler timeline tail ({len(tl)} iterations):")
        for it in tl[-5:]:
            out.append(
                f"    iter {it.get('iter')}: "
                f"slots {it.get('decode_slots_occupied')}/"
                f"{it.get('decode_slots')} "
                f"prefill {it.get('prefill_tokens')}t "
                f"decode {it.get('decode_tokens')}t "
                f"pool {it.get('pool_pages_in_use')}/"
                f"{it.get('pool_pages_total')} "
                f"waiting {it.get('waiting')} "
                f"admit {it.get('admissions')} "
                f"preempt {it.get('preemptions')}")
    pool = doc.get('pool') or {}
    out.append(
        f"  pool: {pool.get('pages_in_use')}/{pool.get('num_pages')} "
        f"pages in use, high water {pool.get('high_water')}")
    census = doc.get('pool_census') or {}
    if census:
        rows = ', '.join(f'req {k}: {v} pages'
                         for k, v in sorted(census.items(),
                                            key=lambda kv: -kv[1])[:8])
        out.append(f"  pool census: {rows}")
    return '\n'.join(out)


def _ms(v):
    return f'{v * 1000.0:.1f}ms' if isinstance(v, (int, float)) else '?'
