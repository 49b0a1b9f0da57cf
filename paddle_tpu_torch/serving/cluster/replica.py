"""In-process serving replicas behind the cluster router — counterpart
of `paddle_tpu/serving/cluster/replica.py` (its `_EngineHost` and
`LocalReplica`, one class here while the port has one deployment).

`LocalReplica` hosts requests on one `ServingEngine`: submit (stamping
the router's `route` trace event), poll with a capped ring of finished
views, status (the heartbeat the router reads: queue depth, pending
work, decode rate, timeline summary, pool pressure, the prefix digest,
goodput, the ledger's account and the tenancy table), a compact metrics
snapshot for federation, drain (snapshot and abort every unfinished
request so a peer can resume it), the advisory host-tier prefetch,
abort, export_trace and shutdown. Engine access is serialized by one
lock. The router's `pump()` steps its engine, so one process drives
an n-replica cluster deterministically; several replicas may share one
card.

Not ported yet: the worker-process deployment (`ReplicaWorker`,
`RemoteReplica` and their control channel, ROADMAP Queue 1 item 8c)
and the disaggregated engine's replica (item 8b).
"""
import collections
import threading
import time

from ..scheduler import RequestState

_TERMINAL = (RequestState.FINISHED, RequestState.ABORTED)


def _req_snapshot(rid, req):
    """The drain handoff record: everything a peer needs to resume this
    request (the prefix-resurrect semantics, one replica over)."""
    return {
        'rid': rid,
        'prompt': list(req.prompt),
        'generated': list(req.generated),
        'max_new_tokens': req.max_new_tokens,
        'eos_token_id': req.eos_token_id,
        'temperature': req.temperature,
        'top_k': req.top_k,
    }


class LocalReplica:
    """In-process replica: request hosting over one engine
    (submit/poll/status/drain/abort), which the router pumps directly.
    Engine access is serialized by self._lock."""

    DONE_RING = 512

    def __init__(self, engine, replica_id, clock=None):
        self.engine = engine
        self.replica_id = str(replica_id)
        self._clock = clock or time.perf_counter
        self._reqs = {}                 # rid str -> engine Request
        # finished requests keep reporting in poll() until this capped
        # ring evicts them, so one lost poll reply cannot lose a
        # completion
        self._done = collections.OrderedDict()      # rid -> view
        self._lock = threading.RLock()
        self._draining = False
        self._hung = False
        self._hang_reason = None
        self._beat = self._clock()
        self._inject_hang = False

    # -- request plane -------------------------------------------------------
    def submit(self, prompt, opts, route_meta=None):
        if self._draining:
            raise RuntimeError(f"replica {self.replica_id} is draining")
        with self._lock:
            req = self.engine.submit(list(prompt), **dict(opts or {}))
            if route_meta and self.engine.tracer is not None:
                self.engine.tracer.record(req.id, 'route',
                                          **dict(route_meta))
        rid = str(req.id)
        self._reqs[rid] = req
        return rid

    def poll(self):
        with self._lock:
            out = {}
            for rid, req in list(self._reqs.items()):
                view = {'generated': list(req.generated),
                        'state': req.state,
                        'done': req.state in _TERMINAL}
                out[rid] = view
                if view['done']:
                    del self._reqs[rid]
                    self._done[rid] = view
                    while len(self._done) > self.DONE_RING:
                        self._done.popitem(last=False)
            for rid, view in self._done.items():
                out.setdefault(rid, view)
        return out

    def status(self):
        now = self._clock()
        with self._lock:
            eng = self.engine
            live = [r for r in eng.scheduler.slots
                    if r is not None and r.state not in _TERMINAL]
            waiting = list(eng.scheduler.waiting)
            pending_tokens = sum(
                max(r.max_new_tokens - len(r.generated), 0)
                + max(len(r.prompt) - r.prefilled, 0)
                for r in live + waiting)
            rate = (eng._decode_tokens / eng._decode_time
                    if eng._decode_time else 0.0)
            return {
                'replica_id': self.replica_id,
                'beat_age_s': now - self._beat,
                'hung': self._hung,
                'hang_reason': self._hang_reason,
                'draining': self._draining,
                'waiting': len(waiting),
                'in_flight': len(live),
                'pending_tokens': pending_tokens,
                'decode_tokens_per_sec': rate,
                'degrade_stage': eng.degrade_stage(),
                # a fused engine reports at window granularity
                'fused_k': eng._effective_fused_k(),
                'fused_windows_total': eng._fused_windows,
                'fused_iterations_total': eng._fused_iterations,
                'timeline': eng.timeline.summary(),
                'pool': {'pages_in_use': eng.pool.pages_in_use,
                         'num_pages': eng.pool.num_pages},
                'prefix_digest': eng.pool.prefix_chain_hashes(),
                # account() is None until the engine iterated
                'goodput': eng.ledger.goodput(),
                'ledger': eng.ledger.account(),
                'tenancy': eng._tenancy_stats(),
            }

    def metrics(self):
        """The scalar ptpu_serve_* series this engine would publish, off
        engine.stats() through the table publish() uses, never read back
        from the process-global registry, which in-process replicas
        share. The router merges them under a `replica` label."""
        from .. import metrics as _serve_metrics
        with self._lock:
            eng = self.engine
            series = _serve_metrics.scalar_series(eng.stats())
            acct = eng.ledger.account()
            if acct and acct.get('host_bound_fraction') is not None:
                series['ptpu_serve_ledger_host_bound_fraction'] = \
                    acct['host_bound_fraction']
            gf = (eng.ledger.goodput() or {}).get('goodput_fraction')
            if gf is not None:
                series['ptpu_serve_goodput_fraction'] = gf
            return {'replica_id': self.replica_id,
                    'beat_age_s': self._clock() - self._beat,
                    'series': series}

    def drain(self):
        """Stop admitting, snapshot and abort every unfinished request;
        the router resubmits the snapshots (prompt, tokens so far, the
        remaining options) to a peer."""
        self._draining = True
        snaps = []
        with self._lock:
            for rid, req in list(self._reqs.items()):
                if req.state in _TERMINAL:
                    continue
                snaps.append(_req_snapshot(rid, req))
                # best effort, as the reference: a request that ends
                # under the abort (the race of a retire with the drain)
                # is already in its snapshot, and the router's own
                # record decides whether it still needs a peer
                try:
                    self.engine.abort(req, reason='drained')
                except Exception:           # noqa: BLE001
                    pass
        return snaps

    def prefetch(self, prompt):
        """Advisory host-tier warm ahead of an affinity placement: the
        prompt's host-resident prefix pages come back into parked device
        pages, so the submit that follows prefix-hits them. A tierless
        engine warms nothing; the warm never evicts or preempts."""
        pool = self.engine.pool
        if pool.host_tier is None:
            return {'warmed_pages': 0}
        with self._lock:
            prompt = [int(t) for t in prompt]
            n = pool.warm_prefix(prompt, limit=len(prompt) - 1)
        return {'warmed_pages': int(n)}

    def abort(self, rid):
        req = self._reqs.get(str(rid))
        if req is None:
            return False
        with self._lock:
            return bool(self.engine.abort(req))

    def export_trace(self, jsonl_path):
        with self._lock:
            return self.engine.export_trace(jsonl_path=jsonl_path)

    def shutdown(self):
        with self._lock:
            return self.engine.shutdown()

    def inject_hang(self):
        """Test hook: pump() stops stamping the heartbeat (and stepping),
        which is what a wedged device dispatch looks like to the
        router's watchdog and the replica_heartbeat_stale rule."""
        self._inject_hang = True
        return {'ok': True}

    def pump(self):
        if self._inject_hang:
            return False
        with self._lock:
            self._beat = self._clock()
            if self.engine.scheduler.has_work:
                self.engine.step()
                return True
        return False
