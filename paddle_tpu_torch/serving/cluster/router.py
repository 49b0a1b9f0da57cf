"""Prefix-affinity request router: the serving cluster's front end —
counterpart of `paddle_tpu/serving/cluster/router.py`.

Placement reads two signals the single engine already keeps:

  * PREFIX AFFINITY (first): the prompt's full pages hash into a radix
    chain (`kv_pool.chain_hashes`, the link hash every replica derives
    from its own prefix index through `prefix_chain_hashes`); the
    replica whose published digest holds the DEEPEST chain prefix has
    those KV pages resident, so placing there turns whole prefill
    chunks into page maps. The router also adds a placed prompt's
    hashes to its own view of the target's digest at once (the
    optimistic overlay), so a burst of shared-prefix requests lands
    together without waiting for the next status refresh.
  * LEAST OCCUPANCY (fallback): each replica's published
    SchedulerTimeline summary and queue depth: fewest waiting plus in
    flight, ties to the lowest mean occupancy, then to the replica id.

Backpressure: a replica whose queue reaches `max_queue` is skipped; an
affinity hit on a saturated replica SPILLS to the open replica with the
deepest remaining prefix (counted apart: spills measure affinity broken
by load). When every healthy replica is over the bound, or
`deadline_bound_s` is set and the fastest replica's estimated backlog
exceeds it, the router REJECTS at submit (RouterRejected, with a reason
and a retry hint) instead of queueing forever.

Health and drain: replicas publish a heartbeat with their status; a
stale heartbeat, an unreachable status or the replica's own hung flag
marks it HUNG, and the router stops placing there and DRAINS it: every
in-flight request is resubmitted to a peer as prompt + the tokens
generated so far (re-prefill prefix-hits the peer's cache, and greedy
continuations are token-identical), so a wedged replica costs latency,
not requests.

Counters: ptpu_route_{affinity_hits,least_loaded,spills,rejects,
drains,resubmits,prefetch_hints}_total in core.monitor's registry;
`cluster_snapshot()` reads them back.

Federation: the router keeps its own MetricsRegistry — never the
process-global one, which in-process replicas share. `refresh()` feeds
it the status signals (heartbeat age, queue, occupancy, pool pressure)
and `federate()` merges each replica's compact `metrics()` snapshot,
every series under a `replica` label. `cluster_prometheus_text()` and
`serve_metrics_http()` give one scrape for the whole cluster; a
MetricHistory over that registry and an AlertManager running
`router_rules()` (heartbeat staleness, pool pressure, occupancy
imbalance, drain/resubmit storms, spill rate) sit on top.

Faults: the router survives a replica's channel failing
(`_CHANNEL_ERRORS`), and each such fault leaves a trace: a replica whose
submit, status or poll fails so is drained (a `drain_events` entry,
ptpu_route_drains_total); a prefetch hint that fails so is not counted
in ptpu_route_prefetch_hints_total; a replica whose metrics() fails so
is absent from the federated scrape; a resubmit that fails so waits in
`_unplaced`. An in-process replica has no channel: what its engine
raises reaches the router's caller, never a silent drain to a peer.
"""
import collections
import itertools
import time

from ...core import monitor as _m
from ...core.alerts import AlertManager, router_rules
from ..kv_pool import chain_hashes
from ..scheduler import AdmissionRejected

# What a replica's control channel raises when the replica is gone or
# slow: ConnectionError and socket.timeout, both OSErrors (channel.py).
# These drain the replica and move its work. The channel's other two
# errors reach the caller: ValueError (a frame over MAX_MSG: the message
# is at fault, and a peer would refuse it too) and RuntimeError (the
# worker's engine raised), as an in-process replica's engine error does.
_CHANNEL_ERRORS = (OSError,)


class RouterRejected(RuntimeError):
    """All replicas over their backpressure/deadline bound — retry
    later (the cluster is telling you now, not after the deadline).

    Structured: `reason` is machine-readable
    ('backpressure' | 'deadline_unmet' | 'no_healthy_replicas'),
    `retry_after_s` the router's own estimate of when a retry can
    land — computed from observed per-replica decode rates and queue
    depths (time until the fastest replica finishes one queued
    request), or forwarded from an engine-side AdmissionRejected.
    None when nothing is known (cold cluster / no healthy replicas).
    serve() backs off by the hint instead of a fixed sleep."""

    def __init__(self, message, reason='backpressure',
                 retry_after_s=None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


_route_ids = itertools.count()

_COUNTERS = {
    'affinity': ('ptpu_route_affinity_hits_total',
                 'placements on the replica already holding the '
                 'prompt prefix pages'),
    'least_loaded': ('ptpu_route_least_loaded_total',
                     'placements by occupancy fallback (no prefix '
                     'affinity)'),
    'spill': ('ptpu_route_spills_total',
              'affinity placements diverted by backpressure'),
    'reject': ('ptpu_route_rejects_total',
               'submissions rejected early (all replicas over bound)'),
    'drain': ('ptpu_route_drains_total',
              'replicas drained (hung or operator-requested)'),
    'resubmit': ('ptpu_route_resubmits_total',
                 'in-flight requests moved to a peer by a drain'),
    'prefetch_hint': ('ptpu_route_prefetch_hints_total',
                      'advisory host-tier prefetch hints sent ahead '
                      'of affinity placements'),
}


class RoutedRequest:
    """The router-side record of one request: where it went and every
    token streamed back so far. Survives drains — `tokens` accumulates
    across resubmissions, so `output_ids()` is the same contract as
    the engine's Request."""

    def __init__(self, prompt, opts):
        self.id = next(_route_ids)
        self.prompt = list(prompt)
        self.opts = dict(opts)
        self.tokens = []                # generated, across replicas
        self.replica_id = None
        self.remote_rid = None
        self.decision = None
        self.resubmits = 0
        # tokens generated BEFORE the current dispatch: a resubmitted
        # request's replica reports only its own continuation, which
        # appends after this prefix
        self._dispatch_base = 0
        self.done = False
        self.submit_t = None
        self.finish_t = None

    @property
    def budget_left(self):
        return self.opts.get('max_new_tokens', 32) - len(self.tokens)

    def output_ids(self):
        return self.prompt + self.tokens


class ClusterRouter:
    def __init__(self, replicas, page_size, max_queue=8,
                 deadline_bound_s=None, hang_timeout_s=10.0,
                 refresh_interval_s=0.25, clock=None,
                 history_capacity=512, alert_rules=None,
                 report_dir=None):
        if not replicas:
            raise ValueError("a cluster needs at least one replica")
        self.page_size = int(page_size)
        self.max_queue = int(max_queue)
        self.deadline_bound_s = deadline_bound_s
        self.hang_timeout_s = float(hang_timeout_s)
        self.refresh_interval_s = float(refresh_interval_s)
        self._clock = clock or time.perf_counter
        self._replicas = {r.replica_id: r for r in replicas}
        if len(self._replicas) != len(replicas):
            raise ValueError("duplicate replica ids")
        # affinity signal: the digest each replica PUBLISHED last
        # (replaced wholesale every refresh, so pool evictions age
        # out) plus a short-lived optimistic overlay for prompts the
        # router placed that the replica hasn't indexed/published yet
        # — entries survive OPTIMISTIC_GENERATIONS refreshes, then
        # drop (re-added on the next same-prefix submit if still hot)
        self._digest = {rid: set() for rid in self._replicas}
        self._optimistic = {rid: {} for rid in self._replicas}
        self._refresh_gen = {rid: 0 for rid in self._replicas}
        self._status = {rid: {} for rid in self._replicas}
        self._drained = set()
        self._hung = set()
        # request bookkeeping is BOUNDED for a long-lived front-end:
        # open requests only in _open/_by_replica (pruned the moment
        # they finish), a capped ring of finished ones for the SLO
        # view, lifetime counters for the snapshot
        self._open = {}                 # route id -> RoutedRequest
        self._recent = collections.deque(maxlen=1024)
        self._by_replica = {rid: {} for rid in self._replicas}
        self._routed_count = {rid: 0 for rid in self._replicas}
        self._total_requests = 0
        self._done_requests = 0
        self._unplaced = []             # drain resubmits whose
                                        # dispatch failed; pump retries
        self._pump_progressed = False
        self._last_refresh = None
        self.drain_events = []
        self.decisions = {k: 0 for k in _COUNTERS if k != 'reject'}
        self.rejects = 0
        # host-tier pages replicas reported warmed by advisory
        # prefetch hints — the cluster-side resurrect signal
        self.prefetch_warmed_pages = 0
        # per-tenant spill accounting: affinity placements
        # a tenant lost to backpressure — a heavy tenant saturating
        # its affinity replica shows up here, not in global spills
        self.tenant_spills = {}
        # goodput: prefix tokens drain-resubmits make peers
        # re-prefill — the cluster-level wasted-work cause no single
        # replica can see (each peer counts them as first-time work)
        self._drain_recompute_tokens = 0
        # telemetry time axis: the federated registry is
        # router-LOCAL (never the process-global one — in-process
        # LocalReplicas share that and would cross-contaminate), with
        # a history ring over it and the cluster-scope alert pack
        # evaluating on every history tick. Alert gauges/counters
        # still land in the GLOBAL registry (AlertManager default) so
        # a process scrape sees them without a federated one.
        self._federated = _m.MetricsRegistry()
        self.history = self._federated.enable_history(
            capacity=history_capacity, clock=self._clock)
        self.alerts = AlertManager(
            self.history,
            rules=(alert_rules if alert_rules is not None
                   else router_rules()),
            clock=self._clock, source='router', report_dir=report_dir)

    OPTIMISTIC_GENERATIONS = 2

    # -- bookkeeping ---------------------------------------------------------
    def _count(self, kind):
        name, help_ = _COUNTERS[kind]
        _m.counter(name, help=help_).inc()
        if kind == 'reject':
            self.rejects += 1
        else:
            self.decisions[kind] = self.decisions.get(kind, 0) + 1

    def healthy_replicas(self):
        return [rid for rid in self._replicas
                if rid not in self._drained and rid not in self._hung]

    def _queue_depth(self, rid):
        # the replica's own view vs the router's dispatch record —
        # whichever is larger (a just-routed burst may not be in the
        # last status yet; a drained request may not be out of it)
        st = self._status.get(rid) or {}
        routed = sum(1 for r in self._by_replica[rid].values()
                     if not r.done)
        return max(st.get('waiting', 0) + st.get('in_flight', 0),
                   routed)

    def _load_key(self, rid):
        st = self._status.get(rid) or {}
        tl = st.get('timeline') or {}
        return (self._queue_depth(rid),
                tl.get('mean_occupancy', 0.0), str(rid))

    def _over_bound(self, rid):
        if self._queue_depth(rid) >= self.max_queue:
            return True
        if self.deadline_bound_s is not None:
            st = self._status.get(rid) or {}
            rate = st.get('decode_tokens_per_sec') or 0.0
            if rate > 0.0:
                pending = st.get('pending_tokens', 0)
                if pending / rate > self.deadline_bound_s:
                    return True
        return False

    def _retry_hint(self):
        """The structured RouterRejected back-off hint: for each
        healthy replica, pending_tokens / observed decode rate is its
        backlog's drain time, and one queue slot frees after roughly
        backlog / queue_depth of it — take the fastest replica's
        estimate. None on a cold cluster (no decode rate observed
        yet)."""
        best = None
        for rid in self.healthy_replicas():
            st = self._status.get(rid) or {}
            rate = st.get('decode_tokens_per_sec') or 0.0
            if rate <= 0.0:
                continue
            depth = max(self._queue_depth(rid), 1)
            t = st.get('pending_tokens', 0) / rate / depth
            best = t if best is None else min(best, t)
        return best

    # -- placement -----------------------------------------------------------
    def _affinity_depth(self, hashes, rid):
        digest = self._digest.get(rid) or ()
        opt = self._optimistic.get(rid) or ()
        depth = 0
        for h in hashes:
            if h not in digest and h not in opt:
                break
            depth += 1
        return depth

    def place(self, prompt, count_reject=True, _hashes=None):
        """(decision, replica_id) for a prompt — affinity first,
        least-occupancy fallback, spill under backpressure, reject
        when everyone is saturated. `_hashes` lets submit() reuse the
        chain hashes it computes anyway for the digest update (one
        blake2b pass per prompt, not two)."""
        healthy = self.healthy_replicas()
        if not healthy:
            if count_reject:
                self._count('reject')
            raise RouterRejected("no healthy replicas",
                                 reason='no_healthy_replicas')
        hashes = _hashes if _hashes is not None else chain_hashes(
            prompt, self.page_size, limit=len(prompt) - 1)
        depths = {rid: self._affinity_depth(hashes, rid)
                  for rid in healthy}
        open_replicas = [r for r in healthy if not self._over_bound(r)]
        if not open_replicas:
            if count_reject:
                self._count('reject')
            hint = self._retry_hint()
            raise RouterRejected(
                f"all {len(healthy)} replicas over the backpressure "
                f"bound (max_queue={self.max_queue}"
                + (f", deadline_bound_s={self.deadline_bound_s}"
                   if self.deadline_bound_s is not None else '')
                + (f"; retry in ~{hint:.3f}s" if hint is not None
                   else '') + ")",
                reason='backpressure', retry_after_s=hint)
        maxdepth = max(depths.values())
        if maxdepth > 0:
            # deepest shared prefix wins; ties go to the lighter one
            best = min((r for r in healthy if depths[r] == maxdepth),
                       key=self._load_key)
            if best in open_replicas:
                return 'affinity', best
            # affinity target saturated: spill to the best OPEN
            # replica — deepest remaining prefix first (a partial
            # prefix hit still beats re-prefilling everything), load
            # as the tiebreak
            return 'spill', min(
                open_replicas,
                key=lambda r: (-depths[r],) + self._load_key(r))
        return 'least_loaded', min(open_replicas, key=self._load_key)

    def submit(self, prompt, **opts):
        """Place + submit one request; returns the RoutedRequest (or
        raises RouterRejected). Refreshes stale replica status first
        so placement never runs on a dead signal.

        Tenancy flows THROUGH the router: tenant_id /
        priority / deadline_s ride in `opts` to the replica's engine
        untouched. An engine-side deadline rejection (AdmissionRejected
        — the replica is healthy, the deadline just can't be met)
        re-raises as a structured RouterRejected carrying the engine's
        own retry hint, WITHOUT draining the replica."""
        self.refresh(max_age_s=self.refresh_interval_s)
        hashes = chain_hashes(prompt, self.page_size,
                              limit=len(prompt) - 1)
        req = RoutedRequest(prompt, opts)
        req.submit_t = self._clock()
        while True:
            decision, rid = self.place(prompt, _hashes=hashes)
            try:
                self._dispatch(req, rid, decision, hashes=hashes)
            except AdmissionRejected as e:
                self._count('reject')
                raise RouterRejected(
                    f"replica {rid} rejected at admission: {e}",
                    reason=e.reason,
                    retry_after_s=e.retry_after_s) from e
            except _CHANNEL_ERRORS as e:
                # the chosen replica died between refresh and
                # dispatch: drain it (its other in-flight requests
                # move too) and re-place — place() raises
                # RouterRejected once nobody healthy remains, with
                # nothing of THIS request stranded anywhere
                self._hung.add(rid)
                self.drain(rid, reason=f'submit dispatch failed: '
                                       f'{repr(e)[:120]}')
                continue
            self._count(decision)
            if decision == 'spill':
                tid = opts.get('tenant_id')
                if tid is not None:
                    self.tenant_spills[str(tid)] = \
                        self.tenant_spills.get(str(tid), 0) + 1
            return req

    def _dispatch(self, req, rid, decision, hashes=None):
        replica = self._replicas[rid]
        prompt = req.prompt + req.tokens        # resubmit = resurrect
        req._dispatch_base = len(req.tokens)
        if decision == 'affinity':
            # advisory host-tier prefetch hint: the replica
            # holds this prefix in its radix index — some of it may
            # have spilled to host RAM, so warm it back onto device
            # BEFORE the request lands. Best-effort by construction: a
            # tierless replica warms 0 pages, a channel hiccup must
            # not fail the placement (the submit path is authoritative
            # and resurrects on its own if the hint was lost). A replica
            # without the op takes no hint.
            prefetch = getattr(replica, 'prefetch', None)
            try:
                if prefetch is not None:
                    reply = prefetch(prompt)
                    self._count('prefetch_hint')
                    if (reply or {}).get('warmed_pages'):
                        self.prefetch_warmed_pages += int(
                            reply['warmed_pages'])
            except _CHANNEL_ERRORS:
                pass
        opts = dict(req.opts)
        opts['max_new_tokens'] = req.budget_left
        remote = replica.submit(prompt, opts, route_meta={
            'replica_id': str(rid), 'router_decision': decision})
        req.replica_id, req.remote_rid = rid, remote
        req.decision = decision if req.decision is None else req.decision
        self._open[req.id] = req
        self._by_replica[rid][remote] = req
        self._routed_count[rid] += 1
        self._total_requests += 1 if req.resubmits == 0 else 0
        # optimistic digest overlay: the pages this prompt will index
        # land on rid — siblings submitted before the replica indexes
        # and publishes them still route there (aged out after
        # OPTIMISTIC_GENERATIONS refreshes; the published digest is
        # the durable signal)
        if hashes is None:
            hashes = chain_hashes(prompt, self.page_size,
                                  limit=len(prompt) - 1)
        gen = self._refresh_gen[rid]
        self._optimistic[rid].update(dict.fromkeys(hashes, gen))

    # -- metrics federation -------------------------------------------------
    def _fed_gauge(self, name, help=''):
        return self._federated.gauge(name, help=help,
                                     labelnames=('replica',))

    def _feed_federated(self, rid, st, tl):
        """One replica's status into the federated registry — the
        history/alert substrate. Single-engine ptpu_serve_* names keep
        their meaning, one series per replica under the `replica`
        label; staleness stamps on these series are how a quiet
        replica shows in the cluster scrape."""
        r = str(rid)
        fg = self._fed_gauge
        beat = st.get('beat_age_s')
        if beat is not None:
            help_ = ('replica step-loop heartbeat age at the last '
                     'router refresh (replica_heartbeat_stale input)')
            fg('ptpu_cluster_replica_beat_age_seconds',
               help=help_).set(beat, replica=r)
            _m.gauge('ptpu_cluster_replica_beat_age_seconds',
                     help=help_, labelnames=('replica',)).set(
                beat, replica=r)
        fg('ptpu_cluster_replica_queue_depth',
           help='per-replica waiting + in-flight (router view)').set(
            self._queue_depth(rid), replica=r)
        fg('ptpu_cluster_replica_occupancy',
           help='per-replica mean decode-slot occupancy').set(
            tl.get('mean_occupancy') or 0.0, replica=r)
        pool = st.get('pool') or {}
        if pool.get('num_pages'):
            fg('ptpu_serve_kv_page_utilization',
               help='KV pool pages in use / total').set(
                pool.get('pages_in_use', 0) / pool['num_pages'],
                replica=r)
        fg('ptpu_serve_requests_waiting', help='queued requests').set(
            st.get('waiting', 0), replica=r)
        fg('ptpu_serve_requests_in_flight',
           help='requests holding a decode slot').set(
            st.get('in_flight', 0), replica=r)
        fg('ptpu_serve_decode_tokens_per_sec',
           help='batched decode throughput (tokens/sec)').set(
            st.get('decode_tokens_per_sec') or 0.0, replica=r)
        fg('ptpu_serve_degrade_stage',
           help='graceful-degradation ladder stage').set(
            st.get('degrade_stage', 0) or 0, replica=r)
        gf = (st.get('goodput') or {}).get('goodput_fraction')
        if gf is not None:
            fg('ptpu_serve_goodput_fraction',
               help='delivered / emitted tokens').set(gf, replica=r)

    def _feed_router_counters(self):
        """Router-scope lifetime counts as unlabeled federated gauges
        — the substrate the drain/resubmit-storm and spill-rate delta
        rules window over."""
        for kind in ('drain', 'resubmit', 'spill', 'reject'):
            name, help_ = _COUNTERS[kind]
            val = (self.rejects if kind == 'reject'
                   else self.decisions.get(kind, 0))
            self._federated.gauge(name, help=help_).set(val)

    def federate(self):
        """Pull each live replica's compact `metrics` snapshot (the
        channel op — engine-truth scalars, not the shared global
        registry) and merge it under the `replica` label; ticks the
        cluster history. Returns {replica_id: reply}."""
        out = {}
        for rid, replica in self._replicas.items():
            if rid in self._drained:
                continue
            metrics = getattr(replica, 'metrics', None)
            if metrics is None:
                continue                    # a replica without the op
            try:
                m = metrics()
            except _CHANNEL_ERRORS:
                continue
            out[str(rid)] = m
            for name, val in sorted((m.get('series') or {}).items()):
                if val is None:
                    continue
                self._fed_gauge(name).set(float(val), replica=str(rid))
        self.history.tick()
        return out

    def cluster_prometheus_text(self, federate=True):
        """ONE scrape for the whole cluster: merge fresh per-replica
        snapshots, then render the federated registry with per-series
        staleness ages (a dead replica's series visibly age out)."""
        if federate:
            self.federate()
        return self._federated.prometheus_text(include_age=True)

    def serve_metrics_http(self, port=0, addr='127.0.0.1'):
        """Embeddable cluster-wide /metrics endpoint over the
        federated registry (GET /metrics, /metrics.json). The scrape
        renders the LAST federated state — keep it fresh by calling
        refresh()/federate() from the serving loop, which run() and
        serve() already do."""
        return _m.MetricsServer(port=port, addr=addr,
                                registry=self._federated)

    # -- health / status -----------------------------------------------------
    def refresh(self, max_age_s=0.0):
        """Pull status from every live replica (digest, queue depth,
        timeline summary, heartbeat). An unresponsive or self-reported
        hung replica is drained."""
        now = self._clock()
        if (self._last_refresh is not None
                and now - self._last_refresh < max_age_s):
            return
        self._last_refresh = now
        for rid, replica in list(self._replicas.items()):
            if rid in self._drained:
                continue
            try:
                st = replica.status()
            except _CHANNEL_ERRORS as e:
                self._hung.add(rid)
                self.drain(rid, reason=f'status unreachable: '
                                       f'{repr(e)[:120]}')
                continue
            self._status[rid] = st
            tl = st.get('timeline') or {}
            _m.gauge('ptpu_cluster_replica_queue_depth',
                     help='per-replica waiting + in-flight requests '
                          '(router view)',
                     labelnames=('replica',)).set(
                self._queue_depth(rid), replica=str(rid))
            _m.gauge('ptpu_cluster_replica_occupancy',
                     help='per-replica mean decode-slot occupancy '
                          '(SchedulerTimeline window)',
                     labelnames=('replica',)).set(
                tl.get('mean_occupancy') or 0.0, replica=str(rid))
            self._feed_federated(rid, st, tl)
            digest = st.get('prefix_digest')
            if digest is not None:
                # REPLACE with what the replica actually holds — a
                # union would keep routing to pages the pool LRU
                # evicted long ago. Optimistic entries live in their
                # own overlay and age out by refresh generation.
                self._digest[rid] = {int(h) for h in digest}
                gen = self._refresh_gen[rid] = \
                    self._refresh_gen[rid] + 1
                horizon = gen - self.OPTIMISTIC_GENERATIONS
                self._optimistic[rid] = {
                    h: g for h, g in self._optimistic[rid].items()
                    if g > horizon}
            if st.get('hung') or (
                    st.get('beat_age_s') is not None
                    and st['beat_age_s'] > self.hang_timeout_s):
                self._hung.add(rid)
                self.drain(rid, reason=st.get(
                    'hang_reason') or
                    f"heartbeat stale {st.get('beat_age_s'):.1f}s")
        # history sample + alert evaluation ride the refresh cadence
        # (metadata-only; deterministic under an injected clock)
        self._feed_router_counters()
        self.history.tick()

    def drain(self, rid, reason='operator drain'):
        """Stop placement on `rid` and move its in-flight requests to
        peers. Safe on an unresponsive replica: the router's own
        records say what was running there and how many tokens each
        request already streamed back."""
        if rid in self._drained:
            return []
        self._drained.add(rid)
        self._count('drain')
        event = {'replica_id': str(rid), 'reason': reason,
                 't': self._clock(), 'resubmitted': 0}
        self.drain_events.append(event)
        # best-effort remote snapshot: a replica whose STEP loop is
        # wedged still answers on the control thread and reports
        # tokens the router's poll may not have seen yet
        snapshots = {}
        try:
            for snap in self._replicas[rid].drain():
                snapshots[snap['rid']] = snap
        except _CHANNEL_ERRORS:
            pass
        moved = []
        for remote, req in list(self._by_replica[rid].items()):
            if req.done:
                continue
            snap = snapshots.get(remote)
            if snap is not None:
                self._merge_tokens(req, snap.get('generated', ()))
            self._finish_if_done(req)
            if req.done:
                continue
            req.resubmits += 1
            self._count('resubmit')
            if self._resubmit(req):
                moved.append(req)
        self._by_replica[rid] = {}
        event['resubmitted'] = len(moved)
        return moved

    def _resubmit(self, req):
        """Re-place one drained request on a peer. A failed dispatch
        (peer channel hiccup, peer admission refusing it for now,
        nobody healthy right now) parks the request in `_unplaced`
        and pump() keeps retrying — a drain must move EVERY request
        it can and strand none on a transient error. What a peer's
        engine raises otherwise reaches the caller."""
        try:
            try:
                decision, peer = self.place(req.prompt + req.tokens,
                                            count_reject=False)
            except RouterRejected:
                # drained work is NOT new admission — it was already
                # accepted once and must land somewhere. Bypass the
                # backpressure bound onto the least-loaded healthy
                # peer (reject-early guards the front door, not
                # requests mid-flight).
                healthy = self.healthy_replicas()
                if not healthy:
                    raise
                decision = 'spill'
                peer = min(healthy, key=self._load_key)
            self._dispatch(req, peer, decision)
            # goodput: the peer re-prefills the whole
            # resubmitted prefix (prompt + tokens streamed so far) —
            # work the cluster already paid for once. Priced here
            # because only the router sees the resubmit; the peer's
            # own ledger counts those positions as first-time
            # delivered, and cluster_snapshot() moves this many from
            # delivered to wasted. Upper bound: a peer prefix-cache
            # hit shrinks the actual recompute.
            recompute = len(req.prompt) + len(req.tokens)
            self._drain_recompute_tokens += recompute
            _m.counter(
                'ptpu_route_drain_recompute_tokens_total',
                help='drain-resubmit recompute: prefix tokens peers '
                     're-prefill for requests moved off a drained '
                     'replica (lifetime; priced as wasted in '
                     'cluster_snapshot goodput)').inc(recompute)
            return True
        except (RouterRejected, AdmissionRejected) + _CHANNEL_ERRORS:
            if req not in self._unplaced:
                self._unplaced.append(req)
            return False

    @staticmethod
    def _merge_tokens(req, generated):
        """Fold a replica's reported continuation into the routed
        request: the replica only knows tokens since ITS dispatch, so
        they append after the pre-dispatch prefix."""
        if len(generated) > len(req.tokens) - req._dispatch_base:
            req.tokens = (req.tokens[:req._dispatch_base]
                          + [int(t) for t in generated])

    def _mark_done(self, req):
        """Terminal bookkeeping: prune from the open/by-replica maps
        (the router is long-lived — done requests must not accumulate)
        and keep the request in the capped recent ring for the SLO
        view. The caller's own RoutedRequest reference stays valid."""
        req.done = True
        if req.finish_t is None:
            req.finish_t = self._clock()
        if self._open.pop(req.id, None) is not None:
            self._done_requests += 1
            self._recent.append(req)
        by = self._by_replica.get(req.replica_id)
        if by is not None:
            by.pop(req.remote_rid, None)

    def _finish_if_done(self, req):
        eos = req.opts.get('eos_token_id')
        if req.budget_left <= 0 or (
                eos is not None and req.tokens
                and req.tokens[-1] == eos):
            self._mark_done(req)

    # -- progress ------------------------------------------------------------
    def pump(self):
        """Drive in-process replicas one engine step and fold every
        replica's poll into the routed requests. Returns True while
        anything is still in flight."""
        live = False
        self._pump_progressed = False
        for req in list(self._unplaced):    # drain leftovers retry
            if req.done or self._resubmit(req):
                self._unplaced.remove(req)
        for rid, replica in self._replicas.items():
            if rid in self._drained:
                continue
            try:
                if replica.pump():
                    self._pump_progressed = True
                polled = replica.poll()
            except _CHANNEL_ERRORS as e:
                self.drain(rid, reason=f'poll failed: {repr(e)[:120]}')
                continue
            for remote, view in polled.items():
                req = self._by_replica[rid].get(remote)
                if req is None or req.done:
                    continue
                before = len(req.tokens)
                self._merge_tokens(req, view.get('generated', ()))
                if len(req.tokens) != before:
                    self._pump_progressed = True
                if view.get('done'):
                    self._mark_done(req)
                    self._pump_progressed = True
                else:
                    live = True
        return live or bool(self._open) or bool(self._unplaced)

    def run(self, timeout_s=120.0, poll_interval_s=None):
        """Pump until every routed request finishes (health-checked
        every refresh_interval_s). A pass that neither stepped a local
        replica nor saw new tokens backs off `poll_interval_s`
        (default 5ms) instead of hot-looping TCP polls against worker
        control threads that are busy decoding."""
        if poll_interval_s is None:
            poll_interval_s = 0.005
        t0 = self._clock()
        while self._open or self._unplaced:
            self.refresh(max_age_s=self.refresh_interval_s)
            self.pump()
            if self._clock() - t0 > timeout_s:
                raise RuntimeError(
                    f"cluster did not drain in {timeout_s}s "
                    f"(open: {sorted(self._open)})")
            if poll_interval_s and not self._pump_progressed:
                time.sleep(poll_interval_s)
        self.refresh(max_age_s=0.0)     # snapshot() sees final state
        return list(self._recent)

    def serve(self, prompts, timeout_s=120.0, **opts):
        """Submit a prompt list, run to completion, return outputs in
        submission order — the cluster-wide `engine.generate`.

        Unlike raw `submit()` (the reject-early surface for callers
        who can retry), serve() THROTTLES on RouterRejected: it pumps
        the replicas and retries, backing off by the rejection's OWN
        `retry_after_s` hint (pump until the hinted window
        elapses, then re-place) instead of hammering resubmits every
        pump; a hint-less rejection retries after one pump as before.
        A rejection with no progress possible (no healthy replicas)
        still escapes via the timeout."""
        t0 = self._clock()
        reqs = []
        for p in prompts:
            while True:
                try:
                    reqs.append(self.submit(p, **opts))
                    break
                except RouterRejected as rej:
                    if self._clock() - t0 > timeout_s:
                        raise
                    self._backoff(rej.retry_after_s,
                                  deadline=t0 + timeout_s)
        self.run(timeout_s=max(timeout_s - (self._clock() - t0), 1.0))
        return [r.output_ids() for r in reqs]

    def _backoff(self, retry_after_s, deadline):
        """Pump the cluster through a rejection's back-off window:
        local replicas keep stepping (their queues ARE the reason for
        the rejection), remote ones get polled, and an unproductive
        pass sleeps briefly instead of hot-looping the control plane.
        Returns once the hinted window elapses (one pump minimum) or
        the caller's deadline arrives."""
        t0 = self._clock()
        while True:
            self.refresh(max_age_s=self.refresh_interval_s)
            self.pump()
            now = self._clock()
            if retry_after_s is None or now - t0 >= retry_after_s \
                    or now >= deadline:
                return
            if not self._pump_progressed:
                time.sleep(min(retry_after_s, 0.005))

    # -- views ---------------------------------------------------------------
    def snapshot(self):
        """JSON-ready router view: placement counters, per-replica
        load/digest sizes, drain events, goodput, tenants, alerts."""
        per_replica = {}
        for rid in self._replicas:
            st = self._status.get(rid) or {}
            tl = st.get('timeline') or {}
            per_replica[str(rid)] = {
                'drained': rid in self._drained,
                'hung': rid in self._hung or bool(st.get('hung')),
                'queue_depth': self._queue_depth(rid),
                'waiting': st.get('waiting', 0),
                'in_flight': st.get('in_flight', 0),
                'mean_occupancy': tl.get('mean_occupancy'),
                'decode_tokens': tl.get('decode_tokens'),
                'prefill_tokens': tl.get('prefill_tokens'),
                'preemptions': tl.get('preemptions'),
                'degrade_stage': st.get('degrade_stage', 0),
                'digest_size': len(self._digest.get(rid) or ())
                + len(self._optimistic.get(rid) or ()),
                'requests_routed': self._routed_count[rid],
                'goodput': st.get('goodput'),
            }
        total = sum(self.decisions.get(k, 0)
                    for k in ('affinity', 'least_loaded', 'spill'))
        return {
            'replicas': per_replica,
            'placements': dict(self.decisions),
            'rejects': self.rejects,
            'prefetch_warmed_pages': self.prefetch_warmed_pages,
            'affinity_hit_rate':
                (self.decisions.get('affinity', 0) / total
                 if total else None),
            'drain_events': list(self.drain_events),
            'requests': self._total_requests,
            'requests_done': self._done_requests,
            'tenant_spills': dict(self.tenant_spills),
            'goodput': self._cluster_goodput(per_replica),
            'tenants': self._cluster_tenants(),
            'alerts': self.alerts.summary(),
        }

    def cluster_snapshot(self):
        """The full cluster view: snapshot() including
        the cluster-wide per-tenant table and the alert summary."""
        return self.snapshot()

    _TENANT_SUM_KEYS = ('submitted', 'completed', 'aborted',
                        'quota_deferrals', 'preemptions_charged',
                        'charge_tokens', 'deadline_rejects',
                        'deadline_misses', 'tokens_billed')

    def _cluster_tenants(self):
        """Cluster-wide per-tenant accounting: each tenant's rows
        summed across the replicas' last-published tenancy tables —
        the per-replica-bucket N x-quota effect made measurable — plus
        the router's own per-tenant spill counts."""
        out = {}
        for rid in self._replicas:
            st = self._status.get(rid) or {}
            rows = (st.get('tenancy') or {}).get('tenants') or {}
            for tid, row in rows.items():
                dst = out.setdefault(str(tid), {'replicas': 0})
                dst['replicas'] += 1
                for k in self._TENANT_SUM_KEYS:
                    v = row.get(k)
                    if v is not None:
                        dst[k] = dst.get(k, 0) + v
        for tid, n in self.tenant_spills.items():
            out.setdefault(str(tid),
                           {'replicas': 0})['router_spills'] = n
        return out

    def _cluster_goodput(self, per_replica):
        """Aggregate the replicas' goodput accounts and reprice the
        drain-resubmit recompute: each peer counted a resubmitted
        prefix as first-time delivered work, so the router MOVES those
        tokens delivered -> wasted (cause drain_recompute), keeping
        delivered + wasted == emitted exact at the cluster level. None
        until some replica reports a goodput block."""
        agg = {'emitted_tokens': 0, 'delivered_tokens': 0,
               'wasted_tokens': 0, 'wasted_by_cause': {},
               'spec_shed_tokens': 0}
        seen = False
        for row in per_replica.values():
            g = row.get('goodput')
            if not g:
                continue
            seen = True
            for k in ('emitted_tokens', 'delivered_tokens',
                      'wasted_tokens', 'spec_shed_tokens'):
                agg[k] += int(g.get(k, 0) or 0)
            for c, v in (g.get('wasted_by_cause') or {}).items():
                agg['wasted_by_cause'][c] = \
                    agg['wasted_by_cause'].get(c, 0) + int(v)
        if not seen:
            return None
        moved = min(self._drain_recompute_tokens,
                    agg['delivered_tokens'])
        agg['delivered_tokens'] -= moved
        agg['wasted_tokens'] += moved
        agg['wasted_by_cause']['drain_recompute'] = \
            agg['wasted_by_cause'].get('drain_recompute', 0) + moved
        agg['drain_recompute_tokens'] = self._drain_recompute_tokens
        agg['goodput_fraction'] = (
            agg['delivered_tokens'] / agg['emitted_tokens']
            if agg['emitted_tokens'] else None)
        return agg

    def request_slo(self):
        """Router-side per-request latency view (submit→finish as the
        ROUTER saw it — includes channel + drain resubmission time the
        engine-side traces can't see). Open requests plus the capped
        ring of recently finished ones."""
        out = {}
        for r in list(self._recent) + list(self._open.values()):
            out[r.id] = {
                'req': r.id, 'replica_id': str(r.replica_id),
                'router_decision': r.decision,
                'resubmits': r.resubmits,
                'tokens_generated': len(r.tokens),
                'e2e_s': (r.finish_t - r.submit_t)
                if r.done and r.submit_t is not None else None,
            }
        return out

    def shutdown(self):
        for replica in self._replicas.values():
            try:
                replica.shutdown()
            except _CHANNEL_ERRORS:
                pass


def cluster_snapshot():
    """The ptpu_route_* counters currently in the monitor registry
    (None-able mirror of the last router's activity) — the
    StepTelemetry pickup point."""
    reg = _m.metrics()
    out = {}
    for kind, (name, _h) in _COUNTERS.items():
        m = reg.get(name)
        if m is not None:
            out[name] = m.value()
    m = reg.get('ptpu_route_drain_recompute_tokens_total')
    if m is not None:
        out['ptpu_route_drain_recompute_tokens_total'] = m.value()
    return out or None
