"""Continuous-batching scheduler (host side) — counterpart of
`paddle_tpu/serving/scheduler.py`.

Orca-style iteration-level scheduling: requests join an admission
queue, claim a decode slot when one frees up, chunk-prefill their
prompt, then ride the batched decode step (one token per iteration, or
up to spec_k+1 with speculative decoding) until EOS / length, when the
slot is re-filled at once. When the KV pool runs dry a victim is
preempted: its page mappings are dropped (pages a prefix-sharing
sibling still maps survive, kv_pool.py refcounts) and it re-queues at
the front with its generated tokens kept, so resume is a re-prefill of
prompt + generated that itself prefix-hits any of its pages still
cached.

Tenancy: a `Request` carries `tenant_id`, `priority` (a small int
class, larger = more important) and an optional `deadline_s`;
`TenantTable` maps tenants to (priority, token-rate quota through a
refillable `TokenBucket`, prefix-cache eviction weight). Admission order
is priority-then-FCFS within a class (`admission_order()`), and the
victim under pool pressure is the youngest request of the LOWEST
priority class strictly below the admitting request
(`preempt_victim(below_priority=)`). With no tenants every request sits
in class 0 and both rules are exactly the untenanted FCFS /
preempt-youngest behaviour.

`DegradeLadder` is the overload controller: a windowed pressure signal
(pool occupancy, waiting depth, host-tier occupancy) walks the engine up
three stages — shed speculative decoding and fused windows, halve the
prefill chunk, evict prefix-cache subtrees by tenant weight — and back
down hysteretically (lower down-thresholds and a dwell count).

`SchedulerTimeline` is the iteration-level flight record: a ring of each
engine sweep's batch composition (slots occupied, prefill vs decode
tokens, pool occupancy, admissions, preemptions, ladder stage), the
context a request trace is read against.

All of it is host bookkeeping between the engine's steps; the card never
sees a dynamic decision.
"""
import collections
import itertools
import time


class AdmissionRejected(RuntimeError):
    """Deadline-aware admission turned a request away AT SUBMIT: its
    estimated completion (pending tokens / observed decode rate)
    already exceeds its `deadline_s`, so queueing it would only burn
    pool pages on certain failure. Structured so callers can back off
    by the hint instead of a fixed sleep."""

    def __init__(self, reason, retry_after_s=None, estimated_s=None,
                 deadline_s=None, message=None):
        super().__init__(
            message or f"admission rejected ({reason}): estimated "
                       f"completion {_fmt_s(estimated_s)} exceeds "
                       f"deadline {_fmt_s(deadline_s)} — retry in "
                       f"~{_fmt_s(retry_after_s)}")
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.estimated_s = estimated_s
        self.deadline_s = deadline_s


def _fmt_s(v):
    return f'{v:.3f}s' if isinstance(v, (int, float)) else '?'


class TokenBucket:
    """Refillable token-rate quota. `rate` tokens/s stream in up to a
    `burst` cap; admission debits a request's whole token bill at
    once. The level may go NEGATIVE (debt) in two cases: a request
    bigger than the burst admits when the bucket is full (over-quota
    tenants are deferrable, never unservable), and charged preemptions
    (`charge()`) debit unconditionally — the tenant then waits out its
    debt before the next admit. Refill is lazy (computed from the
    injected clock at read time), so deterministic-clock tests step it
    exactly."""

    def __init__(self, rate, burst=None, clock=None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None
                           else max(self.rate, 1.0))
        self.clock = clock or time.perf_counter
        self._level = self.burst
        self._t = self.clock()

    def _refill(self):
        now = self.clock()
        dt = max(now - self._t, 0.0)
        self._t = now
        self._level = min(self._level + dt * self.rate, self.burst)

    @property
    def level(self):
        self._refill()
        return self._level

    def try_debit(self, cost):
        """Debit `cost` tokens if the tenant has quota NOW: the bucket
        must hold min(cost, burst) — a bill larger than the burst cap
        admits from a full bucket and leaves debt. Returns True when
        debited (admit), False when the caller should defer."""
        self._refill()
        if self._level < min(float(cost), self.burst):
            return False
        self._level -= float(cost)
        return True

    def charge(self, cost):
        """Unconditional debit (may go negative) — the charged-
        preemption path: churning the pool spends the preemptor's own
        quota."""
        self._refill()
        self._level -= float(cost)

    def seconds_until(self, cost):
        """Time until try_debit(cost) would succeed (0.0 when it would
        succeed now) — the quota-defer retry hint."""
        self._refill()
        need = min(float(cost), self.burst) - self._level
        if need <= 0.0:
            return 0.0
        return need / self.rate if self.rate > 0 else float('inf')


class TenantTable:
    """The `ServingConfig.tenants` policy map resolved into runtime
    state: per-tenant priority class, optional `TokenBucket` quota and
    prefix-cache eviction weight. Unknown tenants (and tenant_id=None)
    fall into the default class: priority 0, no quota, weight 1.0 —
    declaring tenants must never break anonymous traffic."""

    def __init__(self, tenants, clock=None):
        self.clock = clock or time.perf_counter
        self._policies = {}
        self._buckets = {}
        for tid, pol in (tenants or {}).items():
            pol = dict(pol or {})
            unknown = set(pol) - {'priority', 'quota_tokens_per_s',
                                  'burst_tokens', 'weight'}
            if unknown:
                raise ValueError(
                    f"tenant {tid!r}: unknown policy keys "
                    f"{sorted(unknown)} (allowed: priority, "
                    f"quota_tokens_per_s, burst_tokens, weight)")
            self._policies[str(tid)] = {
                'priority': int(pol.get('priority', 0)),
                'quota_tokens_per_s': pol.get('quota_tokens_per_s'),
                'burst_tokens': pol.get('burst_tokens'),
                'weight': float(pol.get('weight', 1.0)),
            }
            rate = pol.get('quota_tokens_per_s')
            if rate is not None:
                self._buckets[str(tid)] = TokenBucket(
                    rate, pol.get('burst_tokens'), clock=self.clock)

    def __contains__(self, tenant_id):
        return str(tenant_id) in self._policies

    def tenants(self):
        return list(self._policies)

    def policy(self, tenant_id):
        return self._policies.get(str(tenant_id))

    def priority_of(self, tenant_id):
        pol = self._policies.get(str(tenant_id))
        return pol['priority'] if pol else 0

    def bucket(self, tenant_id):
        return self._buckets.get(str(tenant_id))

    def weight_of(self, tenant_id):
        pol = self._policies.get(str(tenant_id))
        return pol['weight'] if pol else 1.0

    def eviction_weights(self):
        """{tenant_id: weight} for kv_pool.set_eviction_weights —
        lower weight evicts first at degradation stage 3."""
        return {tid: pol['weight']
                for tid, pol in self._policies.items()}


class DegradeLadder:
    """Graceful-degradation controller: a windowed pressure
    signal walks an integer stage 0..3 up eagerly and down
    hysteretically.

    Pressure per iteration = max(pool utilization, waiting/(2*slots))
    clamped to [0, 1] — either a full pool or a deep queue is
    overload — averaged over the last `window` observations. The stage
    steps UP (one stage per observation) when the mean crosses
    `up[stage]`, and steps DOWN only after the mean has sat below
    `down[stage-1]` for `hold` consecutive observations — the up/down
    threshold gap plus the dwell count is the hysteresis that keeps a
    noisy signal from oscillating the ladder (held in
    tests/test_torch_serving_tenants.py).

    Stage semantics live in the engine (0 = normal, 1 = shed
    speculative decoding, 2 = shrink prefill chunks, 3 = weighted
    prefix-cache eviction); the ladder only decides WHEN. Every
    transition lands in `history` — the engine turns each into a gauge
    update + trace event."""

    STAGE_NAMES = ('normal', 'shed_spec', 'shrink_prefill',
                   'weighted_evict')

    def __init__(self, window=8, up=(0.85, 0.92, 0.97),
                 down=(0.60, 0.70, 0.80), hold=4, clock=None):
        if len(up) != 3 or len(down) != 3:
            raise ValueError("up/down need one threshold per stage "
                             "transition (3 each)")
        if any(d >= u for u, d in zip(up, down)):
            raise ValueError(
                f"each down-threshold must sit below its up-threshold "
                f"for hysteresis (up={up}, down={down})")
        self.window = int(window)
        self.up = tuple(float(u) for u in up)
        self.down = tuple(float(d) for d in down)
        self.hold = int(hold)
        self.clock = clock or time.perf_counter
        self.stage = 0
        self._ring = collections.deque(maxlen=self.window)
        self._calm = 0                  # consecutive below-threshold
        self.history = []               # [{t, from, to, pressure}]
        self.transitions = 0

    @staticmethod
    def pressure_of(pool_utilization, waiting, slots, spill=0.0):
        """`spill` is the host-tier occupancy fraction:
        while the tier absorbs pool pressure by spilling, the pool-
        utilization signal alone under-reports how close the system is
        to REAL capacity — a saturating second tier must push the
        ladder toward stage-3 weighted eviction before allocation
        starts dropping prefixes outright. 0.0 (tierless) leaves the
        pool and queue signal as it is."""
        q = min(float(waiting) / max(2.0 * slots, 1.0), 1.0)
        return min(max(float(pool_utilization), q, float(spill)), 1.0)

    def pressure(self):
        """Windowed mean of the observed pressure (0.0 when empty)."""
        return (sum(self._ring) / len(self._ring)
                if self._ring else 0.0)

    def would_transition(self, pressure_signal, steps=1):
        """Would holding `pressure_signal` for the next `steps`
        observations move the stage? Pure simulation on COPIES of the
        ring/calm/stage state — the engine's fused-window quiescence
        guard: a k-iteration fused dispatch commits the
        engine to k observations it cannot react to mid-window, so it
        only engages when no stage transition is due within the
        window."""
        ring = collections.deque(self._ring, maxlen=self.window)
        calm = self._calm
        stage = self.stage
        sig = min(max(float(pressure_signal), 0.0), 1.0)
        for _ in range(int(steps)):
            ring.append(sig)
            p = sum(ring) / len(ring)
            if stage < 3 and p >= self.up[stage]:
                return True
            elif stage > 0 and p < self.down[stage - 1]:
                calm += 1
                if calm >= self.hold:
                    return True
            else:
                calm = 0
        return False

    def observe(self, pool_utilization, waiting, slots, spill=0.0):
        """Feed one iteration's raw signals; returns the transition
        dict when the stage changed this observation, else None."""
        self._ring.append(self.pressure_of(pool_utilization, waiting,
                                           slots, spill))
        p = self.pressure()
        prev = self.stage
        if self.stage < 3 and p >= self.up[self.stage]:
            self.stage += 1
            self._calm = 0
        elif self.stage > 0 and p < self.down[self.stage - 1]:
            self._calm += 1
            if self._calm >= self.hold:
                self.stage -= 1
                self._calm = 0
        else:
            self._calm = 0
        if self.stage == prev:
            return None
        ev = {'t': self.clock(), 'from': prev, 'to': self.stage,
              'pressure': round(p, 4)}
        self.history.append(ev)
        self.transitions += 1
        return ev


class RequestState:
    WAITING = 'waiting'
    PREFILL = 'prefill'
    RUNNING = 'running'
    FINISHED = 'finished'
    ABORTED = 'aborted'


_ids = itertools.count()


class Request:
    """One generation request. `tokens` is the full device-visible
    context (prompt + generated so far); `prefilled` counts how many of
    them already sit in KV pages."""

    def __init__(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                 temperature=0.0, top_k=0, tenant_id=None, priority=0,
                 deadline_s=None):
        self.id = next(_ids)
        self.prompt = [int(t) for t in prompt_ids]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        # tenancy: tenant_id groups quota/SLO accounting,
        # priority orders admission and bounds preemption, deadline_s
        # (relative to submit) drives deadline-aware admission
        self.tenant_id = (str(tenant_id) if tenant_id is not None
                          else None)
        self.priority = int(priority)
        self.deadline_s = (float(deadline_s) if deadline_s is not None
                           else None)
        self.quota_charged = False       # token bill debited at first
                                         # admit only (resume is free —
                                         # the preemptor paid)
        self.quota_defers = 0
        self.quota_deferred = False      # edge-detect for the
                                         # quota_defer trace event
        self.generated = []
        self.prefilled = 0
        self.state = RequestState.WAITING
        self.submit_time = None
        self.admit_time = None           # first admit (queue-wait end)
        self.admit_bypasses = 0          # followers admitted past this
                                         # request while it sat at the
                                         # queue head over-budget
                                         # (engine._admit starvation
                                         # bound)
        self.first_token_time = None
        self.finish_time = None
        self.preemptions = 0
        # engine-local sampling ordinal: assigned once at
        # engine.submit and folded with the absolute token position
        # into the device sampling key, so a request's sampled tokens
        # are a pure function of (seed, ordinal, position) — invariant
        # across fused/serial decode, spec verify, and preempt/resume
        self.sample_ord = None

    @property
    def tokens(self):
        return self.prompt + self.generated

    @property
    def context_len(self):
        return len(self.prompt) + len(self.generated)

    @property
    def done(self):
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and self.generated
                and self.generated[-1] == self.eos_token_id)

    def ttft_ms(self):
        if self.submit_time is None or self.first_token_time is None:
            return None
        return (self.first_token_time - self.submit_time) * 1000.0

    def output_ids(self):
        return list(self.tokens)


class Scheduler:
    """Slot table + admission queue. The engine drives it: `admit()`
    between steps, `preempt_victim()` when the pool is dry, `retire()`
    on completion. `self.waiting` stays in arrival order (preempts
    re-insert at the front); `admission_order()` is the priority view
    the engine sweeps — identical to arrival order when every request
    sits in the default class."""

    def __init__(self, num_slots, clock=None):
        self.num_slots = int(num_slots)
        self.slots = [None] * self.num_slots
        self.waiting = []
        self.finished = []
        self.preemptions = 0
        self.clock = clock or time.perf_counter

    def submit(self, request):
        request.submit_time = self.clock()
        request.state = RequestState.WAITING
        self.waiting.append(request)
        return request.id

    def running(self):
        return [r for r in self.slots if r is not None]

    def occupancy(self):
        return len(self.running()) / self.num_slots

    @property
    def has_work(self):
        return bool(self.waiting or self.running())

    def quiescent(self):
        """True when a multi-iteration decode window can run with no
        scheduling decision falling due mid-window (the fused-decode
        eligibility gate): nothing waiting to admit, at
        least one occupied slot, and every occupied slot a RUNNING
        decoder. Retires inside the window need no host decision —
        the fused done-mask idles finished rows on device and the
        engine retires them at window end; with an empty queue the
        held slot admits nobody late. Page growth (the only
        preemption trigger) is pre-reserved per window by the engine,
        and degrade-transition headroom is checked against the ladder
        separately."""
        if self.waiting:
            return False
        occupied = [r for r in self.slots if r is not None]
        if not occupied:
            return False
        return all(r.state == RequestState.RUNNING for r in occupied)

    def admission_order(self):
        """The queue in admission order: priority classes high to low,
        FCFS (arrival order, preempts first) within a class. A stable
        sort on -priority over the arrival-ordered list — with no
        tenants configured every priority is 0 and this IS the arrival
        order, so default scheduling is unchanged."""
        return sorted(self.waiting, key=lambda r: -r.priority)

    def admit(self, limit=None):
        """Fill free slots from the queue (priority-then-FCFS), at
        most `limit` of them (None = all). One body with
        `admit_request` below — this is the unconditional head-first
        loop; the engine's budgeted sweep picks specific requests via
        admit_request directly. The order is sorted ONCE per call:
        admitting never reorders the remaining queue (stable key), so
        re-sorting per admission would be pure waste on the host hot
        path."""
        admitted = []
        for req in self.admission_order():
            if limit is not None and len(admitted) >= limit:
                break
            if self.admit_request(req) is None:
                break
            admitted.append(req)
        return admitted

    def admit_request(self, request):
        """Admit one SPECIFIC waiting request into a free slot — the
        engine's head-of-line fairness path: when
        the queue head's first chunk exceeds the page budget this
        sweep, admissible followers behind it are admitted in FCFS
        order instead of starving behind the blocked head (which keeps
        its queue position and first claim on next sweep's budget).
        Returns the request, or None if it isn't waiting / no slot."""
        if request not in self.waiting:
            return None
        for i in range(self.num_slots):
            if self.slots[i] is None:
                self.waiting.remove(request)
                request.state = RequestState.PREFILL
                request.prefilled = 0
                if request.admit_time is None:
                    request.admit_time = self.clock()
                self.slots[i] = request
                return request
        return None

    def adopt(self, request):
        """Place a request prefilled by another engine straight into a
        free slot in RUNNING state (the disaggregated handoff: its pages
        were streamed into this engine's pool). Returns the slot index,
        or None when no slot is free."""
        for i in range(self.num_slots):
            if self.slots[i] is None:
                request.state = RequestState.RUNNING
                if request.admit_time is None:
                    request.admit_time = self.clock()
                self.slots[i] = request
                return i
        return None

    def slot_of(self, request):
        return self.slots.index(request)

    def preempt_victim(self, exclude=None, below_priority=None):
        """Preemption victim among running/prefilling requests,
        excluding `exclude`. With `below_priority` set (tenancy
        active), the victim is the YOUNGEST request (highest id ≈ last
        admitted) of the LOWEST priority class strictly below it — a
        high-priority admit displaces the least important, most
        recently started work first, and never a peer or better. With
        `below_priority` None (no tenants), the victim is the youngest
        overall — the original behavior, bit-for-bit. None if nobody
        qualifies."""
        candidates = [r for r in self.slots
                      if r is not None and r is not exclude]
        if not candidates:
            return None
        if below_priority is None:
            return max(candidates, key=lambda r: r.id)
        candidates = [r for r in candidates
                      if r.priority < below_priority]
        if not candidates:
            return None
        lowest = min(r.priority for r in candidates)
        return max((r for r in candidates if r.priority == lowest),
                   key=lambda r: r.id)

    def preempt(self, request):
        """Release the slot and push the request to the FRONT of the
        queue (it keeps FCFS priority over never-started work)."""
        i = self.slot_of(request)
        self.slots[i] = None
        request.state = RequestState.WAITING
        request.preemptions += 1
        self.preemptions += 1
        self.waiting.insert(0, request)

    def retire(self, request):
        i = self.slot_of(request)
        self.slots[i] = None
        request.state = RequestState.FINISHED
        request.finish_time = self.clock()
        self.finished.append(request)

    def abort(self, request):
        """Drop a request wherever it sits (queue or slot) — the
        watchdog's deadline_action='abort' path and operator kill.
        No-op on a request that already reached a terminal state (a
        double abort must not re-append to `finished` or restamp
        finish_time). Returns True if the request was aborted here."""
        if request.state in (RequestState.FINISHED,
                             RequestState.ABORTED):
            return False
        if request in self.waiting:
            self.waiting.remove(request)
        elif request in self.slots:
            self.slots[self.slots.index(request)] = None
        request.state = RequestState.ABORTED
        request.finish_time = self.clock()
        self.finished.append(request)
        return True


class SchedulerTimeline:
    """Ring buffer of per-iteration batch-composition records — what
    the engine actually ran each sweep. One dict per engine.step():

      iter, t, decode_slots_occupied, decode_slots, prefill_tokens,
      decode_tokens, admissions, preemptions, waiting,
      pool_pages_in_use, pool_pages_total

    `summary()` aggregates it into the occupancy-feedback numbers the
    bench leg and serve_snapshot() surface."""

    def __init__(self, capacity=2048):
        self._ring = collections.deque(maxlen=int(capacity))
        self.iterations = 0         # lifetime count (ring may be full)

    def record(self, **entry):
        entry['iter'] = self.iterations
        self.iterations += 1
        self._ring.append(entry)

    def tail(self, n=32):
        n = int(n)
        return list(self._ring)[-n:] if n else []

    def snapshot(self):
        return list(self._ring)

    def reset(self):
        self._ring.clear()
        self.iterations = 0

    def summary(self):
        rows = list(self._ring)
        if not rows:
            return {'iterations': 0}
        n = len(rows)
        slots = max(rows[-1].get('decode_slots', 1), 1)
        pool = max(rows[-1].get('pool_pages_total', 1), 1)
        decode_rows = [r for r in rows if r.get('decode_tokens')]
        return {
            'iterations': self.iterations,
            'window': n,
            'mean_decode_slots_occupied':
                sum(r.get('decode_slots_occupied', 0)
                    for r in rows) / n,
            'mean_occupancy':
                sum(r.get('decode_slots_occupied', 0)
                    for r in decode_rows) / (len(decode_rows) * slots)
                if decode_rows else 0.0,
            'mean_pool_utilization':
                sum(r.get('pool_pages_in_use', 0) for r in rows)
                / (n * pool),
            'prefill_tokens': sum(r.get('prefill_tokens', 0)
                                  for r in rows),
            'decode_tokens': sum(r.get('decode_tokens', 0)
                                 for r in rows),
            'admissions': sum(r.get('admissions', 0) for r in rows),
            'preemptions': sum(r.get('preemptions', 0) for r in rows),
            'max_waiting': max(r.get('waiting', 0) for r in rows),
            'degrade_stage': rows[-1].get('degrade_stage', 0),
            'max_degrade_stage': max(r.get('degrade_stage', 0)
                                     for r in rows),
            # fused decode: entries recorded for iterations
            # that ran INSIDE a fused window — the engine records one
            # entry per iteration, never per dispatch, so occupancy
            # and token sums stay comparable across fused/serial
            'fused_iterations': sum(1 for r in rows if r.get('fused')),
        }
