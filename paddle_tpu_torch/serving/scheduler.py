"""Continuous-batching scheduler (host side) — counterpart of
`paddle_tpu/serving/scheduler.py`, untenanted.

Orca-style iteration-level scheduling: requests join an admission queue,
claim a decode slot when one frees up, chunk-prefill their prompt, then
ride the batched decode step one token per iteration until EOS or
length, when the slot is re-filled at once. When the KV pool runs dry
the youngest request is preempted: its page mappings are dropped (pages
a prefix-sharing sibling still maps survive) and it re-queues at the
front with its generated tokens kept, so resume is a re-prefill of
prompt + generated.

Not ported yet: tenancy (`TenantTable`, `TokenBucket`, priorities),
the `DegradeLadder` and the `SchedulerTimeline` flight record.
"""
import itertools
import time


class RequestState:
    WAITING = 'waiting'
    PREFILL = 'prefill'
    RUNNING = 'running'
    FINISHED = 'finished'


_ids = itertools.count()


class Request:
    """One generation request. `tokens` is the full context (prompt +
    generated so far); `prefilled` counts how many already sit in KV
    pages. `top_k` > 0 samples from the temperature-scaled top-k set,
    0 decodes greedily; `sample_ord` is the engine-local ordinal its
    engine assigns at submit, folded with the token position into the
    sampling draw (scheduler.py:321-363 in the JAX package)."""

    def __init__(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                 temperature=0.0, top_k=0):
        self.id = next(_ids)
        self.prompt = [int(t) for t in prompt_ids]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.sample_ord = None
        self.generated = []
        self.prefilled = 0
        self.state = RequestState.WAITING
        self.submit_time = None
        self.admit_bypasses = 0          # followers admitted past this
                                         # request while it sat at the
                                         # queue head over-budget
        self.first_token_time = None
        self.preemptions = 0

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
        return (self.eos_token_id is not None and bool(self.generated)
                and self.generated[-1] == self.eos_token_id)

    def output_ids(self):
        return list(self.tokens)


class Scheduler:
    """Slot table + admission queue. The engine drives it:
    `admit_request()` between steps, `preempt_victim()` when the pool is
    dry, `retire()` on completion. `waiting` stays in arrival order
    (preempted requests re-insert at the front)."""

    def __init__(self, num_slots):
        self.num_slots = int(num_slots)
        self.slots = [None] * self.num_slots
        self.waiting = []
        self.preemptions = 0

    def submit(self, request):
        request.submit_time = time.perf_counter()
        request.state = RequestState.WAITING
        self.waiting.append(request)
        return request.id

    def running(self):
        return [r for r in self.slots if r is not None]

    @property
    def has_work(self):
        return bool(self.waiting or self.running())

    def quiescent(self):
        """True when a multi-iteration decode window can run with no
        scheduling decision falling due inside it (scheduler.py:421):
        nothing waiting to admit, at least one occupied slot, and every
        occupied slot a RUNNING decoder. Rows that finish inside the
        window idle on the card and retire at its end; page growth is
        reserved for the window up front by the engine."""
        if self.waiting:
            return False
        occupied = [r for r in self.slots if r is not None]
        return bool(occupied) and all(r.state == RequestState.RUNNING
                                      for r in occupied)

    def admission_order(self):
        """The queue in admission order: arrival order, preempted
        requests first."""
        return list(self.waiting)

    def admit_request(self, request):
        """Admit one specific waiting request into a free slot. Returns
        the request, or None if it isn't waiting or no slot is free."""
        if request not in self.waiting:
            return None
        for i in range(self.num_slots):
            if self.slots[i] is None:
                self.waiting.remove(request)
                request.state = RequestState.PREFILL
                request.prefilled = 0
                self.slots[i] = request
                return request
        return None

    def slot_of(self, request):
        return self.slots.index(request)

    def preempt_victim(self, exclude=None):
        """The youngest request (highest id ≈ last admitted) among those
        holding a slot, excluding `exclude`; None if nobody qualifies."""
        candidates = [r for r in self.slots
                      if r is not None and r is not exclude]
        if not candidates:
            return None
        return max(candidates, key=lambda r: r.id)

    def preempt(self, request):
        """Release the slot and push the request to the FRONT of the
        queue (it keeps FCFS priority over never-started work)."""
        self.slots[self.slot_of(request)] = None
        request.state = RequestState.WAITING
        request.preemptions += 1
        self.preemptions += 1
        self.waiting.insert(0, request)

    def retire(self, request):
        self.slots[self.slot_of(request)] = None
        request.state = RequestState.FINISHED
