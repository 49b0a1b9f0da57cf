"""Serving replicas behind the cluster router — counterpart of
`paddle_tpu/serving/cluster/replica.py`.

Two deployments share one request-hosting core (`_EngineHost`: submit,
poll with a capped ring of finished views, status, the metrics snapshot
for federation, drain, the advisory host-tier prefetch, abort,
export_trace, shutdown), over a `ServingEngine` or a
`DisaggregatedEngine`:

  * `LocalReplica` — in the router's process; the router's `pump()`
    steps its engine, so one process drives an n-replica cluster
    deterministically. Several may share one card.
  * `ReplicaWorker` + `RemoteReplica` — a worker PROCESS (`python -m
    paddle_tpu_torch.serving.cluster.replica`, spawned by
    `RemoteReplica.spawn`) that serves the TCP control channel
    (channel.py) and steps its engine in a loop of its own, stamping a
    heartbeat before every sweep. Each worker has its own host thread;
    several may share one card.

Hang handling: a watchdog thread watches the step loop's heartbeat.
When the replica has work and the heartbeat is older than
`hang_timeout_s`, it writes `replica_hang.<id>.json` (the flight
recorder's ring, every thread's stack, the request census) and a
`replica_hang` structured log line, and flags the replica hung in its
status. The router sees the flag (or the stale heartbeat, if the control
plane died too) and drains the replica; the worker stays up for a
post-mortem.

A worker prints `REPLICA_READY port=<port>` once its engine is warm, and
`REPLICA_EXIT <json>` as it stops: its kernel launch counts (they are
per process) and the engine counters those launches follow from.
`RemoteReplica` keeps that record as `exit_record`.
"""
import argparse
import collections
import json
import os
import queue
import subprocess
import sys
import threading
import time

from ..scheduler import AdmissionRejected, RequestState
from .channel import ControlClient, ControlServer
from .disagg import DisaggregatedEngine, build_engine

_TERMINAL = (RequestState.FINISHED, RequestState.ABORTED)
_MODULE = 'paddle_tpu_torch.serving.cluster.replica'


def _req_snapshot(rid, req):
    """The drain handoff record: everything a peer needs to resume this
    request (the prefix-resurrect semantics, one replica over). One
    definition for the healthy drain and the wedged-lock fallback."""
    return {
        'rid': rid,
        'prompt': list(req.prompt),
        'generated': list(req.generated),
        'max_new_tokens': req.max_new_tokens,
        'eos_token_id': req.eos_token_id,
        'temperature': req.temperature,
        'top_k': req.top_k,
    }


def _engines(engine):
    """The ServingEngines behind a replica's engine."""
    if isinstance(engine, DisaggregatedEngine):
        return (engine.prefill, engine.decode)
    return (engine,)


def _live_requests(engine):
    if isinstance(engine, DisaggregatedEngine):
        return engine.live_requests()
    return [r for r in engine.scheduler.slots if r is not None]


def _waiting_requests(engine):
    if isinstance(engine, DisaggregatedEngine):
        return engine.waiting_requests()
    return list(engine.scheduler.waiting)


def _has_work(engine):
    if isinstance(engine, DisaggregatedEngine):
        return engine.has_work
    return engine.scheduler.has_work


def _decode_engine(engine):
    return _engines(engine)[-1]


def _prefix_digest(engine, limit=4096):
    """Where a prefill would hit: a disaggregated replica publishes the
    union of both pools (decode-side pages are mapped at the handoff)."""
    if isinstance(engine, DisaggregatedEngine):
        d = set(engine.prefill.pool.prefix_chain_hashes(limit))
        d.update(engine.decode.pool.prefix_chain_hashes(limit))
        return list(d)
    return engine.pool.prefix_chain_hashes(limit)


def _goodput(engine):
    """The replica's goodput account: a disaggregated replica's prefill
    engine priced the prompt positions on its own ledger, so both fold
    into one account of the whole pipeline's token stream."""
    goodput = _decode_engine(engine).ledger.goodput()
    if not isinstance(engine, DisaggregatedEngine):
        return goodput
    g2 = engine.prefill.ledger.goodput()
    for k in ('emitted_tokens', 'delivered_tokens', 'wasted_tokens',
              'spec_shed_tokens'):
        goodput[k] += g2[k]
    for c, v in g2['wasted_by_cause'].items():
        goodput['wasted_by_cause'][c] = \
            goodput['wasted_by_cause'].get(c, 0) + v
    for tid, row in g2['per_tenant'].items():
        dst = goodput['per_tenant'].setdefault(
            tid, {'delivered_tokens': 0, 'wasted_tokens': 0})
        dst['delivered_tokens'] += row['delivered_tokens']
        dst['wasted_tokens'] += row['wasted_tokens']
    goodput['goodput_fraction'] = (
        goodput['delivered_tokens'] / goodput['emitted_tokens']
        if goodput['emitted_tokens'] else None)
    return goodput


class _EngineHost:
    """Request hosting over one engine, shared by LocalReplica and
    ReplicaWorker. Engine access is serialized by self._lock: a worker's
    channel threads race its step loop."""

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
            eng = _decode_engine(self.engine)
            live = [r for r in _live_requests(self.engine)
                    if r.state not in _TERMINAL]
            waiting = _waiting_requests(self.engine)
            pending_tokens = sum(
                max(r.max_new_tokens - len(r.generated), 0)
                + max(len(r.prompt) - r.prefilled, 0)
                for r in live + waiting)
            return {
                'replica_id': self.replica_id,
                'beat_age_s': now - self._beat,
                'hung': self._hung,
                'hang_reason': self._hang_reason,
                'draining': self._draining,
                'waiting': len(waiting),
                'in_flight': len(live),
                'pending_tokens': pending_tokens,
                'decode_tokens_per_sec': eng.decode_rate(),
                'degrade_stage': eng.degrade_stage(),
                # a fused engine reports at window granularity
                'fused_k': eng._effective_fused_k(),
                'fused_windows_total': eng._fused_windows,
                'fused_iterations_total': eng._fused_iterations,
                'timeline': eng.timeline.summary(),
                'pool': {'pages_in_use': eng.pool.pages_in_use,
                         'num_pages': eng.pool.num_pages},
                'prefix_digest': _prefix_digest(self.engine),
                'goodput': _goodput(self.engine),
                # account() is None until the engine iterated
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
            eng = _decode_engine(self.engine)
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
                # under the abort is already in its snapshot, and the
                # router's own record decides whether it needs a peer
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
        """Test hook: the step loop stops stepping and stamping the
        heartbeat (the control plane keeps answering), which is what a
        wedged device dispatch looks like to the router."""
        self._inject_hang = True
        return {'ok': True}


class LocalReplica(_EngineHost):
    """In-process replica: the router pumps its engine directly."""

    def pump(self):
        if self._inject_hang:
            return False
        with self._lock:
            self._beat = self._clock()
            if _has_work(self.engine):
                self.engine.step()
                return True
        return False


class ReplicaWorker(_EngineHost):
    """A replica process: the control channel, the engine's step loop and
    the hang watchdog. `run()` blocks in the step loop (the worker
    process's main thread); `start()` runs it on a thread (in-process
    tests)."""

    def __init__(self, engine, replica_id, port=0, hang_timeout_s=10.0,
                 report_dir=None, clock=None):
        super().__init__(engine, replica_id, clock=clock)
        self.hang_timeout_s = float(hang_timeout_s)
        self.report_dir = report_dir
        self.last_hang_report_path = None
        self._stop = threading.Event()
        self.server = ControlServer(self._handle, port=port).start()
        self.port = self.server.port
        self._watchdog = threading.Thread(
            target=self._watch_loop, name='replica-watchdog', daemon=True)
        self._watchdog.start()
        self._loop_thread = None

    # -- control channel -----------------------------------------------------
    def _handle(self, msg):
        op = msg.get('op')
        if op == 'submit':
            try:
                return {'rid': self.submit(msg['prompt'],
                                           msg.get('opts') or {},
                                           msg.get('route'))}
            except AdmissionRejected as e:
                # a structured refusal, not a channel error: the router
                # re-raises it with its hint and drains nothing
                return {'rejected': {
                    'reason': e.reason, 'retry_after_s': e.retry_after_s,
                    'estimated_s': e.estimated_s,
                    'deadline_s': e.deadline_s}}
        if op == 'poll':
            return {'reqs': self.poll()}
        if op == 'status':
            return self.status()
        if op == 'metrics':
            return self.metrics()
        if op == 'drain':
            return {'inflight': self.drain()}
        if op == 'abort':
            return {'ok': self.abort(msg.get('rid'))}
        if op == 'prefetch':
            return self.prefetch(msg.get('prompt') or [])
        if op == 'export_trace':
            return {'path': self.export_trace(msg['path'])['jsonl']}
        if op == 'inject_hang':
            return self.inject_hang()
        if op == 'shutdown':
            self._stop.set()
            return {'ok': True}
        raise ValueError(f"unknown control op {op!r}")

    # status(), metrics() and drain() run on a control thread and do not
    # wait for a wedged step loop: past 0.5 s they answer from the host
    # lists, so health probes never join the hang
    def status(self):
        if self._lock.acquire(timeout=0.5):
            try:
                return _EngineHost.status(self)
            finally:
                self._lock.release()
        return {
            'replica_id': self.replica_id,
            'beat_age_s': self._clock() - self._beat,
            'hung': self._hung,
            'hang_reason': self._hang_reason,
            'draining': self._draining,
            'waiting': len(_waiting_requests(self.engine)),
            'in_flight': len([r for r in _live_requests(self.engine)
                              if r.state not in _TERMINAL]),
            'pending_tokens': 0,
            'decode_tokens_per_sec': 0.0,
            'degrade_stage': 0,
            'fused_k': 1,
            'fused_windows_total': 0,
            'fused_iterations_total': 0,
            'timeline': {},
            'pool': {},
            'prefix_digest': None,      # the router keeps its last view
            'tenancy': None,
        }

    def metrics(self):
        # a stale beat_age_s and an empty series are the signal
        if self._lock.acquire(timeout=0.5):
            try:
                return _EngineHost.metrics(self)
            finally:
                self._lock.release()
        return {'replica_id': self.replica_id,
                'beat_age_s': self._clock() - self._beat, 'series': {}}

    def drain(self):
        if self._lock.acquire(timeout=0.5):
            try:
                return _EngineHost.drain(self)
            finally:
                self._lock.release()
        # wedged: report what is known and abort nothing (the step loop
        # holds the lock); the router resubmits from the snapshots
        self._draining = True
        return [_req_snapshot(rid, req)
                for rid, req in list(self._reqs.items())
                if req.state not in _TERMINAL]

    # -- step loop and watchdog ------------------------------------------------
    def run(self):
        while not self._stop.is_set():
            if self._inject_hang:
                # a simulated wedged dispatch: no heartbeat, no lock
                time.sleep(0.05)
                continue
            self._beat = self._clock()
            with self._lock:
                busy = _has_work(self.engine)
                if busy:
                    self.engine.step()
            if not busy:
                time.sleep(0.002)

    def start(self):
        self._loop_thread = threading.Thread(
            target=self.run, name='replica-step-loop', daemon=True)
        self._loop_thread.start()
        return self

    def stop(self, timeout=10.0):
        """Stop the step loop, the watchdog and the control server, and
        join their threads."""
        self._stop.set()
        self.server.close()
        for t in (self._loop_thread, self._watchdog):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=timeout)

    def _watch_loop(self):
        fired = False
        while not self._stop.wait(min(self.hang_timeout_s / 4, 0.5)):
            age = self._clock() - self._beat
            busy = self._inject_hang or bool(self._reqs)
            if busy and age > self.hang_timeout_s and not fired:
                fired = True
                self._fire_watchdog(
                    f"step loop heartbeat stale for {age:.1f}s "
                    f"(timeout {self.hang_timeout_s}s)")

    def _fire_watchdog(self, reason):
        """Diagnose and dump a wedged step loop: the flight recorder's
        ring, every thread's stack (where the loop is stuck) and the
        request census, as `replica_hang.<id>.json` in report_dir (else
        $PTPU_SERVE_REPORT_DIR, else $FLEET_LOG_DIR); then flag the
        replica hung, which the router drains on."""
        self._hung = True
        self._hang_reason = reason
        doc = {'kind': 'replica_hang_report',
               'replica_id': self.replica_id,
               'reason': reason,
               'hang_timeout_s': self.hang_timeout_s,
               'waiting': len(_waiting_requests(self.engine)),
               'in_flight': len(_live_requests(self.engine)),
               'requests': {rid: {'state': r.state,
                                  'tokens_generated': len(r.generated)}
                            for rid, r in list(self._reqs.items())}}
        from ...distributed import flight_recorder as _fr
        doc['flight_recorder'] = _fr.recorder().dump()
        doc['stacks'] = _fr._thread_stacks()
        d = (self.report_dir or os.environ.get('PTPU_SERVE_REPORT_DIR')
             or os.environ.get('FLEET_LOG_DIR'))
        if d:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f'replica_hang.{self.replica_id}.json')
            with open(path, 'w') as f:
                json.dump(doc, f, indent=1, default=str)
            self.last_hang_report_path = path
        from ...distributed.fleet.utils.log_util import log_json
        log_json('replica_hang', level='error',
                 msg=f"serving replica {self.replica_id} hung: {reason}",
                 replica=self.replica_id, reason=reason,
                 report_path=self.last_hang_report_path)

    def exit_record(self):
        """What the worker prints as it stops: this process's kernel
        launches and each engine's counters that determine them."""
        from ...ops.kernels import _build
        keys = ('prefill_chunks_total', 'decode_steps_total',
                'fused_iterations_total', 'fused_windows_total', 'fused_k',
                'requests_completed_total', 'requests_aborted_total')
        return {'replica_id': self.replica_id,
                'device': str(_decode_engine(self.engine).device),
                'launches': _build.routes_snapshot(),
                'engines': [{k: e.stats()[k] for k in keys}
                            for e in _engines(self.engine)]}

    def pump(self):
        return False        # the worker's own loop does the stepping


class RemoteReplica:
    """The router's handle on a ReplicaWorker over its control channel."""

    def __init__(self, replica_id, host, port, proc=None, timeout=30.0):
        self.replica_id = str(replica_id)
        self.client = ControlClient(host, port, timeout=timeout)
        self.proc = proc
        self.returncode = None
        self.exit_record = None
        self.output = collections.deque(maxlen=200)   # worker lines
        self._reader = None

    @classmethod
    def spawn(cls, replica_id, model_config, engine_config=None, seed=0,
              hang_timeout_s=10.0, env=None, ready_timeout_s=300.0,
              device=None, dtype=None):
        """Start `python -m paddle_tpu_torch.serving.cluster.replica` and
        connect once it prints REPLICA_READY: the model is built and the
        engine warmed before readiness, so the router never sees a
        cold-start heartbeat stall. A reader thread drains the worker's
        output into a queue, so the readiness deadline holds even
        against a worker that wedges silently."""
        cmd = [sys.executable, '-u', '-m', _MODULE,
               '--replica-id', str(replica_id), '--port', '0',
               '--seed', str(seed), '--hang-timeout', str(hang_timeout_s),
               '--model-config', json.dumps(model_config),
               '--engine-config', json.dumps(engine_config or {})]
        if device is not None:
            cmd += ['--device', str(device)]
        if dtype is not None:
            cmd += ['--dtype', str(dtype).replace('torch.', '')]
        full_env = dict(os.environ)
        # the worker imports this checkout's package
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        full_env['PYTHONPATH'] = os.pathsep.join(
            [root] + [p for p in full_env.get('PYTHONPATH', '').split(
                os.pathsep) if p])
        full_env.update(env or {})
        proc = subprocess.Popen(cmd, env=full_env, stdin=subprocess.DEVNULL,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        q = queue.Queue()

        def _reader():
            for line in proc.stdout:        # drains after readiness too
                q.put(line)
            q.put(None)

        reader = threading.Thread(target=_reader, daemon=True,
                                  name=f'replica-{replica_id}-reader')
        reader.start()
        deadline = time.time() + ready_timeout_s
        port = None
        lines = []
        while time.time() < deadline:
            try:
                line = q.get(timeout=min(
                    1.0, max(deadline - time.time(), 0.01)))
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            if line is None:
                break
            lines.append(line.rstrip())
            if line.startswith('REPLICA_READY'):
                port = int(line.split('port=')[1].strip())
                break
        if port is None:
            proc.kill()
            proc.wait(timeout=10)
            tail = '\n'.join(lines[-20:])
            raise RuntimeError(
                f"replica {replica_id} never became ready:\n{tail}")
        rep = cls(replica_id, '127.0.0.1', port, proc=proc)
        rep.output.extend(lines)
        rep._reader = threading.Thread(
            target=rep._collect, args=(q,), daemon=True,
            name=f'replica-{replica_id}-output')
        rep._reader.start()
        return rep

    def _collect(self, q):
        while True:
            line = q.get()
            if line is None:
                return
            line = line.rstrip()
            self.output.append(line)
            if line.startswith('REPLICA_EXIT '):
                self.exit_record = json.loads(line[len('REPLICA_EXIT '):])

    def submit(self, prompt, opts, route_meta=None):
        reply = self.client.call({'op': 'submit',
                                  'prompt': [int(t) for t in prompt],
                                  'opts': opts, 'route': route_meta})
        rej = reply.get('rejected')
        if rej is not None:
            raise AdmissionRejected(
                rej.get('reason', 'rejected'),
                retry_after_s=rej.get('retry_after_s'),
                estimated_s=rej.get('estimated_s'),
                deadline_s=rej.get('deadline_s'))
        return reply['rid']

    def poll(self):
        return self.client.call({'op': 'poll'}, timeout=30.0)['reqs']

    def status(self):
        return self.client.call({'op': 'status'}, timeout=5.0)

    def metrics(self):
        return self.client.call({'op': 'metrics'}, timeout=5.0)

    def drain(self):
        return self.client.call({'op': 'drain'}, timeout=5.0)['inflight']

    def abort(self, rid):
        return self.client.call({'op': 'abort', 'rid': rid})['ok']

    def prefetch(self, prompt):
        return self.client.call({'op': 'prefetch',
                                 'prompt': [int(t) for t in prompt]},
                                timeout=30.0)

    def export_trace(self, jsonl_path):
        return self.client.call({'op': 'export_trace', 'path': jsonl_path},
                                timeout=30.0)

    def inject_hang(self):
        return self.client.call({'op': 'inject_hang'})

    def pump(self):
        return False        # a remote worker steps itself

    def shutdown(self, timeout=30.0):
        """Ask the worker to stop, close the channel and, for a spawned
        worker, wait for it to exit (killed past `timeout`) and for its
        last output line; `returncode` is its exit code."""
        try:
            self.client.call({'op': 'shutdown'}, timeout=5.0)
        except (OSError, RuntimeError, ValueError):
            pass            # already gone: the wait below says how
        self.client.close()
        if self.proc is None:
            return
        try:
            self.returncode = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.returncode = self.proc.wait(timeout=10)
        if self._reader is not None:
            self._reader.join(timeout=10)


def worker_model(model_config, seed, device=None, dtype=None):
    """The worker's model: GPTForCausalLM over GPTConfig(**model_config),
    its weights drawn from a torch.Generator on `device` (the card by
    default) seeded with `seed`, in eval mode. A reference built by this
    function from the same seed on the same device holds the same
    weights (the CPU and the card draw different numbers)."""
    import torch

    from ...device import resolve_device
    from ...models.gpt import GPTConfig, GPTForCausalLM
    dev = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    model = GPTForCausalLM(
        GPTConfig(**model_config), device=dev, dtype=dtype,
        generator=torch.Generator(device=dev).manual_seed(int(seed)))
    model.eval()
    return model


# ---------------------------------------------------------------------------
# the worker's entry point: python -m paddle_tpu_torch.serving.cluster.replica
# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser('paddle_tpu_torch serving replica worker')
    ap.add_argument('--replica-id',
                    default=os.environ.get('PADDLE_TRAINER_ID', '0'))
    ap.add_argument('--port', type=int, default=0)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--hang-timeout', type=float, default=10.0)
    ap.add_argument('--model-config', default='{}',
                    help='GPTConfig kwargs (JSON)')
    ap.add_argument('--engine-config', default='{}',
                    help='ServingConfig kwargs (JSON)')
    ap.add_argument('--device', default=None,
                    help="the engine's device (default: the card)")
    ap.add_argument('--dtype', default=None,
                    help="the model's dtype, e.g. 'bfloat16' (default: "
                         "the port's parameter default)")
    ap.add_argument('--mp', type=int, default=1,
                    help='mp degree inside this replica (only 1)')
    args = ap.parse_args(argv)
    if args.mp != 1:
        raise SystemExit('--mp > 1: the mp-sharded serving route is not '
                         'ported yet (ROADMAP Queue 1 item 7, multi-GPU)')

    from ...ops.kernels import _build
    from ..engine import ServingConfig
    model = worker_model(json.loads(args.model_config), args.seed,
                         device=args.device, dtype=args.dtype)
    engine = build_engine(model, ServingConfig(
        **json.loads(args.engine_config)), device=args.device)
    # warm up BEFORE readiness, so first live traffic finds no cold start
    engine.generate([[1, 2, 3]], max_new_tokens=2, top_k=0)
    engine.reset_stats()
    _build.reset_launches()
    worker = ReplicaWorker(engine, args.replica_id, port=args.port,
                           hang_timeout_s=args.hang_timeout)
    print(f'REPLICA_READY port={worker.port}', flush=True)
    try:
        worker.run()
    finally:
        worker.stop()
    print('REPLICA_EXIT ' + json.dumps(worker.exit_record()), flush=True)
    engine.shutdown()


if __name__ == '__main__':
    main()
