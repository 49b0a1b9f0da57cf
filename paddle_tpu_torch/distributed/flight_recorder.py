"""Flight recorder and hang watchdog — counterpart of
`paddle_tpu/distributed/flight_recorder.py`.

  * `FlightRecorder` — a per-rank fixed-size ring journal. Every
    journaled operation records (seq, op, group, shape, bytes, enqueue
    ts) on entry and stamps a completion ts on exit; `seq` is process-
    monotonic, and a collective may add its group-level sequence number
    (`gseq`), the number that must advance in lockstep across ranks.
    The engines stamp a step heartbeat on every warm step and journal
    each step as a span.
  * `HangWatchdog` — a daemon thread that declares "no progress" when
    the oldest incomplete journal entry is older than `timeout`, or the
    step heartbeat has gone stale, and writes a dump of the journal and
    every Python thread's stack.
  * `analyze(dumps)` turns per-rank journals into the cross-rank
    verdict (last completed and first missing group seq per rank, the
    stalled ranks); `render_dump` renders a dump or a report.

On one card the watchdog dumps this rank's journal locally; the
reference's cross-rank exchange of dumps over a TCPStore comes with the
multi-card port. The engines' `shutdown` calls `engine_teardown`, which
stops the env-gated watchdog and disarms the heartbeat.
"""
import contextlib
import json
import os
import sys
import threading
import time
import traceback

__all__ = ['FlightRecorder', 'recorder', 'record_span', 'heartbeat',
           'HangWatchdog', 'analyze', 'render_dump', 'start_watchdog',
           'stop_watchdog', 'engine_teardown']

_DISABLED = os.environ.get('PADDLE_FLIGHT_RECORDER', '1') in ('0', 'off')


def _env_int(name, default):
    try:
        return int(os.environ.get(name, '') or default)
    except ValueError:
        return default


class FlightRecorder:
    """Fixed-size ring journal of collective operations (thread-safe)."""

    def __init__(self, capacity=512, rank=None):
        self.capacity = int(capacity)
        if self.capacity <= 0:
            raise ValueError("flight recorder capacity must be >= 1")
        self.rank = _env_int('PADDLE_TRAINER_ID', 0) \
            if rank is None else int(rank)
        self._lock = threading.Lock()
        self._entries = {}            # seq -> entry (only in-ring seqs)
        self._order = []              # ring of live seqs, oldest first
        self._seq = 0
        self._dropped = 0
        self._completed = 0
        self._last_completed = 0
        self._last_beat = None        # step heartbeat (engines stamp it)

    # -- journal -------------------------------------------------------------
    def record_enqueue(self, op, group=0, gseq=None, shape=None,
                       nbytes=0, mode='eager'):
        """Journal a collective entering its transport; returns the
        process-monotonic seq used to stamp completion."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            entry = {
                'seq': seq, 'op': str(op), 'group': group,
                'gseq': gseq, 'shape': list(shape) if shape else None,
                'bytes': int(nbytes), 'mode': mode,
                't_enqueue': time.time(), 't_complete': None, 'ok': None,
            }
            self._entries[seq] = entry
            self._order.append(seq)
            if len(self._order) > self.capacity:
                # evict the oldest COMPLETED entry: a pending one is the
                # hang evidence this ring exists to keep — evicting it
                # would disarm the watchdog's stalled-collective check
                # mid-hang and erase the hung op from the dump. All
                # pending (pathological) falls back to oldest-any so
                # memory stays bounded.
                for i, s in enumerate(self._order):
                    if self._entries[s]['t_complete'] is not None:
                        old = self._order.pop(i)
                        break
                else:
                    old = self._order.pop(0)
                self._entries.pop(old, None)
                self._dropped += 1
            return seq

    def record_complete(self, seq, ok=True):
        with self._lock:
            self._completed += 1
            self._last_completed = max(self._last_completed, seq)
            e = self._entries.get(seq)
            if e is not None:        # may have wrapped out of the ring
                e['t_complete'] = time.time()
                e['ok'] = bool(ok)

    @contextlib.contextmanager
    def span(self, op, group=0, gseq=None, shape=None, nbytes=0,
             mode='eager'):
        seq = self.record_enqueue(op, group=group, gseq=gseq, shape=shape,
                                  nbytes=nbytes, mode=mode)
        ok = True
        try:
            yield seq
        except BaseException:
            ok = False
            raise
        finally:
            self.record_complete(seq, ok=ok)

    def heartbeat(self):
        """Stamp step-level liveness (engines call this per train step)."""
        with self._lock:
            self._last_beat = time.time()

    def clear_heartbeat(self):
        """Disarm step-liveness detection (engine teardown: a stale beat
        after a deliberate stop is not a hang)."""
        with self._lock:
            self._last_beat = None

    # -- queries -------------------------------------------------------------
    def seq(self):
        with self._lock:
            return self._seq

    def last_completed_seq(self):
        with self._lock:
            return self._last_completed

    def first_incomplete(self):
        """Oldest journal entry still lacking a completion stamp."""
        with self._lock:
            for s in self._order:
                e = self._entries[s]
                if e['t_complete'] is None:
                    return dict(e)
        return None

    def last_beat(self):
        with self._lock:
            return self._last_beat

    def entries(self):
        with self._lock:
            return [dict(self._entries[s]) for s in self._order]

    def dropped(self):
        with self._lock:
            return self._dropped

    def dump(self):
        with self._lock:
            entries = [dict(self._entries[s]) for s in self._order]
            last_gseq = None
            first_missing_gseq = None
            first_missing_op = None
            for e in entries:
                if e['gseq'] is None:
                    continue
                if e['t_complete'] is not None:
                    if last_gseq is None or e['gseq'] > last_gseq:
                        last_gseq = e['gseq']
                elif first_missing_gseq is None:
                    first_missing_gseq = e['gseq']
                    first_missing_op = e['op']
            return {
                'kind': 'flight_recorder',
                'rank': self.rank,
                'pid': os.getpid(),
                'time': time.time(),
                'capacity': self.capacity,
                'dropped': self._dropped,
                'seq': self._seq,
                'completed': self._completed,
                'last_completed_seq': self._last_completed,
                'last_completed_gseq': last_gseq,
                'first_incomplete_gseq': first_missing_gseq,
                'first_incomplete_op': first_missing_op,
                'last_heartbeat': self._last_beat,
                'entries': entries,
            }

    def reset(self):
        with self._lock:
            self._entries.clear()
            self._order = []
            self._seq = 0
            self._dropped = 0
            self._completed = 0
            self._last_completed = 0
            self._last_beat = None


_recorder = FlightRecorder(
    capacity=max(1, _env_int('PADDLE_FLIGHT_RECORDER_CAPACITY', 512)))


def recorder():
    return _recorder


def heartbeat():
    if not _DISABLED:
        _recorder.heartbeat()


def engine_teardown():
    """Called by the engines' shutdown(): stop the env-gated watchdog
    and disarm the step heartbeat, so a deliberate stop cannot fire a
    false hang report."""
    stop_watchdog()
    _recorder.clear_heartbeat()


@contextlib.contextmanager
def record_span(op, group=0, gseq=None, shape=None, nbytes=0,
                mode='eager'):
    """Journal one collective through the process-global recorder (the
    hot-path entry point; no-op ring write when disabled via env)."""
    if _DISABLED:
        yield None
        return
    with _recorder.span(op, group=group, gseq=gseq, shape=shape,
                        nbytes=nbytes, mode=mode) as seq:
        yield seq


def _thread_stacks():
    """JSON-able Python stacks of every live thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for tid, frame in sys._current_frames().items():
        stacks[f'{names.get(tid, "?")}:{tid}'] = \
            traceback.format_stack(frame)
    return stacks


# ---------------------------------------------------------------------------
# cross-rank analysis
# ---------------------------------------------------------------------------
def analyze(dumps):
    """`dumps`: {rank: dump-dict-or-None}. Returns the cross-rank hang
    verdict: per-rank last-completed / first-missing group seq, the
    fleet-wide frontier, and human sentences naming the stalled ranks
    ("rank 1 never entered all_reduce gseq=4")."""
    ranks = {}
    frontier = None
    for r, d in sorted(dumps.items()):
        if not d:
            ranks[int(r)] = None
            continue
        row = {
            'last_completed_seq': d.get('last_completed_seq'),
            'last_completed_gseq': d.get('last_completed_gseq'),
            'first_incomplete_gseq': d.get('first_incomplete_gseq'),
            'first_incomplete_op': d.get('first_incomplete_op'),
            'dropped': d.get('dropped'),
            'last_heartbeat': d.get('last_heartbeat'),
        }
        ranks[int(r)] = row
        # the frontier is the furthest collective any rank ATTEMPTED —
        # a pending entry counts (the blocked rank got there; the rank
        # that never entered it is the suspect)
        for g in (row['last_completed_gseq'],
                  row['first_incomplete_gseq']):
            if g is not None:
                frontier = g if frontier is None else max(frontier, g)

    # name of the op at a given gseq, learned from any rank that saw it
    op_at = {}
    for d in dumps.values():
        for e in (d or {}).get('entries', ()):
            if e.get('gseq') is not None:
                op_at.setdefault(e['gseq'], e['op'])

    stalled, summary = [], []
    for r, row in sorted(ranks.items()):
        if row is None:
            stalled.append(r)
            summary.append(f"rank {r}: no dump received — process dead "
                           "or unreachable")
            continue
        last = row['last_completed_gseq']
        pend = row['first_incomplete_gseq']
        if pend is not None:
            summary.append(
                f"rank {r}: entered {row['first_incomplete_op']} "
                f"gseq={pend} but never completed it "
                f"(last completed gseq={last})")
        elif frontier is not None and (last is None or last < frontier):
            missing = 0 if last is None else last + 1
            op = op_at.get(missing, '<unknown op>')
            stalled.append(r)
            summary.append(
                f"rank {r} never entered {op} gseq={missing} "
                f"(last completed gseq={last}) — suspect stalled rank")
        else:
            summary.append(f"rank {r}: at the fleet frontier "
                           f"(gseq={last})")
    return {'frontier_gseq': frontier, 'ranks': ranks,
            'stalled_ranks': stalled, 'summary': summary}


def render_dump(doc):
    """Human rendering of a watchdog report (or a bare per-rank dump)."""
    out = ['== flight recorder ' + '=' * 41]
    if doc.get('kind') == 'flight_recorder':       # single-rank dump
        doc = {'ranks': {doc['rank']: doc}, 'analysis': None,
               'reason': None}
    if doc.get('reason'):
        out.append(f"watchdog trigger: {doc['reason']}")
    ana = doc.get('analysis')
    if ana:
        out.append(f"fleet frontier gseq: {ana.get('frontier_gseq')}   "
                   f"stalled ranks: {ana.get('stalled_ranks')}")
        for line in ana.get('summary', ()):
            out.append('  ' + line)
    for r, d in sorted(doc.get('ranks', {}).items(),
                       key=lambda kv: int(kv[0])):
        out.append(f"-- rank {r} " + '-' * 49)
        if not d:
            out.append('  (no dump)')
            continue
        out.append(
            f"  seq={d.get('seq')} completed={d.get('completed')} "
            f"last_gseq={d.get('last_completed_gseq')} "
            f"pending_gseq={d.get('first_incomplete_gseq')} "
            f"dropped={d.get('dropped')}")
        for e in d.get('entries', [])[-8:]:
            state = 'ok' if e.get('t_complete') else 'PENDING'
            gseq = e.get('gseq')
            out.append(
                f"  seq={e['seq']:<5} {e['op']:<24} "
                f"group={e.get('group')} "
                + (f"gseq={gseq} " if gseq is not None else '')
                + f"bytes={e.get('bytes', 0)} [{state}]")
    return '\n'.join(out)


class HangWatchdog:
    """No-progress detector over the flight recorder, on one rank.

    Triggers when (a) the oldest incomplete journal entry is older than
    `timeout` seconds, or (b) a step heartbeat was ever recorded and has
    been stale for `timeout`. On trigger it dumps the journal and every
    Python thread's stack into one report under `dump_dir`
    (`flight_recorder.rank<r>.<pid>.json`) and optionally aborts the
    process. Daemon-threaded; `stop()` is idempotent and joins.
    `clock` (time.time by default) is what the deadlines are read on.

    The reference also publishes the dump on a TCPStore and gathers the
    peer ranks' (a cross-rank report); that exchange comes with the
    multi-card port, and a `store` is refused until then.
    """

    def __init__(self, timeout=60.0, interval=None, store=None, rank=None,
                 world_size=None, dump_dir=None, recorder=None,
                 on_dump=None, abort=False, clock=None):
        if store is not None:
            raise NotImplementedError(
                "HangWatchdog(store=...): the cross-rank dump exchange is "
                "not ported yet (ROADMAP Queue 1 item 7, the multi-card "
                "port); the watchdog dumps this rank's journal locally")
        self.timeout = float(timeout)
        self.interval = float(interval) if interval else \
            max(0.25, min(self.timeout / 4.0, 5.0))
        self.rank = _env_int('PADDLE_TRAINER_ID', 0) \
            if rank is None else int(rank)
        self.world_size = _env_int('PADDLE_TRAINERS_NUM', 1) \
            if world_size is None else int(world_size)
        if dump_dir is None:
            from ..core.memory import default_report_dir
            dump_dir = default_report_dir()
        self.dump_dir = dump_dir
        self.recorder = recorder if recorder is not None else _recorder
        self.on_dump = on_dump
        self.abort = abort
        self._clock = clock or time.time
        self.fired = threading.Event()
        self.fire_count = 0
        self.report_path = None
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name='ptpu-hang-watchdog', daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(2.0, self.interval * 3))
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False

    # -- detection -----------------------------------------------------------
    def _stall_reason(self, now):
        pending = self.recorder.first_incomplete()
        if pending is not None and \
                now - pending['t_enqueue'] > self.timeout:
            age = now - pending['t_enqueue']
            where = f"gseq={pending['gseq']}" if pending['gseq'] is not \
                None else f"seq={pending['seq']}"
            return (f"collective {pending['op']} {where} pending for "
                    f"{age:.1f}s (> {self.timeout:.1f}s deadline)")
        beat = self.recorder.last_beat()
        if beat is not None and now - beat > self.timeout:
            return (f"step heartbeat stale for {now - beat:.1f}s "
                    f"(> {self.timeout:.1f}s deadline)")
        return None

    def _loop(self):
        while not self._stop.wait(self.interval):
            reason = self._stall_reason(self._clock())
            if reason is None:
                continue
            try:
                self._fire(reason)
            finally:
                self.fire_count += 1
                self.fired.set()
            if self.abort and not self._stop.is_set():
                os._exit(3)
            # episode latch: one report per stall. Wait for progress to
            # resume, then RE-ARM — a spurious fire (e.g. a timeout set
            # below a cold compile) must not disable detection of a real
            # hang later in the run.
            while not self._stop.wait(self.interval):
                if self._stall_reason(self._clock()) is None:
                    break

    # -- dump ------------------------------------------------------------------
    def _fire(self, reason):
        local = self.recorder.dump()
        local['stacks'] = _thread_stacks()
        local['watchdog_reason'] = reason
        dumps = {self.rank: local}
        report = {
            'kind': 'hang_report',
            'time': time.time(),
            'detector_rank': self.rank,
            'world_size': self.world_size,
            'reason': reason,
            'ranks': {str(r): d for r, d in dumps.items()},
            'analysis': analyze(dumps),
        }
        self.report_path = self._write(report)
        try:
            from .fleet.utils import log_util
            log_util.log_json(
                'hang_detected', level='error', reason=reason,
                report_path=self.report_path,
                stalled_ranks=report['analysis']['stalled_ranks'])
        except Exception:
            pass
        if self.on_dump is not None:
            try:
                self.on_dump(report)
            except Exception:
                pass
        return report

    def _write(self, report):
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f'flight_recorder.rank{self.rank}.{os.getpid()}.json')
            with open(path, 'w') as f:
                json.dump(report, f)
            return path
        except OSError:
            return None


# ---------------------------------------------------------------------------
# process-level convenience: env-gated singleton watchdog
# ---------------------------------------------------------------------------
_watchdog = None


def start_watchdog(timeout=None, **kwargs):
    """Start (once) the process watchdog over the global recorder. With
    no explicit `timeout` it is gated on PADDLE_HANG_TIMEOUT: the
    engines call this every warm step, so exporting that env is all a
    job needs."""
    global _watchdog
    if _watchdog is not None:
        return _watchdog
    if timeout is None:
        try:
            timeout = float(os.environ.get('PADDLE_HANG_TIMEOUT',
                                           '0') or 0)
        except ValueError:
            timeout = 0.0
        if timeout <= 0:
            return None
    _watchdog = HangWatchdog(timeout=timeout, **kwargs).start()
    return _watchdog


def stop_watchdog():
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None
