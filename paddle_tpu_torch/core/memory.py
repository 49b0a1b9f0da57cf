"""Device-memory forensics — counterpart of `paddle_tpu/core/memory.py`:
phase accounting and structured OOM reports over PyTorch's CUDA caching
allocator.

  * `MemoryAccountant.phase(name)` brackets init/build/step sites; it
    samples the allocator's bytes in use at entry and exit, keeps per-
    phase high-water marks and deltas, publishes `ptpu_mem_*` gauges, and
    tags tensors that became live inside a census phase with its name
    (origin spans for the OOM report).
  * `oom_report()` is a JSON-ready post-mortem: device limits, the per-
    phase high-water table, the recent phase timeline, the largest live
    tensors with their origin phase, and a suspect phase.
  * `oom_guard(site)` turns a `torch.cuda.OutOfMemoryError` (or any
    error whose text says the device ran out of memory) escaping `site`
    into a `DeviceOOMError` carrying that report, also written as JSON
    under the report dir.

Bytes come from `torch.cuda.memory_allocated()` and the allocator's peak
counter, which is process-global: the accountant never resets it (other
readers of `max_memory_allocated()` would lose their window). A phase's
high water is the larger of its boundary samples, and the global peak at
its exit when that peak rose inside the phase (then the peak happened
there); otherwise the in-phase peak is not observable and the boundary
samples stand.

The live-tensor census walks the garbage collector's objects for tensors
on the accountant's device (the card, or the CPU when there is none),
counting each storage once. It costs time in proportion to the heap, so
it runs only at `sample(count_buffers=True)`, at the exit of the coarse
census phases and at report time, never inside a step.

The reference's `record_compiled_memory` (XLA's buffer-assignment temp
bytes of a compiled step) has no counterpart: the port compiles no
program a step. `activation_bytes()` reports instead, for each step site
('<engine>.step'), the allocation high water of its first (warm-up) call
above the bytes in use at its entry, when the allocator's peak rose
inside that call.
"""
import collections
import contextlib
import gc
import json
import os
import tempfile
import threading
import time
import weakref

import torch

__all__ = [
    'MemoryAccountant', 'accountant', 'phase', 'sample', 'live_buffers',
    'live_buffer_count', 'oom_report', 'render_oom_report', 'oom_guard',
    'is_oom_error', 'DeviceOOMError', 'reset', 'activation_bytes',
    'default_report_dir', 'write_report',
]

_TIMELINE_CAP = 256
_CENSUS_PHASES = frozenset((
    'engine.init', 'engine.shutdown', 'pipeline.build', 'bench.leg'))


def _env_rank():
    try:
        return int(os.environ.get('PADDLE_TRAINER_ID', '0') or 0)
    except ValueError:
        return 0


def default_report_dir():
    """Where diagnostics artifacts (OOM reports, watchdog dumps) land:
    $FLEET_LOG_DIR, then $PADDLE_LOG_DIR, then the temp dir."""
    return (os.environ.get('FLEET_LOG_DIR')
            or os.environ.get('PADDLE_LOG_DIR') or tempfile.gettempdir())


def _device():
    """The card the accountant watches, or None without one."""
    if torch.cuda.is_available():
        return torch.device('cuda', torch.cuda.current_device())
    return None


def _device_stats():
    """(bytes_in_use, peak, limit) from the caching allocator, or Nones
    without a card. No call here waits on the card."""
    dev = _device()
    if dev is None:
        return None, None, None
    return (int(torch.cuda.memory_allocated(dev)),
            int(torch.cuda.max_memory_allocated(dev)),
            int(torch.cuda.get_device_properties(dev).total_memory))


def _census_device():
    dev = _device()
    return 'cuda' if dev is not None else 'cpu'


def _live_tensors():
    """{storage key: (nbytes, tensor)} of every live tensor on the census
    device, one entry a storage (the view with the most elements)."""
    want = _census_device()
    out = {}
    tensor = torch.Tensor
    for obj in gc.get_objects():
        # type(), not isinstance(): a module-level proxy object may warn
        # when its __class__ is read
        if not issubclass(type(obj), tensor):
            continue
        try:
            if obj.device.type != want or obj.is_meta:
                continue
            st = obj.untyped_storage()
            key = (st.data_ptr(), obj.device.index)
            nbytes = int(st.nbytes())
        except Exception:
            continue
        if not nbytes:
            continue
        prev = out.get(key)
        if prev is None or obj.numel() > prev[1].numel():
            out[key] = (nbytes, obj)
    return out


class DeviceOOMError(RuntimeError):
    """A device out-of-memory error enriched with the forensics report.
    `.report` holds the JSON-ready dict; str() renders the human table."""

    def __init__(self, message, report=None, report_path=None):
        super().__init__(message)
        self.report = report or {}
        self.report_path = report_path


def is_oom_error(exc):
    """True for the allocator's OutOfMemoryError and for an error whose
    text says the device ran out of memory."""
    if exc is None:
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    r = repr(exc)
    return ('RESOURCE_EXHAUSTED' in r or 'Out of memory' in r
            or 'out of memory' in r)


class MemoryAccountant:
    """Per-process device-memory bookkeeping (thread-safe singleton)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.reset()

    def reset(self):
        with self._lock:
            self._phases = collections.OrderedDict()
            self._timeline = collections.deque(maxlen=_TIMELINE_CAP)
            self._stack = []
            self._origins = {}          # id(tensor) -> (phase, weakref)
            self._py_peak = 0           # census-derived fallback peak
            self._activation = collections.OrderedDict()

    # -- sampling ------------------------------------------------------------
    def sample(self, count_buffers=False):
        """One snapshot: {'bytes_in_use', 'peak_bytes_in_use',
        'bytes_limit', 'live_buffers', 'live_bytes', 'activation_bytes'}.
        The census (live_buffers / live_bytes, and the bytes fallback
        without a card) runs only with `count_buffers`."""
        in_use, peak, limit = _device_stats()
        out = {'bytes_in_use': in_use, 'peak_bytes_in_use': peak,
               'bytes_limit': limit, 'live_buffers': None,
               'live_bytes': None,
               'activation_bytes': self.activation_bytes()}
        if count_buffers:
            live = _live_tensors()
            nbytes = sum(n for n, _t in live.values())
            out['live_buffers'] = len(live)
            out['live_bytes'] = nbytes
            out['live_device_bytes'] = nbytes
            if in_use is None:
                out['bytes_in_use'] = nbytes
                with self._lock:
                    self._py_peak = max(self._py_peak, nbytes)
                    out['peak_bytes_in_use'] = self._py_peak
        return out

    # -- step activation bytes -------------------------------------------------
    def record_activation(self, site, nbytes):
        """Record `site`'s activation bytes (the first step's allocation
        high water above its entry) and publish ptpu_mem_activation_bytes."""
        with self._lock:
            self._activation[site] = {'activation_bytes': int(nbytes)}
        from . import monitor as _m
        _m.gauge('ptpu_mem_activation_bytes',
                 help='a step site\'s first-call allocation high water '
                      'above its entry bytes, by site',
                 labelnames=('site',)).set(int(nbytes), site=site)
        return int(nbytes)

    def activation_bytes(self):
        """{site: activation bytes} of every recorded step site."""
        with self._lock:
            return {k: v['activation_bytes']
                    for k, v in self._activation.items()}

    def live_buffers(self, top=None, with_origin=True):
        """[(nbytes, shape, dtype, origin_phase)] sorted largest-first."""
        live = _live_tensors()
        with self._lock:
            origins = dict(self._origins) if with_origin else {}
        rows = [(n, tuple(t.shape), str(t.dtype).replace('torch.', ''),
                 self._origin_of(t, origins)) for n, t in live.values()]
        rows.sort(key=lambda r: -r[0])
        return rows[:top] if top else rows

    @staticmethod
    def _origin_of(t, origins):
        """Validated origin lookup: the entry's weakref must still point
        at THIS tensor (CPython recycles ids)."""
        ent = origins.get(id(t))
        if ent is None:
            return None
        phase_name, ref = ent
        if ref is not None and ref() is not t:
            return None
        return phase_name

    def live_buffer_count(self):
        return len(_live_tensors())

    @staticmethod
    def _live_ids():
        return {id(t) for _n, t in _live_tensors().values()}

    def _attribute_new(self, phase_name, pre_ids):
        """Tag tensors that became live between this phase's entry and
        exit with its name, and prune origins of freed tensors."""
        live_ids = set()
        with self._lock:
            for _n, t in _live_tensors().values():
                i = id(t)
                live_ids.add(i)
                ent = self._origins.get(i)
                stale = ent is not None and ent[1] is not None \
                    and ent[1]() is not t
                if stale or (ent is None and i not in pre_ids):
                    self._origins[i] = (phase_name, weakref.ref(t))
            for dead in set(self._origins) - live_ids:
                del self._origins[dead]

    # -- phases --------------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name, census=None):
        """Bracket a memory-relevant region. `census=True` forces the
        live-tensor walk at the boundary (the default only for the coarse
        lifecycle phases, so per-step sites stay cheap)."""
        census = (name in _CENSUS_PHASES) if census is None else census
        pre_ids = self._live_ids() if census else set()
        enter = self.sample(count_buffers=census)
        t0 = time.time()
        self._stack.append(name)
        try:
            yield self
        finally:
            self._stack.pop()
            exit_ = self.sample(count_buffers=census)
            if census:
                self._attribute_new(name, pre_ids)
            self._record(name, enter, exit_, t0)

    def current_phase(self):
        return self._stack[-1] if self._stack else None

    def _record(self, name, enter, exit_, t0):
        e_in = enter.get('bytes_in_use') or 0
        x_in = exit_.get('bytes_in_use') or 0
        high = max(e_in, x_in)
        p_in, p_out = enter.get('peak_bytes_in_use'), \
            exit_.get('peak_bytes_in_use')
        peak_inside = (p_in is not None and p_out is not None
                       and p_out > p_in)
        if peak_inside:
            high = max(high, p_out)
        first_step = False
        with self._lock:
            ph = self._phases.get(name)
            if ph is None:
                ph = self._phases[name] = {
                    'calls': 0, 'bytes_enter': 0, 'bytes_exit': 0,
                    'high_water': 0, 'max_delta': 0, 'last_delta': 0,
                    'live_buffers': None, 'seconds': 0.0}
                first_step = name.endswith('.step')
            ph['calls'] += 1
            ph['bytes_enter'] = e_in
            ph['bytes_exit'] = x_in
            ph['high_water'] = max(ph['high_water'], high)
            ph['last_delta'] = x_in - e_in
            ph['max_delta'] = max(ph['max_delta'], x_in - e_in)
            ph['seconds'] += time.time() - t0
            if exit_.get('live_buffers') is not None:
                ph['live_buffers'] = exit_['live_buffers']
            self._timeline.append({
                'ts': t0, 'phase': name, 'bytes_enter': e_in,
                'bytes_exit': x_in, 'delta': x_in - e_in,
                'live_buffers': exit_.get('live_buffers')})
        if first_step and peak_inside:
            self.record_activation(name, p_out - e_in)
        self._publish(name, x_in, exit_.get('live_buffers'))

    def _publish(self, name, in_use, nbuf):
        from . import monitor as _m
        g = _m.gauge
        g('ptpu_mem_bytes_in_use',
          help='device bytes in use at the last phase boundary',
          labelnames=('phase',)).set(in_use, phase=name)
        g('ptpu_mem_high_water_bytes',
          help='per-phase device-memory high-water mark',
          labelnames=('phase',)).set(
              self._phases[name]['high_water'], phase=name)
        if nbuf is not None:
            g('ptpu_mem_live_buffers',
              help='live device buffer count (census phases)').set(nbuf)

    def phases(self):
        with self._lock:
            return {k: dict(v) for k, v in self._phases.items()}

    def timeline(self):
        with self._lock:
            return list(self._timeline)

    # -- OOM report ----------------------------------------------------------
    def oom_report(self, exc=None, top=20):
        snap = self.sample(count_buffers=True)
        phases = self.phases()
        suspect = None
        if phases:
            # by what a phase NETTED, not by its boundary usage
            suspect = max(phases.items(),
                          key=lambda kv: (kv[1]['max_delta'],
                                          kv[1]['high_water']))[0]
        bufs = [{'bytes': b, 'shape': list(s), 'dtype': d,
                 'origin_phase': o}
                for b, s, d, o in self.live_buffers(top=top)]
        dev = _device()
        return {
            'kind': 'oom_report',
            'time': time.time(),
            'error': repr(exc)[:2000] if exc is not None else None,
            'device': (torch.cuda.get_device_name(dev)
                       if dev is not None else None),
            'rank': _env_rank(),
            'bytes_in_use': snap['bytes_in_use'],
            'peak_bytes_in_use': snap['peak_bytes_in_use'],
            'bytes_limit': snap['bytes_limit'],
            'live_buffer_count': snap['live_buffers'],
            'live_bytes': snap['live_bytes'],
            'top_buffers': bufs,
            'phases': phases,
            'timeline': self.timeline(),
            'suspect_phase': suspect,
        }


_accountant = MemoryAccountant()


def accountant():
    return _accountant


def phase(name, census=None):
    return _accountant.phase(name, census=census)


def sample(count_buffers=False):
    return _accountant.sample(count_buffers=count_buffers)


def live_buffers(top=None):
    return _accountant.live_buffers(top=top)


def live_buffer_count():
    return _accountant.live_buffer_count()


def oom_report(exc=None, top=20):
    return _accountant.oom_report(exc=exc, top=top)


def reset():
    _accountant.reset()


def activation_bytes():
    return _accountant.activation_bytes()


def _fmt_bytes(n):
    if n is None:
        return '?'
    for unit in ('B', 'KiB', 'MiB', 'GiB', 'TiB'):
        if abs(n) < 1024 or unit == 'TiB':
            return f'{n:.1f}{unit}' if unit != 'B' else f'{int(n)}B'
        n /= 1024.0
    return str(n)


def render_oom_report(report):
    """Human-readable table of an oom_report() dict."""
    out = ['== device OOM report ' + '=' * 39]
    out.append(f"device: {report.get('device')}   "
               f"rank: {report.get('rank')}")
    out.append(
        f"in_use: {_fmt_bytes(report.get('bytes_in_use'))}   "
        f"peak: {_fmt_bytes(report.get('peak_bytes_in_use'))}   "
        f"limit: {_fmt_bytes(report.get('bytes_limit'))}   "
        f"live buffers: {report.get('live_buffer_count')}")
    if report.get('suspect_phase'):
        ph = report['phases'].get(report['suspect_phase'], {})
        out.append(f"suspect phase: {report['suspect_phase']} "
                   f"(high-water {_fmt_bytes(ph.get('high_water'))}, "
                   f"max step delta {_fmt_bytes(ph.get('max_delta'))})")
    if report.get('phases'):
        out.append('-- per-phase high water ' + '-' * 36)
        out.append(f"{'phase':<24} {'calls':>6} {'high_water':>12} "
                   f"{'last_delta':>12} {'exit':>12}")
        rows = sorted(report['phases'].items(),
                      key=lambda kv: -kv[1].get('high_water', 0))
        for name, ph in rows:
            out.append(
                f"{name[:24]:<24} {ph.get('calls', 0):>6} "
                f"{_fmt_bytes(ph.get('high_water')):>12} "
                f"{_fmt_bytes(ph.get('last_delta')):>12} "
                f"{_fmt_bytes(ph.get('bytes_exit')):>12}")
    if report.get('top_buffers'):
        out.append('-- top live buffers ' + '-' * 40)
        out.append(f"{'bytes':>12}  {'dtype':<10} {'origin':<18} shape")
        for b in report['top_buffers'][:20]:
            out.append(f"{_fmt_bytes(b['bytes']):>12}  "
                       f"{b['dtype']:<10} "
                       f"{str(b.get('origin_phase') or '?'):<18} "
                       f"{tuple(b['shape'])}")
    if report.get('timeline'):
        out.append('-- recent phase timeline ' + '-' * 35)
        for ev in report['timeline'][-12:]:
            out.append(f"  {ev['phase']:<24} "
                       f"delta {_fmt_bytes(ev['delta']):>10}  "
                       f"exit {_fmt_bytes(ev['bytes_exit']):>10}")
    return '\n'.join(out)


def write_report(report, path=None):
    path = path or os.path.join(
        default_report_dir(),
        f"oom_report.rank{report.get('rank', 0)}.{os.getpid()}.json")
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            json.dump(report, f)
        return path
    except OSError:
        return None


@contextlib.contextmanager
def oom_guard(site, report_path=None):
    """Turn a device out-of-memory error escaping `site` into a
    DeviceOOMError carrying the forensics report (also written as JSON
    under the report dir). Any other error passes untouched."""
    try:
        yield
    except DeviceOOMError:
        raise                    # already enriched by an inner guard
    except Exception as e:       # noqa: BLE001 — filtered by is_oom_error
        if not is_oom_error(e):
            raise
        report = _accountant.oom_report(exc=e)
        report['site'] = site
        path = write_report(report, report_path)
        try:
            from ..distributed.fleet.utils import log_util
            log_util.log_json('device_oom', level='error', site=site,
                              report_path=path,
                              bytes_in_use=report.get('bytes_in_use'),
                              suspect_phase=report.get('suspect_phase'))
        except Exception:
            pass
        msg = (f"RESOURCE_EXHAUSTED in {site}"
               + (f" (full report: {path})" if path else '') + '\n'
               + render_oom_report(report))
        raise DeviceOOMError(msg, report=report, report_path=path) from e
