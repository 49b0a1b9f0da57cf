"""Numerics observatory — counterpart of `paddle_tpu/core/numerics.py`:
fused tensor statistics, NaN/Inf localization, the compiled-step taps
and the cross-rank divergence fingerprint.

Three layers, as in the reference:

  * **`TensorStats`** — one reduction pass per tensor producing a fixed
    `float32[N_STATS]` vector on the tensor's device (nonfinite / zero /
    subnormal counts, finite min / max / mean / rms, l2 norm, numel).
    `collect()` stacks any number of them into one `[n, N_STATS]`
    tensor on the card and fetches it ONCE.
  * **The eager guard** (`FLAGS_check_nan_inf`) — a
    `torch.overrides.TorchFunctionMode`, as `amp.auto_cast` is one,
    active inside `with guard():` and `step_guard()`. The reference
    hooks every eager op through its `run_op`; the port's layers call
    torch directly, so the mode sees the torch functions called inside
    those contexts and names each by the reference's op name
    (`amp.OP_NAMES`, else the function's own). By default each op with
    a floating output syncs once and raises at the op that produced a
    nonfinite value; with `FLAGS_check_nan_inf_deferred` each op ORs an
    `any(~isfinite)` flag into a device flag and journals
    `(op, fn, args, kwargs)`, and `flush()` (the optimizer step
    boundary) makes the one host sync, replaying the journal on a trip
    to name the FIRST op whose output is nonfinite. In-place and `out=`
    calls are journaled but not replayed (a replay would write again).
  * **Taps** — with `FLAGS_tensor_stats` or `FLAGS_check_nan_inf` the
    train engines build `jit_taps` (the stats of every gradient and
    updated parameter, and the global grad-norm^2) after each step; the
    drain point's `process_jit_taps` fetches them in ONE host sync,
    publishes the `ptpu_num_*` gauges, and under `FLAGS_check_nan_inf`
    raises `NumericsError` naming the first nonfinite tensor.

`DivergenceSentinel` computes the reference's per-step fingerprint
(grad global norm, parameter sum and l2, one fused reduction and one
fetch). Its cross-rank allgather needs a host-collective group, which
the port does not have yet (it comes with the multi-card port): without
an injected group `check()` is a no-op.

Every host sync the observatory makes funnels through `_host_fetch`, so
tests can count them.
"""
import contextlib
import json
import os
import threading
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

__all__ = [
    'N_STATS', 'STAT_FIELDS', 'TensorStats', 'stats_vec', 'tensor_stats',
    'collect', 'NumericsError', 'EagerNumericsGuard', 'guard', 'flush',
    'reset', 'step_guard', 'paused', 'jit_taps', 'process_jit_taps',
    'publish_stats', 'DivergenceSentinel', 'render_numerics_report',
    'render_divergence_report', 'write_report', 'enabled',
    'taps_enabled', 'snapshot',
]

# ---------------------------------------------------------------------------
# fused tensor statistics
# ---------------------------------------------------------------------------
STAT_FIELDS = ('nan_count', 'inf_count', 'zero_count', 'subnormal_count',
               'min', 'max', 'mean', 'rms', 'l2_norm', 'numel')
N_STATS = len(STAT_FIELDS)


def stats_vec(x):
    """`float32[N_STATS]` for one tensor, on its device, with no host
    sync.

    Counts are exact up to 2**24 elements (float32 integer range; beyond
    that they saturate in ULPs, which still tells zero from nonzero, the
    decision the guards make). min/max/mean/rms/l2 are over the FINITE
    elements; the nonfinite population has its own counters. An empty
    tensor gives (0, 0, 0, 0, +inf, -inf, 0, 0, 0, 0).
    """
    x = torch.as_tensor(x).detach()
    n = x.numel()
    f32 = torch.float32
    if n == 0:
        return torch.tensor([0, 0, 0, 0, np.inf, -np.inf, 0, 0, 0, 0],
                            dtype=f32, device=x.device)
    tiny = float(torch.finfo(x.dtype).tiny) \
        if x.is_floating_point() else 0.0
    x32 = x.to(f32)
    isnan = torch.isnan(x32)
    isinf = torch.isinf(x32)
    finite = ~(isnan | isinf)
    nan_c = isnan.sum(dtype=f32)
    inf_c = isinf.sum(dtype=f32)
    ax = x32.abs()
    if tiny:
        # zero as (|x| < tiny) - subnormals, so a backend that flushes
        # subnormals to zero in the compare cannot count one twice
        sub_c = ((ax > 0) & (ax < tiny)).sum(dtype=f32)
        zero_c = (ax < tiny).sum(dtype=f32) - sub_c
    else:
        sub_c = torch.zeros((), dtype=f32, device=x.device)
        zero_c = (x32 == 0).sum(dtype=f32)
    fin_n = torch.clamp(finite.sum(dtype=f32), min=1.0)
    xf = torch.where(finite, x32, 0.0)
    mn = torch.where(finite, x32, np.inf).min()
    mx = torch.where(finite, x32, -np.inf).max()
    mean = xf.sum() / fin_n
    sq = (xf * xf).sum()
    rms = torch.sqrt(sq / fin_n)
    l2 = torch.sqrt(sq)
    return torch.stack([nan_c, inf_c, zero_c, sub_c, mn, mx, mean, rms,
                        l2, torch.full((), float(n), dtype=f32,
                                       device=x.device)])


class TensorStats:
    """Host-side view of one stats vector."""

    __slots__ = tuple(STAT_FIELDS) + ('shape', 'dtype')

    def __init__(self, vec, shape=None, dtype=None):
        vec = np.asarray(vec, np.float64)
        for i, f in enumerate(STAT_FIELDS):
            setattr(self, f, float(vec[i]))
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = str(dtype) if dtype is not None else None

    @property
    def nonfinite_count(self):
        return self.nan_count + self.inf_count

    def as_dict(self):
        d = {f: getattr(self, f) for f in STAT_FIELDS}
        d['shape'] = list(self.shape) if self.shape is not None else None
        d['dtype'] = self.dtype
        return d

    def __repr__(self):
        return (f"TensorStats(nan={int(self.nan_count)} "
                f"inf={int(self.inf_count)} zero={int(self.zero_count)} "
                f"sub={int(self.subnormal_count)} min={self.min:.4g} "
                f"max={self.max:.4g} mean={self.mean:.4g} "
                f"rms={self.rms:.4g} l2={self.l2_norm:.4g} "
                f"n={int(self.numel)})")


# every host sync the observatory makes funnels through this hook so
# tests can count them
def _host_fetch(tree):
    """ONE device-to-host copy for every tensor leaf of `tree` (nested
    dicts, lists and tuples): the leaves are flattened into one float64
    tensor on the first leaf's device, copied once, and split back into
    numpy arrays of the leaves' shapes. Non-tensor leaves pass through."""
    leaves = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(tree)
    if not leaves:
        return tree
    dev = leaves[0].device
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float64)
                      for t in leaves]).cpu().numpy()
    it = iter(leaves)
    pos = [0]

    def build(node):
        if isinstance(node, torch.Tensor):
            t = next(it)
            k = t.numel()
            out = flat[pos[0]:pos[0] + k].reshape(tuple(t.shape))
            pos[0] += k
            return out
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return node
    return build(tree)


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def tensor_stats(x):
    """Stats for one tensor (one reduction pass, one sync)."""
    x = torch.as_tensor(x)
    return TensorStats(_host_fetch(stats_vec(x)), shape=tuple(x.shape),
                       dtype=_dtype_name(x.dtype))


def _dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def collect(named):
    """{name: tensor} -> {name: TensorStats}: every tensor's vector
    stacked into one [n, N_STATS] tensor on the card, fetched ONCE."""
    ts = {k: torch.as_tensor(v) for k, v in named.items()}
    if not ts:
        return {}
    dev = next(iter(ts.values())).device
    host = _host_fetch(torch.stack([stats_vec(t).to(dev)
                                    for t in ts.values()]))
    return {k: TensorStats(host[i], shape=tuple(t.shape),
                           dtype=_dtype_name(t.dtype))
            for i, (k, t) in enumerate(ts.items())}


# ---------------------------------------------------------------------------
# structured error + artifacts
# ---------------------------------------------------------------------------
class NumericsError(FloatingPointError):
    """Nonfinite value caught by the observatory. `.report` holds the
    JSON-ready artifact (the DeviceOOMError / oom_report shape); a
    FloatingPointError, as the reference's."""

    def __init__(self, message, report=None, report_path=None):
        super().__init__(message)
        self.report = report or {}
        self.report_path = report_path


def _env_rank():
    try:
        return int(os.environ.get('PADDLE_TRAINER_ID', '0') or 0)
    except ValueError:
        return 0


def write_report(report, path=None):
    """Persist a numerics/divergence artifact under the report dir."""
    from .memory import default_report_dir
    name = (report.get('kind')
            if report.get('kind') in ('divergence_report',
                                      'straggler_report')
            else 'numerics_report')
    path = path or os.path.join(
        default_report_dir(),
        f"{name}.rank{report.get('rank', 0)}.{os.getpid()}.json")
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            json.dump(report, f)
        return path
    except OSError:
        return None


def _fmt_stats_line(stats):
    if not stats:
        return '?'
    return (f"nan={int(stats.get('nan_count', 0))} "
            f"inf={int(stats.get('inf_count', 0))} "
            f"zero={int(stats.get('zero_count', 0))} "
            f"sub={int(stats.get('subnormal_count', 0))} "
            f"min={stats.get('min', 0):.4g} max={stats.get('max', 0):.4g} "
            f"mean={stats.get('mean', 0):.4g} rms={stats.get('rms', 0):.4g} "
            f"l2={stats.get('l2_norm', 0):.4g}")


def render_numerics_report(report):
    """Human rendering of a numerics_report dict."""
    out = ['== numerics report ' + '=' * 41]
    out.append(f"site: {report.get('site')}   rank: {report.get('rank')}"
               + (f"   step: {report.get('step')}"
                  if report.get('step') is not None else ''))
    if report.get('op'):
        o = report.get('output') or {}
        out.append(f"first nonfinite op: {report['op']} "
                   f"(output {report.get('output_index', 0)}, "
                   f"dtype {o.get('dtype')}, shape {tuple(o.get('shape') or ())})")
        out.append('  output: ' + _fmt_stats_line(o.get('stats')))
        for i, inp in enumerate(report.get('inputs') or ()):
            out.append(f"  input[{inp.get('index', i)}] "
                       f"{inp.get('dtype')} {tuple(inp.get('shape') or ())}: "
                       + _fmt_stats_line(inp.get('stats')))
    if report.get('tensors'):
        out.append('-- nonfinite tensors ' + '-' * 39)
        for t in report['tensors']:
            marker = ' <-- first' if t.get('name') == \
                report.get('first_bad') else ''
            out.append(f"  {t.get('kind', '?'):<6} {t.get('name')}: "
                       + _fmt_stats_line(t.get('stats')) + marker)
    if report.get('journal_dropped'):
        out.append(f"(journal dropped {report['journal_dropped']} oldest "
                   "ops — origin may predate the window)")
    if report.get('message'):
        out.append(report['message'])
    return '\n'.join(out)


def render_divergence_report(report):
    out = ['== cross-rank divergence report ' + '=' * 28]
    out.append(f"first divergent step: {report.get('first_divergent_step')}"
               f"   detector rank: {report.get('rank')}   world size: "
               f"{report.get('world_size')}")
    out.append(f"offending ranks: {report.get('offending_ranks')} "
               f"(consensus of {report.get('consensus_ranks')})")
    labels = report.get('fingerprint_labels') or ()
    out.append('-- per-rank fingerprints ' + '-' * 35)
    for r, fp in sorted((report.get('ranks') or {}).items(),
                        key=lambda kv: int(kv[0])):
        mark = ' <-- divergent' if int(r) in \
            (report.get('offending_ranks') or ()) else ''
        pairs = ' '.join(f'{l}={v:.9g}' for l, v in zip(labels, fp))
        out.append(f"  rank {r}: {pairs}{mark}")
    return '\n'.join(out)


# ---------------------------------------------------------------------------
# eager guard (FLAGS_check_nan_inf)
# ---------------------------------------------------------------------------
_tls = threading.local()


@contextlib.contextmanager
def paused():
    """Ops inside are not observed (the optimizer's own update, the
    guard's replay)."""
    prev = getattr(_tls, 'paused', False)
    _tls.paused = True
    try:
        yield
    finally:
        _tls.paused = prev


def _op_name(func):
    from ..amp import OP_NAMES
    name = OP_NAMES.get(func)
    if name is not None:
        return name
    return getattr(func, '__name__', None) or repr(func)


def _in_place(func, kwargs):
    name = getattr(func, '__name__', '')
    return (kwargs.get('out') is not None
            or (name.endswith('_') and not name.endswith('__'))
            or (name.startswith('__i') and name.endswith('__')))


def _tensor_args(args, kwargs):
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [o for o in out if isinstance(o, torch.Tensor)]
    return []


class _GuardMode(TorchFunctionMode):
    """Feeds every torch function called inside it to the guard while
    FLAGS_check_nan_inf is on."""

    def __init__(self, guard):
        super().__init__()
        self.guard = guard

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not getattr(_tls, 'paused', False) and enabled():
            self.guard.observe(_op_name(func), func, args, kwargs, out)
        return out


class EagerNumericsGuard:
    """Nonfinite-flag accumulation over eager torch ops.

    `observe()` is the hot path: one fused `any(~isfinite)` flag per op
    with floating outputs, synced and raised at once by default, or (with
    FLAGS_check_nan_inf_deferred) ORed into a running device flag with a
    journal entry kept for replay. `flush()` does the single per-step
    sync; on a trip the journal is replayed in order and the FIRST op
    whose output is nonfinite names the origin; its input stats tell
    "the op produced the NaN" from "the op inherited it". Used as a
    context manager (`with guard():`) it observes the torch functions
    called inside.
    """

    def __init__(self, max_journal=None):
        self._lock = threading.Lock()
        self.max_journal = max_journal
        self._modes = []
        self.reset()

    def __enter__(self):
        mode = _GuardMode(self)
        mode.__enter__()
        self._modes.append(mode)
        return self

    def __exit__(self, *exc):
        self._modes.pop().__exit__(*exc)
        return False

    def _cap(self):
        if self.max_journal is not None:
            return self.max_journal
        from .flags import flag
        v = flag('FLAGS_check_nan_inf_max_journal', 4096)
        # 0 is a legitimate bound (flag accumulation without replay)
        return int(4096 if v is None else v)

    def reset(self):
        with self._lock:
            self._flag = None        # device bool scalar
            self._journal = []       # (seq, name, fn, args, kwargs)
            self._dropped = 0
            self._seq = 0

    def pending_ops(self):
        with self._lock:
            return len(self._journal)

    def has_pending(self):
        """True when a flush has anything to check: the accumulated
        device flag counts even with an empty journal (cap 0)."""
        with self._lock:
            return self._flag is not None or bool(self._journal)

    # -- hot path ------------------------------------------------------------
    def observe(self, name, fn, args, kwargs, out):
        flt = [o for o in _outputs(out) if o.is_floating_point()]
        if not flt:
            return
        bad = None
        for o in flt:
            b = ~torch.isfinite(o).all()
            bad = b if bad is None else bad | b
        from .flags import flag
        if not flag('FLAGS_check_nan_inf_deferred', False):
            # sync and raise at the offending op
            if bool(_host_fetch(bad)):
                raise self._error_at_op(name, kwargs, args, out,
                                        mode='eager-immediate')
            return
        with self._lock:
            self._flag = bad if self._flag is None else self._flag | bad
            self._seq += 1
            if self._cap() <= 0:
                self._dropped += 1
                return
            self._journal.append((self._seq, name, fn, tuple(args),
                                  dict(kwargs)))
            if len(self._journal) > self._cap():
                self._journal.pop(0)
                self._dropped += 1

    # -- step boundary -------------------------------------------------------
    def flush(self, site='eager', step=None):
        """One host sync; raises NumericsError when the step tripped.
        Returns None (clean); the journal is dropped either way."""
        with self._lock:
            dev_flag = self._flag
            journal = self._journal
            dropped = self._dropped
            self._flag = None
            self._journal = []
            self._dropped = 0
        if dev_flag is None:
            return None
        if not bool(_host_fetch(dev_flag)):
            return None
        with paused():
            raise self._localize(journal, dropped, site=site, step=step)

    # -- failure path --------------------------------------------------------
    def _localize(self, journal, dropped, site='eager', step=None):
        """Replay the journaled ops in order; the first nonfinite output
        is the origin."""
        for seq, name, fn, args, kwargs in journal:
            if _in_place(fn, kwargs):
                continue
            try:
                out = fn(*args, **kwargs)
            except Exception:
                continue
            outs = _outputs(out)
            flt = [(i, o) for i, o in enumerate(outs)
                   if o.is_floating_point()]
            if not flt:
                continue
            st = collect({f'out{i}': o for i, o in flt})
            bad = [(i, st[f'out{i}']) for i, _ in flt
                   if st[f'out{i}'].nonfinite_count > 0]
            if bad:
                return self._error_at_op(
                    name, kwargs, args, out, mode='eager-deferred',
                    site=site, step=step, dropped=dropped,
                    bad_index=bad[0][0], bad_stats=bad[0][1], seq=seq)
        report = {
            'kind': 'numerics_report', 'time': time.time(),
            'rank': _env_rank(), 'site': site, 'step': step,
            'mode': 'eager-deferred', 'op': None,
            'journal_dropped': dropped,
            'message': ('nonfinite flag tripped but the replay found no '
                        'nonfinite output — the originating op likely '
                        'predates the journal window'),
        }
        path = write_report(report)
        self._log(report, path)
        return NumericsError(
            'NaN or Inf detected this step (FLAGS_check_nan_inf); origin '
            'outside the op journal window\n' + render_numerics_report(report),
            report=report, report_path=path)

    def _error_at_op(self, name, kwargs, args, out, mode, site='eager',
                     step=None, dropped=0, bad_index=None, bad_stats=None,
                     seq=None):
        outs = _outputs(out)
        if bad_index is None:
            st = collect({f'out{i}': o for i, o in enumerate(outs)
                          if o.is_floating_point()})
            for key, s in st.items():
                if s.nonfinite_count > 0:
                    bad_index, bad_stats = int(key[3:]), s
                    break
            if bad_index is None:       # flag raced; treat output 0
                bad_index = 0
                bad_stats = tensor_stats(outs[0])
        arrs = _tensor_args(args, kwargs)
        in_named = {f'in{i}': a for i, a in enumerate(arrs)
                    if a.is_floating_point()}
        in_stats = collect(in_named) if in_named else {}
        inputs = []
        for i, a in enumerate(arrs):
            key = f'in{i}'
            if key in in_stats:
                inputs.append({'index': i, 'shape': list(a.shape),
                               'dtype': _dtype_name(a.dtype),
                               'stats': in_stats[key].as_dict()})
        o = outs[bad_index]
        static = {k: v for k, v in (kwargs or {}).items()
                  if not isinstance(v, torch.Tensor)}
        report = {
            'kind': 'numerics_report', 'time': time.time(),
            'rank': _env_rank(), 'site': site, 'step': step, 'mode': mode,
            'op': name, 'op_seq': seq, 'output_index': bad_index,
            'output': {'shape': list(o.shape), 'dtype': _dtype_name(o.dtype),
                       'stats': bad_stats.as_dict()},
            'inputs': inputs,
            'op_kwargs': {k: repr(v)[:80] for k, v in static.items()},
            'journal_dropped': dropped,
        }
        path = write_report(report)
        self._log(report, path)
        _metric_trip(site)
        return NumericsError(
            f"NaN or Inf found in output {bad_index} of op '{name}' "
            f"(FLAGS_check_nan_inf)"
            + (f" (full report: {path})" if path else '') + '\n'
            + render_numerics_report(report),
            report=report, report_path=path)

    @staticmethod
    def _log(report, path):
        try:
            from ..distributed.fleet.utils import log_util
            log_util.log_json(
                'numerics_trip', level='error', op=report.get('op'),
                site=report.get('site'), report_path=path)
        except Exception:
            pass


_guard = EagerNumericsGuard()


def guard():
    """The process guard; `with guard():` observes the ops inside."""
    return _guard


def flush(site='eager', step=None):
    """Step-boundary check for the eager guard (one host sync). Raises
    NumericsError when the step produced a nonfinite value."""
    return _guard.flush(site=site, step=step)


def reset():
    _guard.reset()


@contextlib.contextmanager
def step_guard(site='eager', step=None):
    """Bracket one eager train step: the ops inside are observed, and
    the guard flushes (and so checks) at exit. A body that raises resets
    the guard instead: a half-step's flag and journal must not be blamed
    on the next step."""
    try:
        with _guard:
            yield _guard
    except BaseException:
        _guard.reset()
        raise
    _guard.flush(site=site, step=step)


def enabled():
    from .flags import flag
    return bool(flag('FLAGS_check_nan_inf'))


def taps_enabled():
    """Stat taps run after the engines' steps when either the NaN guard
    or the stats flag asks for them."""
    from .flags import flag
    return bool(flag('FLAGS_check_nan_inf') or flag('FLAGS_tensor_stats'))


# ---------------------------------------------------------------------------
# step taps (the train engines' numerics)
# ---------------------------------------------------------------------------
def jit_taps(grads, params=None, extra_norm_sq=None, scale=None):
    """The taps of one step, on the device, no host sync: {'grads':
    {name: stats vector}, 'params': {...}, 'grad_norm_sq': fp32 0-dim}.

    grads/params: {name: tensor}, taken one at a time (no copy of them
    all at once). `scale` (an fp32 0-dim tensor) multiplies each
    gradient in fp32 first: a loss-scaled step's unscale. `extra_norm_sq`
    lets the engine supply its own global grad-norm^2; by default the
    fp32 sum of squares over the (unscaled) gradients."""
    gvecs = {}
    acc = None
    for n, g in (grads or {}).items():
        g = g.detach()
        if scale is not None:
            g = g.float() * scale
        gvecs[n] = stats_vec(g)
        if extra_norm_sq is None:
            sq = (g.float() ** 2).sum()
            acc = sq if acc is None else acc + sq
    pvecs = {n: stats_vec(p) for n, p in (params or {}).items()}
    if extra_norm_sq is None:
        extra_norm_sq = acc if acc is not None else \
            torch.zeros((), dtype=torch.float32)
    return {'grads': gvecs, 'params': pvecs,
            'grad_norm_sq': extra_norm_sq.to(torch.float32)}


def _metric_trip(site):
    try:
        from . import monitor as _m
        _m.counter('ptpu_num_nonfinite_steps_total',
                   help='steps on which the numerics guard tripped',
                   labelnames=('site',)).inc(1, site=site)
    except Exception:
        pass


def publish_stats(named_stats, kind='grad', global_norm=None):
    """Publish {name: TensorStats} as ptpu_num_* monitor series."""
    from . import monitor as _m
    g_norm = _m.gauge('ptpu_num_grad_norm',
                      help='per-tensor pre-clip gradient l2 norm',
                      labelnames=('param',))
    g_rms = _m.gauge('ptpu_num_tensor_rms',
                     help='per-tensor rms (grads and params)',
                     labelnames=('kind', 'param'))
    c_nf = _m.counter('ptpu_num_nonfinite_total',
                      help='nonfinite elements observed',
                      labelnames=('kind',))
    c_sub = _m.counter('ptpu_num_subnormal_total',
                       help='subnormal elements observed',
                       labelnames=('kind',))
    nonfinite = 0.0
    subnormal = 0.0
    for name, st in named_stats.items():
        if kind == 'grad':
            g_norm.set(st.l2_norm, param=name)
        g_rms.set(st.rms, kind=kind, param=name)
        nonfinite += st.nonfinite_count
        subnormal += st.subnormal_count
    if nonfinite:
        c_nf.inc(nonfinite, kind=kind)
    if subnormal:
        c_sub.inc(subnormal, kind=kind)
    if global_norm is not None:
        _m.gauge('ptpu_num_grad_norm_global',
                 help='global (all-parameter) gradient l2 norm').set(
                     global_norm)
        _m.histogram('ptpu_num_grad_norm_hist',
                     help='distribution of per-step global grad norms',
                     buckets=(.001, .01, .1, .3, 1., 3., 10., 30., 100.,
                              1000.)).observe(global_norm)
    _m.counter('ptpu_num_checks_total',
               help='numerics stat collections performed').inc(1)


def process_jit_taps(taps, site='jit', step=None, meta=None):
    """Host side of the compiled-step taps: ONE sync for the whole
    pytree, gauge publication, and (when FLAGS_check_nan_inf) a
    NumericsError naming the offending tensors.

    Returns {'grads': {name: TensorStats}, 'params': {...},
    'grad_norm': float}.
    """
    # taps already on the host (an engine fetched them with its found-inf
    # flag) cost no second fetch
    host = _host_fetch(taps) if _leaves(taps) else taps
    meta = meta or {}
    out = {'grads': {}, 'params': {}}
    for kind in ('grads', 'params'):
        for n, vec in (host.get(kind) or {}).items():
            m = meta.get(kind, {}).get(n, (None, None))
            out[kind][n] = TensorStats(vec, shape=m[0], dtype=m[1])
    gn = float(np.sqrt(max(float(host.get('grad_norm_sq', 0.0)), 0.0)))
    out['grad_norm'] = gn
    publish_stats(out['grads'], kind='grad', global_norm=gn)
    if out['params']:
        publish_stats(out['params'], kind='param')
    if enabled():
        bad = [('grad', n, st) for n, st in out['grads'].items()
               if st.nonfinite_count > 0]
        bad += [('param', n, st) for n, st in out['params'].items()
                if st.nonfinite_count > 0]
        # grad_norm_sq is reduced over every gradient the step holds: a
        # NaN a per-tensor row does not show (a shard held elsewhere,
        # once tensors are sharded) still poisons it
        gn_bad = not np.isfinite(gn)
        if bad or gn_bad:
            first_bad = bad[0][1] if bad else '<global grad norm>'
            tensors = [{'kind': k, 'name': n, 'stats': st.as_dict()}
                       for k, n, st in bad]
            report = {
                'kind': 'numerics_report', 'time': time.time(),
                'rank': _env_rank(), 'site': site, 'step': step,
                'mode': 'jit', 'op': None, 'tensors': tensors,
                'first_bad': first_bad, 'grad_norm': gn,
            }
            if not bad:
                report['message'] = (
                    'the mesh-reduced global grad norm is nonfinite but '
                    'no locally-visible tensor is — the NaN/Inf lives on '
                    'another model-parallel shard or pipeline stage')
            path = write_report(report)
            EagerNumericsGuard._log(report, path)
            _metric_trip(site)
            what = (f"first nonfinite tensor is {bad[0][0]} "
                    f"'{bad[0][1]}'" if bad else
                    f"global grad norm is {gn}")
            raise NumericsError(
                f"NaN or Inf in compiled step at {site}"
                + (f" step {step}" if step is not None else '')
                + f": {what} (FLAGS_check_nan_inf)"
                + (f" (full report: {path})" if path else '') + '\n'
                + render_numerics_report(report),
                report=report, report_path=path)
    return out


# ---------------------------------------------------------------------------
# cross-rank divergence sentinel
# ---------------------------------------------------------------------------
FINGERPRINT_LABELS = ('grad_norm', 'param_sum', 'param_l2')


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


class DivergenceSentinel:
    """Cheap per-step cross-replica consistency check.

    Data-parallel replicas apply the same reduced gradients, so their
    parameters and gradient global norms must stay bit-identical. Each
    step the sentinel allgathers a 3-float fingerprint over the host-
    collective group, compares within `rtol`, and on the FIRST mismatch
    writes a divergence report naming the offending ranks (the consensus
    is the largest agreeing group; ties break toward rank 0's).

    The fingerprint is computed here; the gather needs `group` (an
    object with `rank`, `world_size`, `gid` and `all_gather(array)`):
    the port's default host-collective group comes with the multi-card
    port, and without one `check()` returns None.
    """

    def __init__(self, group=None, rtol=0.0, atol=0.0, dump_dir=None,
                 check_every=1):
        self.group = group
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.dump_dir = dump_dir
        self.check_every = max(1, int(check_every))
        self.first_divergent_step = None
        self.report = None
        self.report_path = None
        self.checks = 0

    def _group(self):
        return self.group

    def fingerprint(self, grad_norm=None, params=None):
        """3-float fingerprint; `params` is a {name: tensor} dict (or a
        nested list/dict of tensors) checksummed in one fused reduction
        and one sync."""
        s = l2 = 0.0
        if params is not None:
            leaves = [t for t in _leaves(params) if t.is_floating_point()]
            if leaves:
                dev = leaves[0].device
                tot = torch.zeros((), dtype=torch.float32, device=dev)
                sq = torch.zeros((), dtype=torch.float32, device=dev)
                for t in leaves:
                    t32 = t.detach().to(dev, torch.float32)
                    tot = tot + t32.sum()
                    sq = sq + (t32 * t32).sum()
                sv, l2v = _host_fetch(torch.stack([tot, torch.sqrt(sq)]))
                s, l2 = float(sv), float(l2v)
        gn = 0.0 if grad_norm is None else float(grad_norm)
        return np.asarray([gn, s, l2], np.float64)

    def check(self, step, grad_norm=None, params=None, fingerprint=None):
        """Returns the divergence report dict on a (first) mismatch,
        else None. No-op without a multi-rank host group."""
        g = self._group()
        if g is None or g.world_size <= 1:
            return None
        if step % self.check_every != 0:
            return None
        fp = self.fingerprint(grad_norm=grad_norm, params=params) \
            if fingerprint is None else np.asarray(fingerprint, np.float64)
        self.checks += 1
        from . import monitor as _m
        _m.counter('ptpu_num_divergence_checks_total',
                   help='cross-rank fingerprint allgathers').inc(1)
        all_fps = g.all_gather(fp)
        consensus, offending = self._vote(all_fps)
        if not offending:
            return None
        if self.first_divergent_step is None:
            self.first_divergent_step = step
        report = {
            'kind': 'divergence_report', 'time': time.time(),
            'rank': g.rank, 'world_size': g.world_size, 'step': step,
            'first_divergent_step': self.first_divergent_step,
            'fingerprint_labels': list(FINGERPRINT_LABELS),
            'ranks': {str(r): [float(v) for v in f]
                      for r, f in enumerate(all_fps)},
            'offending_ranks': offending,
            'consensus_ranks': consensus,
            'rtol': self.rtol, 'atol': self.atol,
        }
        self.report = report
        self.report_path = write_report(
            report, None if self.dump_dir is None else os.path.join(
                self.dump_dir,
                f'divergence_report.rank{g.rank}.{os.getpid()}.json'))
        _m.counter('ptpu_num_divergence_total',
                   help='cross-rank divergence events detected').inc(1)
        try:
            from ..distributed import flight_recorder as fr
            rec = fr.recorder()
            seq = rec.record_enqueue('divergence_detected',
                                     group=getattr(g, 'gid', 0),
                                     mode='numerics')
            rec.record_complete(seq, ok=False)
        except Exception:
            pass
        try:
            from ..distributed.fleet.utils import log_util
            log_util.log_json(
                'divergence_detected', level='error', step=step,
                first_divergent_step=self.first_divergent_step,
                offending_ranks=offending,
                report_path=self.report_path)
        except Exception:
            pass
        return report

    def _vote(self, all_fps):
        """Largest agreeing group is the consensus; ties break toward
        the group containing rank 0."""
        n = len(all_fps)
        groups = []          # list[(member ranks)]
        for r in range(n):
            placed = False
            for grp in groups:
                # equal_nan: every rank hitting the SAME nonfinite step
                # is agreement (a numerics problem, not divergence)
                if np.allclose(all_fps[grp[0]], all_fps[r],
                               rtol=self.rtol, atol=self.atol,
                               equal_nan=True):
                    grp.append(r)
                    placed = True
                    break
            if not placed:
                groups.append([r])
        if len(groups) <= 1:
            return list(range(n)), []
        groups.sort(key=lambda grp: (-len(grp), grp[0]))
        consensus = groups[0]
        offending = sorted(r for grp in groups[1:] for r in grp)
        return consensus, offending


def snapshot():
    """JSON-ready numerics telemetry read back from the monitor registry
    (zeros when the observatory never ran)."""
    from . import monitor as _m
    reg = _m.metrics()

    def _total(name):
        m = reg.get(name)
        if m is None:
            return 0.0
        return sum(c.value() for c in m._series().values())

    def _gauge(name):
        m = reg.get(name)
        if m is None:
            return None
        series = m._series()
        if not series:
            return None
        return next(iter(series.values())).value()

    return {
        'grad_norm_global': _gauge('ptpu_num_grad_norm_global'),
        'nonfinite_total': _total('ptpu_num_nonfinite_total'),
        'nonfinite_steps': _total('ptpu_num_nonfinite_steps_total'),
        'checks_total': _total('ptpu_num_checks_total'),
        'divergence_checks': _total('ptpu_num_divergence_checks_total'),
        'divergence_events': _total('ptpu_num_divergence_total'),
        'amp_skipped_steps': _total('ptpu_amp_skipped_steps_total'),
        'amp_loss_scale': _gauge('ptpu_amp_loss_scale'),
    }
