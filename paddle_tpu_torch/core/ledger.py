"""Step-time ledger and MFU — counterpart of `paddle_tpu/core/ledger.py`.

One reconciled account of where a training step's wall-clock goes,
assembled from the signals the engines already publish:

  * host gap / residue / blocked  — core/async_step.HostGapMonitor:
    rolling per-step means of the host time between dispatches.
  * exposed comm                  — core/bucketing.comm_snapshot: the
    modeled comm seconds NOT hidden under compute, per engine, when its
    collectives run (0 at dp = 1, where nothing crosses a link; the
    reference counts its model there too).
  * pipeline bubble               — spmd_pipeline.schedule_model: the
    modeled bubble fraction of the device-busy span (0 at pp = 1).
  * compute                       — the remainder.

Decomposition (per mean step, all seconds):

    wall    = HostGapMonitor step_interval_seconds (dispatch-to-dispatch)
    gap     = host_gap_seconds        (host gating the device)
    residue = host_residue_seconds    (unattributed host wall)
    exposed = comm_overlap exposed_comm_seconds for this engine (modeled)
    bubble  = bubble_fraction * (wall - gap - residue - exposed)
    compute = wall - gap - residue - exposed - bubble, clamped >= 0

The five components sum to `wall` by construction (reconciled_fraction
== 1.0) unless the modeled terms exceed the measured wall; then compute
clamps at 0 and reconciled_fraction > 1 flags the overrun.

Analytic model FLOPs (Megatron arXiv:2104.04473; recompute factors per
arXiv:2205.05198):

    model_flops/step = 6 * n_params * tokens
                       + 12 * layers * hidden * seq_len * tokens
    hardware_flops   = model_flops * (1 + r/3), r the fraction of the
                       forward re-run in the backward under the remat
                       policy (none/dots 0, attn_mlp_boundaries the
                       attention-score share, full 1).
    MFU = model TFLOP/s / the card's dense bf16 peak
          (PEAK_TFLOPS_BF16, keyed on the CUDA device name; None on the
          CPU and on a card the table lacks).

Everything lands as `ptpu_ledger_*` gauges (labeled by engine) and is
read back by `ledger_snapshot()` for `StepTelemetry.snapshot()['ledger']`.

`StragglerDetector` allgathers each rank's rolling step wall over a
host-collective group and flags ranks slower than `threshold` x the
median. The port has no default cross-rank group yet (it comes with
the multi-card port): without an injected group the check is a no-op.
"""
import os
import time

import numpy as np

__all__ = ['StepLedger', 'StragglerDetector', 'ledger_snapshot',
           'configure', 'model_flops_per_step', 'recompute_factor',
           'resolve_peak_tflops', 'PEAK_TFLOPS_BF16', 'count_params',
           'render_ledger', 'render_straggler_report']

# dense bf16 peak TFLOP/s by CUDA device name — the MFU denominator.
# Only cards whose figures are stated: NVIDIA's H100 SXM data sheet.
PEAK_TFLOPS_BF16 = {
    'NVIDIA H100 80GB HBM3': 989.0,
}


def resolve_peak_tflops(device_kind=None):
    """The card's dense bf16 peak by its CUDA device name (None = the
    local card), or None for the CPU and for a card the table lacks."""
    if device_kind is None:
        import torch
        device_kind = (torch.cuda.get_device_name()
                       if torch.cuda.is_available() else None)
    return PEAK_TFLOPS_BF16.get(str(device_kind)) if device_kind else None


def model_flops_per_step(n_params, tokens, layers=0, hidden=0,
                         seq_len=0, arch='gpt'):
    """(total_model_flops, attn_flops) per step, fwd+bwd.

    6*N*T counts every matmul touching a parameter (2 flops/MAC x fwd
    + 2x bwd); the attention-score term 12*l*h*L*T adds the
    parameter-free QK^T and probs*V contractions. GPT and BERT share the
    formula; `arch` is recorded, not branched on.
    """
    dense = 6.0 * float(n_params) * float(tokens)
    attn = 0.0
    if layers and hidden and seq_len:
        attn = 12.0 * float(layers) * float(hidden) \
            * float(seq_len) * float(tokens)
    return dense + attn, attn


def recompute_factor(policy, total_flops=0.0, attn_flops=0.0):
    """Fraction r of the forward pass re-executed in the backward under
    the resolved remat policy (arXiv:2205.05198: full recompute turns
    the 3-pass step into 4 passes -> hardware_flops = model * (1+r/3)).
    """
    if policy in (None, 'none', False):
        return 0.0
    if policy == 'dots':
        # dot outputs saveable: only elementwise re-runs, ~0 matmul flops
        return 0.0
    if policy == 'attn_mlp_boundaries':
        # boundary tags save every parameter matmul output; the
        # attention-score contractions between them are re-derived
        return (attn_flops / total_flops) if total_flops else 0.0
    # 'full' (and the pipeline 'recompute' memory mode): one extra fwd
    return 1.0


def count_params(tree):
    """Total element count over a dict / list (nested) of tensors or
    arrays."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    try:
        return int(tree.numel()) if hasattr(tree, 'numel') \
            else int(getattr(tree, 'size', 0) or 0)
    except Exception:
        return 0


# ---------------------------------------------------------------------------
# arch hints (bench / user code names what the engine cannot infer)
# ---------------------------------------------------------------------------
_arch_hints = {}


def configure(engine, **hints):
    """Attach arch hints (layers=, hidden=, seq_len=, arch=, n_params=,
    tokens_per_step=, peak_tflops=) to an engine's ledger by name —
    picked up at the next publish."""
    _arch_hints.setdefault(engine, {}).update(
        {k: v for k, v in hints.items() if v is not None})


class StepLedger:
    """Per-engine step-time account. Engines construct one beside their
    HostGapMonitor, call `observe_batch(shape)` in the dispatch hot path
    (shape metadata only, no sync), and `publish()` from flush()."""

    def __init__(self, engine, gap=None, params_fn=None, remat_policy=None,
                 arch='gpt', layers=0, hidden=0, seq_len=0,
                 bubble_fraction_fn=None):
        self.engine = engine
        self._gap = gap
        self._params_fn = params_fn
        self._n_params = None           # resolved lazily, once
        self.remat_policy = remat_policy
        self.arch = arch
        self.layers, self.hidden, self.seq_len = layers, hidden, seq_len
        self._bubble_fn = bubble_fraction_fn
        self.tokens_per_step = 0
        self.steps = 0
        self.straggler = StragglerDetector(engine=engine) \
            if os.environ.get('PTPU_STRAGGLER_CHECK') else None

    # -- hot path -----------------------------------------------------------
    def observe_batch(self, shape):
        """Record tokens/seq from a batch array's shape (metadata only)
        and run the opt-in periodic straggler check."""
        self.steps += 1
        try:
            if len(shape) >= 2:
                self.tokens_per_step = int(shape[0]) * int(shape[1])
                self.seq_len = self.seq_len or int(shape[1])
            elif len(shape) == 1:
                self.tokens_per_step = int(shape[0])
        except Exception:
            pass
        if self.straggler is not None:
            try:
                self.straggler.maybe_check(self.steps, self._gap)
            except Exception:
                pass

    # -- account ------------------------------------------------------------
    def _hints(self):
        h = dict(_arch_hints.get(self.engine, ()))
        return h

    def account(self):
        """The reconciled per-step account dict, or None before the gap
        monitor has a full step interval."""
        snap = self._gap.snapshot() if self._gap is not None else {}
        wall = float(snap.get('step_interval_seconds') or 0.0)
        if wall <= 0.0:
            return None
        h = self._hints()
        gap = min(float(snap.get('host_gap_seconds') or 0.0), wall)
        residue = min(float(snap.get('host_residue_seconds') or 0.0),
                      max(wall - gap, 0.0))
        exposed = min(self._exposed_comm_seconds(),
                      max(wall - gap - residue, 0.0))
        busy = max(wall - gap - residue - exposed, 0.0)
        bf = self._bubble_fraction()
        bubble = busy * bf if bf else 0.0
        compute = max(busy - bubble, 0.0)
        total = compute + exposed + bubble + gap + residue
        out = {
            'engine': self.engine,
            'steps': self.steps or int(snap.get('steps') or 0),
            'wall_seconds': wall,
            'components': {
                'compute': compute,
                'exposed_comm': exposed,
                'bubble': bubble,
                'host_gap': gap,
                'residue': residue,
            },
            'reconciled_fraction': (total / wall) if wall else 0.0,
            'blocked_wait_seconds':
                float(snap.get('blocked_wait_seconds') or 0.0),
        }
        out.update(self._flops_account(wall, h))
        return out

    def _exposed_comm_seconds(self):
        """The engine's modeled exposed comm seconds, counted only when
        its collectives run (`ptpu_comm_enabled` 1). The reference counts
        the model at dp = 1 too, where nothing crosses a link; the port
        attributes no wall to comm that does not happen."""
        try:
            from . import bucketing as B
            snap = B.comm_snapshot()
            if not (snap.get('ptpu_comm_enabled') or {}).get(
                    f'engine={self.engine}'):
                return 0.0
            ov = (snap.get('comm_overlap') or {}).get(self.engine)
            if not ov:
                return 0.0
            return max(float(ov.get('exposed_comm_seconds') or 0.0), 0.0)
        except Exception:
            return 0.0

    def _bubble_fraction(self):
        if self._bubble_fn is None:
            return 0.0
        try:
            return max(float(self._bubble_fn() or 0.0), 0.0)
        except Exception:
            return 0.0

    def _flops_account(self, wall, h):
        n_params = h.get('n_params')
        if n_params is None:
            if self._n_params is None and self._params_fn is not None:
                try:
                    self._n_params = int(self._params_fn() or 0)
                except Exception:
                    self._n_params = 0
            n_params = self._n_params or 0
        tokens = int(h.get('tokens_per_step') or self.tokens_per_step or 0)
        layers = int(h.get('layers') or self.layers or 0)
        hidden = int(h.get('hidden') or self.hidden or 0)
        seq_len = int(h.get('seq_len') or self.seq_len or 0)
        arch = h.get('arch') or self.arch
        policy = h.get('remat_policy') or self.remat_policy
        total, attn = model_flops_per_step(
            n_params, tokens, layers=layers, hidden=hidden,
            seq_len=seq_len, arch=arch)
        r = recompute_factor(policy, total, attn)
        hardware = total * (1.0 + r / 3.0)
        model_tflops = total / wall / 1e12 if (total and wall) else 0.0
        hw_tflops = hardware / wall / 1e12 if (hardware and wall) else 0.0
        peak = h.get('peak_tflops', resolve_peak_tflops())
        mfu = (model_tflops / peak) if (peak and model_tflops) else None
        return {
            'arch': arch, 'n_params': int(n_params), 'tokens_per_step':
                tokens, 'remat_policy': policy or 'none',
            'flops': {'model_flops_per_step': total,
                      'attn_flops_per_step': attn,
                      'recompute_factor': r,
                      'hardware_flops_per_step': hardware},
            'model_tflops': model_tflops,
            'hardware_tflops': hw_tflops,
            'peak_tflops': peak,
            'mfu': mfu,
        }

    # -- publication (flush-time, never the hot path) -----------------------
    def publish(self):
        acct = self.account()
        if acct is None:
            return None
        try:
            from . import monitor as _m
            e = self.engine
            _m.gauge('ptpu_ledger_wall_seconds',
                     help='ledger: mean step wall (dispatch-to-dispatch)',
                     labelnames=('engine',)).set(acct['wall_seconds'],
                                                 engine=e)
            comp = _m.gauge(
                'ptpu_ledger_component_seconds',
                help='ledger: per-step seconds attributed to each '
                     'component (compute/exposed_comm/bubble/host_gap/'
                     'residue)',
                labelnames=('engine', 'component'))
            for name, v in acct['components'].items():
                comp.set(v, engine=e, component=name)
            _m.gauge('ptpu_ledger_reconciled_fraction',
                     help='ledger: sum(components)/wall (1.0 = fully '
                          'reconciled; >1 flags modeled terms exceeding '
                          'the measured wall)',
                     labelnames=('engine',)).set(
                         acct['reconciled_fraction'], engine=e)
            _m.gauge('ptpu_ledger_tokens_per_step',
                     help='ledger: tokens consumed per step (from batch '
                          'shapes)',
                     labelnames=('engine',)).set(
                         acct['tokens_per_step'], engine=e)
            _m.gauge('ptpu_ledger_model_tflops',
                     help='ledger: achieved model TFLOP/s (6NT + attn '
                          'term, recompute excluded)',
                     labelnames=('engine',)).set(acct['model_tflops'],
                                                 engine=e)
            _m.gauge('ptpu_ledger_hardware_tflops',
                     help='ledger: achieved hardware TFLOP/s (model * '
                          '(1+r/3) for remat recompute factor r)',
                     labelnames=('engine',)).set(acct['hardware_tflops'],
                                                 engine=e)
            _m.gauge('ptpu_ledger_recompute_factor',
                     help='ledger: fraction of the forward re-executed '
                          'in the backward under the active remat policy',
                     labelnames=('engine',)).set(
                         acct['flops']['recompute_factor'], engine=e)
            if acct['peak_tflops']:
                _m.gauge('ptpu_ledger_peak_tflops',
                         help='ledger: the card\'s dense bf16 peak by '
                              'device name',
                         labelnames=('engine',)).set(
                             acct['peak_tflops'], engine=e)
            if acct['mfu'] is not None:
                _m.gauge('ptpu_ledger_mfu',
                         help='ledger: model-FLOPs utilization vs the '
                              'card\'s peak (absent on the CPU)',
                         labelnames=('engine',)).set(acct['mfu'], engine=e)
        except Exception:
            pass
        return acct


def ledger_snapshot(engine=None):
    """StepTelemetry.snapshot()['ledger'] payload: every published
    engine's account read back from the ptpu_ledger_* gauges (None when
    no ledger has published)."""
    try:
        from . import monitor as _m
        reg = _m.metrics()
        wall = reg.get('ptpu_ledger_wall_seconds')
        if wall is None:
            return None
        engines = [labels[0] for labels in wall._series()] \
            if engine is None else [engine]

        def val(name, eng, component=None):
            m = reg.get(name)
            if m is None:
                return None
            want = (eng,) if component is None else (eng, component)
            for labels, child in m._series().items():
                if tuple(labels) == want:
                    return child.value()
            return None

        out = {}
        for eng in engines:
            w = val('ptpu_ledger_wall_seconds', eng)
            if w is None:
                continue
            out[eng] = {
                'wall_seconds': w,
                'components': {
                    c: val('ptpu_ledger_component_seconds', eng, c) or 0.0
                    for c in ('compute', 'exposed_comm', 'bubble',
                              'host_gap', 'residue')},
                'reconciled_fraction':
                    val('ptpu_ledger_reconciled_fraction', eng),
                'tokens_per_step':
                    int(val('ptpu_ledger_tokens_per_step', eng) or 0),
                'model_tflops': val('ptpu_ledger_model_tflops', eng),
                'hardware_tflops':
                    val('ptpu_ledger_hardware_tflops', eng),
                'recompute_factor':
                    val('ptpu_ledger_recompute_factor', eng),
                'peak_tflops': val('ptpu_ledger_peak_tflops', eng),
                'mfu': val('ptpu_ledger_mfu', eng),
            }
        return out or None
    except Exception:
        return None


def render_ledger(snap):
    """Human rendering of a ledger_snapshot() dict."""
    out = ['== step-time ledger ' + '=' * 40]
    for eng, a in sorted((snap or {}).items()):
        wall = a.get('wall_seconds') or 0.0
        out.append(f"engine: {eng}   wall {wall * 1e3:.3f} ms/step   "
                   f"reconciled {(a.get('reconciled_fraction') or 0):.3f}")
        comps = a.get('components') or {}
        for name in ('compute', 'exposed_comm', 'bubble', 'host_gap',
                     'residue'):
            v = comps.get(name) or 0.0
            pct = (v / wall * 100.0) if wall else 0.0
            out.append(f"  {name:<13} {v * 1e3:>10.3f} ms  {pct:5.1f}%")
        mt = a.get('model_tflops')
        if mt:
            line = (f"  model {mt:.3f} TFLOP/s  hardware "
                    f"{(a.get('hardware_tflops') or 0):.3f} TFLOP/s  "
                    f"(recompute r={(a.get('recompute_factor') or 0):.2f})")
            if a.get('mfu') is not None:
                line += (f"  MFU {a['mfu'] * 100:.1f}% of "
                         f"{a.get('peak_tflops')} TFLOP/s peak")
            out.append(line)
    return '\n'.join(out)


# ---------------------------------------------------------------------------
# cross-rank straggler detection (DivergenceSentinel for wall time)
# ---------------------------------------------------------------------------
class StragglerDetector:
    """Periodic allgather of per-rank step-wall fingerprints over the
    host-collective group; ranks slower than `threshold` x the median
    get flagged, gauged, and dumped as a `straggler_report` artifact.

    Knobs (env): PTPU_STRAGGLER_CHECK=1 enables the periodic check from
    the engines' dispatch path; PTPU_STRAGGLER_EVERY (default 50) sets
    the cadence in dispatches — it must divide identically on every
    rank (the allgather is collective); PTPU_STRAGGLER_THRESHOLD
    (default 1.25) the relative-to-median slowdown that flags a rank.
    """

    def __init__(self, engine='train', group=None, threshold=None,
                 check_every=None, dump_dir=None):
        self.engine = engine
        self.group = group
        self.threshold = float(
            threshold if threshold is not None
            else os.environ.get('PTPU_STRAGGLER_THRESHOLD', '1.25'))
        self.check_every = max(1, int(
            check_every if check_every is not None
            else os.environ.get('PTPU_STRAGGLER_EVERY', '50')))
        self.dump_dir = dump_dir
        self.checks = 0
        self.events = 0
        self.report = None
        self.report_path = None

    def _group(self):
        """The injected host-collective group, or None: the port's
        default cross-rank group comes with the multi-card port, so at
        world size 1 the check is a no-op."""
        return self.group

    def maybe_check(self, step, gap_monitor):
        if step % self.check_every != 0:
            return None
        wall = 0.0
        if gap_monitor is not None:
            snap = gap_monitor.snapshot()
            wall = float(snap.get('step_interval_seconds') or 0.0)
        return self.check(step, wall)

    def check(self, step, wall_seconds):
        """Collective: every rank in the host group must call this with
        the same `step`. Returns the straggler report dict on this
        rank's view of a flagged round, else None."""
        g = self._group()
        if g is None or g.world_size <= 1:
            return None
        from . import monitor as _m
        self.checks += 1
        _m.counter('ptpu_straggler_checks_total',
                   help='cross-rank step-wall allgathers').inc(1)
        fp = np.asarray([float(wall_seconds)], np.float64)
        walls = [float(np.asarray(w).reshape(-1)[0])
                 for w in g.all_gather(fp)]
        median = float(np.median([w for w in walls if w > 0.0] or [0.0]))
        if median <= 0.0:
            return None
        rel = {r: walls[r] / median for r in range(g.world_size)}
        _m.gauge('ptpu_straggler_relative_wall',
                 help='this rank step wall / group median at the last '
                      'straggler check',
                 labelnames=('rank',)).set(rel[g.rank], rank=str(g.rank))
        offending = sorted(r for r, v in rel.items()
                           if v > self.threshold)
        _m.gauge('ptpu_straggler_flagged',
                 help='1 while this rank was flagged slower than '
                      'threshold x median at the last check',
                 labelnames=('rank',)).set(
                     1.0 if g.rank in offending else 0.0,
                     rank=str(g.rank))
        if not offending:
            return None
        self.events += 1
        _m.counter('ptpu_straggler_events_total',
                   help='straggler rounds detected (some rank above '
                        'threshold)').inc(1)
        report = {
            'kind': 'straggler_report', 'time': time.time(),
            'engine': self.engine, 'rank': g.rank,
            'world_size': g.world_size, 'step': step,
            'threshold': self.threshold,
            'median_wall_seconds': median,
            'ranks': {str(r): walls[r] for r in range(g.world_size)},
            'relative_wall': {str(r): rel[r]
                              for r in range(g.world_size)},
            'offending_ranks': offending,
        }
        self.report = report
        from . import numerics as _num
        self.report_path = _num.write_report(
            report, None if self.dump_dir is None else os.path.join(
                self.dump_dir,
                f'straggler_report.rank{g.rank}.{os.getpid()}.json'))
        try:
            from ..distributed import flight_recorder as fr
            rec = fr.recorder()
            seq = rec.record_enqueue('straggler_detected', group=g.gid,
                                     mode='ledger')
            rec.record_complete(seq, ok=True)
        except Exception:
            pass
        try:
            from ..distributed.fleet.utils import log_util
            log_util.log_json(
                'straggler_detected', level='warning', step=step,
                offending_ranks=offending, median_wall_seconds=median,
                threshold=self.threshold, report_path=self.report_path)
        except Exception:
            pass
        return report


def render_straggler_report(report):
    """Human rendering of a straggler_report dict."""
    out = ['== straggler report ' + '=' * 40]
    out.append(f"step: {report.get('step')}   world_size: "
               f"{report.get('world_size')}   threshold: "
               f"{report.get('threshold')}x median "
               f"({(report.get('median_wall_seconds') or 0) * 1e3:.3f} ms)")
    rel = report.get('relative_wall') or {}
    ranks = report.get('ranks') or {}
    flagged = set(report.get('offending_ranks') or ())
    for r in sorted(ranks, key=int):
        mark = '  << STRAGGLER' if int(r) in flagged else ''
        out.append(f"  rank {r}: {float(ranks[r]) * 1e3:>10.3f} ms  "
                   f"({float(rel.get(r, 0)):.2f}x median){mark}")
    return '\n'.join(out)
