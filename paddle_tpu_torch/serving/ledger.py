"""Serving goodput ledger & decode roofline — counterpart of
`paddle_tpu/serving/ledger.py`.

Three accounts per engine site:

1. **ServeLedger wall decomposition** — every engine iteration's wall
   splits into compute / chosen-id host fetch / scheduling / page-stream
   (host-tier transfers) / residue with ordered clamps: each measured
   component is clamped to the wall remaining after the ones before it,
   residue is the remainder, and `reconciled_fraction` ==
   sum(components)/wall flags any overrun. The engine's host syncs run
   through a registered `core.async_step.HostGapMonitor` (site 'serve'),
   so serving reports a `host_bound_fraction`: the share of the step
   interval the host spends blocked on the fetch.

2. **Goodput ledger** — emitted tokens (every token position the steps
   computed: prefill positions plus decode/verify query rows) split into
   delivered vs wasted (preempt_recompute: positions re-prefilled after a
   preemption destroyed their KV; spec_rejected: verify columns computed
   but never appended; drain_recompute: a cluster cause, zero here). The
   identity `delivered + wasted == emitted` holds exactly by
   construction. Degrade-shed speculative capacity (`spec_shed_tokens`)
   was never computed and sits outside the identity.

3. **Decode roofline** — decode is bandwidth-bound, so its roofline is
   bytes moved per iteration: the resident parameter bytes (int8 codes
   and scales for int8 weights) plus KV page reads at the pool's
   `bytes_per_token()` over the active requests' contexts. Achieved GB/s
   over the step wall against the card's HBM peak gives MBU; prefill
   chunks use the analytic forward FLOPs for a prefill MFU. The peaks
   are keyed on the CUDA device name (`torch.cuda.get_device_name()`);
   on the CPU or an unknown card both utilizations are None — absolute
   GB/s and TFLOP/s only.

Everything lands as `ptpu_serve_ledger_*` / `ptpu_serve_goodput_*`
gauges (labeled by engine site) and in `metrics.serve_snapshot()`.
Engines register here at build and `unregister()` at shutdown, so a
dead engine stops reporting.
"""
import collections
import threading

from ..core import monitor as _m
from ..core.ledger import model_flops_per_step, resolve_peak_tflops

__all__ = ['ServeLedger', 'serve_ledger_snapshot', 'render_serve_ledger',
           'resolve_peak_hbm_gbps', 'HBM_GBPS', 'unregister_ledger']


# ---------------------------------------------------------------------------
# per-card HBM bandwidth peak (GB/s), keyed on the CUDA device name — the
# MBU denominator, as core.ledger.PEAK_TFLOPS_BF16 is the MFU one. Only
# cards whose figures are stated: NVIDIA's H100 SXM data sheet.
# ---------------------------------------------------------------------------
HBM_GBPS = {
    'NVIDIA H100 80GB HBM3': 3350.0,
}


def local_device_kind():
    """`torch.cuda.get_device_name()` of the current card, or None
    without one."""
    import torch
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else None


def resolve_peak_hbm_gbps(device_kind=None):
    """The card's HBM bandwidth peak by its CUDA device name (None = the
    local card), or None for the CPU and for a card the table lacks."""
    if device_kind is None:
        device_kind = local_device_kind()
    return HBM_GBPS.get(str(device_kind)) if device_kind else None


# engine site -> ServeLedger (latest per site wins — the monitor
# registry convention). serve_ledger_snapshot() reads LIVE ledgers, so
# an engine that unregistered at shutdown stops reporting immediately.
_ledgers = {}
_ledgers_lock = threading.Lock()


def unregister_ledger(ledger):
    """Drop a ledger from the snapshot registry if it is still the
    registered one for its site (a newer engine's ledger wins)."""
    with _ledgers_lock:
        if _ledgers.get(ledger.engine) is ledger:
            del _ledgers[ledger.engine]


_WASTE_CAUSES = ('preempt_recompute', 'spec_rejected', 'drain_recompute')
_COMPONENTS = ('compute', 'host_fetch', 'schedule', 'page_stream',
               'residue')


class ServeLedger:
    """Per-engine serving account. The engine constructs one beside its
    HostGapMonitor, feeds it per-iteration phase timings
    (`observe_iteration`) and per-token classifications
    (`account_prefill` / `account_decode` / `account_spec_shed`) from
    the step hot path — pure host floats on data the engine already
    holds, zero device syncs — and `publish()`es from
    `publish_metrics()`."""

    def __init__(self, engine='serve', gap=None, window=256,
                 n_params=0, layers=0, hidden=0, param_bytes=0,
                 kv_bytes_per_token=0, peak_hbm_gbps=None,
                 peak_tflops=None, device_kind=None):
        self.engine = engine
        # the card whose peaks MBU/MFU divide by: its CUDA name, 'cpu'
        # for an engine on the CPU (no peak), None for the local card
        self.device_kind = device_kind
        self._gap = gap
        self.n_params = int(n_params)
        self.layers = int(layers)
        self.hidden = int(hidden)
        self.param_bytes = int(param_bytes)
        self.kv_bytes_per_token = int(kv_bytes_per_token)
        self._peak_hbm = peak_hbm_gbps
        self._peak_tflops = peak_tflops
        self._window = int(window)
        # per-iteration rolling samples (seconds / counts)
        self._walls = collections.deque(maxlen=window)
        self._compute = collections.deque(maxlen=window)
        self._fetch = collections.deque(maxlen=window)
        self._schedule = collections.deque(maxlen=window)
        self._stream = collections.deque(maxlen=window)
        # decode-roofline samples (decode iterations only)
        self._decode_s = collections.deque(maxlen=window)
        self._kv_tokens = collections.deque(maxlen=window)
        # prefill-roofline samples (prefill dispatches only)
        self._prefill_s = collections.deque(maxlen=window)
        self._prefill_tok = collections.deque(maxlen=window)
        self._prefill_ctx = collections.deque(maxlen=window)
        self._pending_stream = 0.0      # tier transfer seconds noted
                                        # between iterations
        self.iterations = 0
        # goodput counters (lifetime, host ints)
        self.emitted_tokens = 0
        self.delivered_tokens = 0
        self.wasted = {c: 0 for c in _WASTE_CAUSES}
        self.spec_shed_tokens = 0
        # fused decode windows: dispatches, the device
        # iterations they ran, and the tokens they delivered — the
        # per-window host-fetch attribution's denominator
        self.fused_windows = 0
        self.fused_iterations = 0
        self.fused_tokens = 0
        self._per_tenant = {}
        with _ledgers_lock:
            _ledgers[engine] = self

    # -- hot path: wall decomposition ---------------------------------------
    def note_page_stream(self, seconds):
        """Page transfers (the host tier's spills and fetches) just
        spent `seconds` — folded into the NEXT observed iteration's
        page_stream component."""
        self._pending_stream += max(float(seconds), 0.0)

    def observe_iteration(self, wall, compute=0.0, host_fetch=0.0,
                          schedule=0.0, decode_seconds=0.0,
                          kv_read_tokens=0, prefill_tokens=0,
                          prefill_seconds=0.0, prefill_ctx_tokens=0):
        """One engine iteration's measured phase walls (host
        perf_counter segments — no device syncs)."""
        self.iterations += 1
        self._walls.append(max(float(wall), 0.0))
        self._compute.append(max(float(compute), 0.0))
        self._fetch.append(max(float(host_fetch), 0.0))
        self._schedule.append(max(float(schedule), 0.0))
        self._stream.append(self._pending_stream)
        self._pending_stream = 0.0
        if decode_seconds > 0.0:
            self._decode_s.append(float(decode_seconds))
            self._kv_tokens.append(int(kv_read_tokens))
        if prefill_tokens > 0:
            self._prefill_s.append(max(float(prefill_seconds), 0.0))
            self._prefill_tok.append(int(prefill_tokens))
            self._prefill_ctx.append(int(prefill_ctx_tokens))

    # -- hot path: goodput --------------------------------------------------
    def _tenant_row(self, tenant_id):
        tid = str(tenant_id)
        row = self._per_tenant.get(tid)
        if row is None:
            row = self._per_tenant[tid] = {'delivered_tokens': 0,
                                           'wasted_tokens': 0}
        return row

    def account_prefill(self, first_time, recompute, tenant_id=None):
        """One prefill chunk's computed positions: `first_time` never
        computed before (delivered prompt work), `recompute` positions
        a preemption destroyed and this chunk re-derives (wasted)."""
        ft, rc = max(int(first_time), 0), max(int(recompute), 0)
        self.emitted_tokens += ft + rc
        self.delivered_tokens += ft
        self.wasted['preempt_recompute'] += rc
        if tenant_id is not None and (ft or rc):
            row = self._tenant_row(tenant_id)
            row['delivered_tokens'] += ft
            row['wasted_tokens'] += rc
    def account_decode(self, delivered, rejected, tenant_id=None):
        """One request's decode/verify row: `delivered` tokens appended
        to the request, `rejected` query columns computed but discarded
        (failed draft verification or post-eos overdraft)."""
        d, rj = max(int(delivered), 0), max(int(rejected), 0)
        self.emitted_tokens += d + rj
        self.delivered_tokens += d
        self.wasted['spec_rejected'] += rj
        if tenant_id is not None and (d or rj):
            row = self._tenant_row(tenant_id)
            row['delivered_tokens'] += d
            row['wasted_tokens'] += rj

    def account_fused_window(self, k, iterations, tokens):
        """One fused decode window: configured window length `k`, the
        `iterations` the scan actually advanced anyone (<= k when every
        row went done early), and the tokens it delivered. The window's
        single host fetch is already amortized across its iterations by
        the engine's observe_iteration calls; these counters carry the
        window shape itself (gauges)."""
        self.fused_windows += 1
        self.fused_iterations += max(int(iterations), 0)
        self.fused_tokens += max(int(tokens), 0)

    def account_spec_shed(self, tokens, tenant_id=None):
        """Draft capacity the degradation ladder shed this decode step
        (stage >= 1 with spec configured on): foregone tokens that were
        never computed — OUTSIDE the delivered+wasted==emitted
        identity, reported as shed capacity."""
        self.spec_shed_tokens += max(int(tokens), 0)

    # -- accounts ------------------------------------------------------------
    @staticmethod
    def _mean(dq):
        return (sum(dq) / len(dq)) if dq else 0.0

    def account(self):
        """The reconciled per-iteration wall decomposition, or None
        before the first observed iteration. Ordered clamps:
        compute, then host_fetch, then schedule, then page_stream each
        clamp to the wall remaining before them; residue is the
        remainder. `measured` carries the raw means so a clamp that
        bit is visible, and reconciled_fraction > 1 flags measured
        components exceeding the wall."""
        if not self._walls:
            return None
        wall = self._mean(self._walls)
        if wall <= 0.0:
            return None
        m_compute = self._mean(self._compute)
        m_fetch = self._mean(self._fetch)
        m_sched = self._mean(self._schedule)
        m_stream = self._mean(self._stream)
        compute = min(m_compute, wall)
        fetch = min(m_fetch, max(wall - compute, 0.0))
        sched = min(m_sched, max(wall - compute - fetch, 0.0))
        stream = min(m_stream, max(wall - compute - fetch - sched, 0.0))
        residue = max(wall - compute - fetch - sched - stream, 0.0)
        total = compute + fetch + sched + stream + residue
        overrun = m_compute + m_fetch + m_sched + m_stream
        snap = self._gap.snapshot() if self._gap is not None else {}
        return {
            'engine': self.engine,
            'iterations': self.iterations,
            'wall_seconds': wall,
            'components': {
                'compute': compute,
                'host_fetch': fetch,
                'schedule': sched,
                'page_stream': stream,
                'residue': residue,
            },
            'measured': {
                'compute': m_compute, 'host_fetch': m_fetch,
                'schedule': m_sched, 'page_stream': m_stream,
            },
            'reconciled_fraction':
                (max(total, overrun) / wall) if wall else 0.0,
            'host_bound_fraction': snap.get('host_bound_fraction'),
            'host_gap_seconds': snap.get('host_gap_seconds'),
            'fused_windows': self.fused_windows,
            'fused_iterations': self.fused_iterations,
            'fused_tokens': self.fused_tokens,
        }

    def goodput(self):
        """The goodput account: delivered + wasted == emitted exactly
        (wasted = the three computed-token causes; spec_shed is
        foregone capacity, reported beside the identity)."""
        wasted_total = sum(self.wasted.values())
        emitted = self.emitted_tokens
        return {
            'engine': self.engine,
            'emitted_tokens': emitted,
            'delivered_tokens': self.delivered_tokens,
            'wasted_tokens': wasted_total,
            'wasted_by_cause': dict(self.wasted),
            'spec_shed_tokens': self.spec_shed_tokens,
            'goodput_fraction':
                (self.delivered_tokens / emitted) if emitted else None,
            'per_tenant': {t: dict(r)
                           for t, r in self._per_tenant.items()},
        }

    def roofline(self):
        """The decode bytes-moved roofline + prefill FLOPs roofline, or
        None before any decode/prefill dispatch was observed. MBU/MFU
        are None without a known card — absolute GB/s / TFLOP/s only."""
        out = None
        if self._decode_s:
            dt = self._mean(self._decode_s)
            kv_tokens = self._mean(self._kv_tokens)
            bytes_per_iter = (self.param_bytes
                              + kv_tokens * self.kv_bytes_per_token)
            gbps = (bytes_per_iter / dt / 1e9) if dt > 0.0 else 0.0
            peak = (self._peak_hbm if self._peak_hbm is not None
                    else resolve_peak_hbm_gbps(self.device_kind))
            out = {
                'engine': self.engine,
                'decode_bytes_per_iteration': bytes_per_iter,
                'param_bytes': self.param_bytes,
                'kv_read_tokens_mean': kv_tokens,
                'kv_bytes_per_token': self.kv_bytes_per_token,
                'decode_seconds_mean': dt,
                'hbm_gbps': gbps,
                'peak_hbm_gbps': peak,
                'mbu': (gbps / peak) if (peak and gbps) else None,
            }
        if self._prefill_s and sum(self._prefill_s) > 0.0 \
                and self.n_params:
            tokens = sum(self._prefill_tok)
            ctx = sum(self._prefill_ctx)
            secs = sum(self._prefill_s)
            # forward share of the fwd+bwd analytic count (6NT + 12LHST
            # is 1 fwd + 2 bwd passes): inference runs the forward only.
            # The attention term's seq_len is the token-weighted mean
            # context each chunk attended over.
            seq_eff = (ctx / tokens) if tokens else 0
            total, _attn = model_flops_per_step(
                self.n_params, tokens, layers=self.layers,
                hidden=self.hidden, seq_len=seq_eff)
            fwd = total / 3.0
            tflops = fwd / secs / 1e12 if secs else 0.0
            peak_t = (self._peak_tflops if self._peak_tflops is not None
                      else resolve_peak_tflops(self.device_kind))
            out = dict(out or {'engine': self.engine})
            out.update({
                'prefill_tokens': int(tokens),
                'prefill_seconds': secs,
                'prefill_model_flops': fwd,
                'prefill_tflops': tflops,
                'peak_tflops': peak_t,
                'prefill_mfu':
                    (tflops / peak_t) if (peak_t and tflops) else None,
            })
        return out

    # -- lifecycle -----------------------------------------------------------
    def reset(self):
        """Zero the rolling windows and goodput counters (the warm-up
        boundary — rides engine.reset_stats())."""
        for dq in (self._walls, self._compute, self._fetch,
                   self._schedule, self._stream, self._decode_s,
                   self._kv_tokens, self._prefill_s, self._prefill_tok,
                   self._prefill_ctx):
            dq.clear()
        self._pending_stream = 0.0
        self.iterations = 0
        self.emitted_tokens = 0
        self.delivered_tokens = 0
        self.wasted = {c: 0 for c in _WASTE_CAUSES}
        self.spec_shed_tokens = 0
        self.fused_windows = 0
        self.fused_iterations = 0
        self.fused_tokens = 0
        self._per_tenant = {}

    def unregister(self):
        unregister_ledger(self)

    # -- publication (publish_metrics cadence, never per token) -------------
    def publish(self):
        acct = self.account()
        good = self.goodput()
        roof = self.roofline()
        e = self.engine
        if acct is not None:
            _m.gauge('ptpu_serve_ledger_wall_seconds',
                     help='serving ledger: mean engine-iteration '
                          'wall',
                     labelnames=('engine',)).set(
                         acct['wall_seconds'], engine=e)
            comp = _m.gauge(
                'ptpu_serve_ledger_component_seconds',
                help='serving ledger: per-iteration seconds per '
                     'component (compute/host_fetch/schedule/'
                     'page_stream/residue)',
                labelnames=('engine', 'component'))
            for name, v in acct['components'].items():
                comp.set(v, engine=e, component=name)
            _m.gauge('ptpu_serve_ledger_reconciled_fraction',
                     help='serving ledger: sum(components)/wall '
                          '(1.0 = reconciled; >1 flags measured '
                          'components exceeding the wall)',
                     labelnames=('engine',)).set(
                         acct['reconciled_fraction'], engine=e)
            if acct['host_bound_fraction'] is not None:
                _m.gauge(
                    'ptpu_serve_ledger_host_bound_fraction',
                    help='serving: fraction of the step interval '
                         'the host spends blocked on the sampled-'
                         'token fetch (HostGapMonitor gating)',
                    labelnames=('engine',)).set(
                        acct['host_bound_fraction'], engine=e)
            _m.gauge('ptpu_serve_ledger_fused_windows_total',
                     help='fused decode: k-iteration windows '
                          'dispatched (one host fetch each)',
                     labelnames=('engine',)).set(
                         acct['fused_windows'], engine=e)
            _m.gauge('ptpu_serve_ledger_fused_iterations_total',
                     help='fused decode: device iterations run '
                          'inside fused windows (each the '
                          'equivalent of one serial decode step)',
                     labelnames=('engine',)).set(
                         acct['fused_iterations'], engine=e)
        _m.gauge('ptpu_serve_goodput_emitted_tokens',
                 help='goodput: token positions the compiled steps '
                      'computed (lifetime)',
                 labelnames=('engine',)).set(good['emitted_tokens'],
                                             engine=e)
        _m.gauge('ptpu_serve_goodput_delivered_tokens',
                 help='goodput: emitted tokens that reached a '
                      'request as useful work (lifetime)',
                 labelnames=('engine',)).set(
                     good['delivered_tokens'], engine=e)
        wg = _m.gauge(
            'ptpu_serve_goodput_wasted_tokens',
            help='goodput: emitted tokens destroyed or discarded, '
                 'by cause (preempt_recompute/spec_rejected/'
                 'drain_recompute)',
            labelnames=('engine', 'cause'))
        for cause, v in good['wasted_by_cause'].items():
            wg.set(v, engine=e, cause=cause)
        _m.gauge('ptpu_serve_goodput_spec_shed_tokens',
                 help='goodput: draft capacity the degradation '
                      'ladder shed (never computed — outside the '
                      'delivered+wasted identity)',
                 labelnames=('engine',)).set(
                     good['spec_shed_tokens'], engine=e)
        if good['goodput_fraction'] is not None:
            _m.gauge('ptpu_serve_goodput_fraction',
                     help='goodput: delivered / emitted tokens',
                     labelnames=('engine',)).set(
                         good['goodput_fraction'], engine=e)
        if roof is not None and 'hbm_gbps' in roof:
            _m.gauge('ptpu_serve_ledger_bytes_per_iteration',
                     help='decode roofline: modeled bytes moved '
                          'per decode iteration (params + KV page '
                          'reads)',
                     labelnames=('engine',)).set(
                         roof['decode_bytes_per_iteration'],
                         engine=e)
            _m.gauge('ptpu_serve_ledger_hbm_gbps',
                     help='decode roofline: achieved HBM GB/s '
                          '(modeled bytes / measured compiled-'
                          'step wall)',
                     labelnames=('engine',)).set(roof['hbm_gbps'],
                                                 engine=e)
            if roof.get('peak_hbm_gbps'):
                _m.gauge('ptpu_serve_ledger_peak_hbm_gbps',
                         help='decode roofline: per-chip HBM '
                              'bandwidth peak for the local card',
                         labelnames=('engine',)).set(
                             roof['peak_hbm_gbps'], engine=e)
            if roof.get('mbu') is not None:
                _m.gauge('ptpu_serve_ledger_mbu',
                         help='decode roofline: memory-bandwidth '
                              'utilization vs the per-chip peak '
                              '(absent on CPU dryruns)',
                         labelnames=('engine',)).set(roof['mbu'],
                                                     engine=e)
        if roof is not None and 'prefill_tflops' in roof:
            _m.gauge('ptpu_serve_ledger_prefill_tflops',
                     help='prefill roofline: achieved forward '
                          'model TFLOP/s over prefill dispatches',
                     labelnames=('engine',)).set(
                         roof['prefill_tflops'], engine=e)
            if roof.get('prefill_mfu') is not None:
                _m.gauge('ptpu_serve_ledger_prefill_mfu',
                         help='prefill roofline: model-FLOPs '
                              'utilization vs the per-chip peak '
                              '(absent on CPU dryruns)',
                         labelnames=('engine',)).set(
                             roof['prefill_mfu'], engine=e)
        return acct


def serve_ledger_snapshot():
    """The live ledger registry's JSON-ready view, or None when no
    serving ledger is registered (every engine shut down). Shape:

      {'ledger':   {site: account()},        # may be all-None values
       'goodput':  merged goodput across sites (one pipeline),
       'roofline': {site: roofline()}}

    Goodput merges across sites because a disaggregated pipeline's
    prefill and decode engines split one token stream; the ledger and
    roofline stay per site (their walls are different loops).
    """
    with _ledgers_lock:
        ledgers = dict(_ledgers)
    if not ledgers:
        return None
    ledger = {}
    roofline = {}
    merged = {'emitted_tokens': 0, 'delivered_tokens': 0,
              'wasted_tokens': 0,
              'wasted_by_cause': {c: 0 for c in _WASTE_CAUSES},
              'spec_shed_tokens': 0, 'per_tenant': {}}
    for site, led in sorted(ledgers.items()):
        acct = led.account()
        if acct is not None:
            ledger[site] = acct
        roof = led.roofline()
        if roof is not None:
            roofline[site] = roof
        g = led.goodput()
        for k in ('emitted_tokens', 'delivered_tokens', 'wasted_tokens',
                  'spec_shed_tokens'):
            merged[k] += g[k]
        for c, v in g['wasted_by_cause'].items():
            merged['wasted_by_cause'][c] = \
                merged['wasted_by_cause'].get(c, 0) + v
        for tid, row in g['per_tenant'].items():
            dst = merged['per_tenant'].setdefault(
                tid, {'delivered_tokens': 0, 'wasted_tokens': 0})
            dst['delivered_tokens'] += row['delivered_tokens']
            dst['wasted_tokens'] += row['wasted_tokens']
    merged['goodput_fraction'] = (
        merged['delivered_tokens'] / merged['emitted_tokens']
        if merged['emitted_tokens'] else None)
    return {'ledger': ledger or None,
            'goodput': merged,
            'roofline': roofline or None}


def render_serve_ledger(snap):
    """Human rendering of a serve_ledger_snapshot() dict."""
    out = ['== serving ledger ' + '=' * 42]
    for site, a in sorted((snap.get('ledger') or {}).items()):
        wall = a.get('wall_seconds') or 0.0
        hbf = a.get('host_bound_fraction')
        out.append(
            f"engine: {site}   wall {wall * 1e3:.3f} ms/iter   "
            f"reconciled {(a.get('reconciled_fraction') or 0):.3f}"
            + (f"   host-bound {hbf * 100:.1f}%"
               if hbf is not None else ''))
        comps = a.get('components') or {}
        for name in _COMPONENTS:
            v = comps.get(name) or 0.0
            pct = (v / wall * 100.0) if wall else 0.0
            out.append(f"  {name:<12} {v * 1e3:>10.3f} ms  {pct:5.1f}%")
        fw = a.get('fused_windows') or 0
        if fw:
            fi = a.get('fused_iterations') or 0
            out.append(
                f"  fused decode: {fi} iterations in {fw} windows "
                f"(mean k {fi / fw:.1f}), "
                f"{a.get('fused_tokens') or 0} tokens, one host fetch "
                f"per window")
    g = snap.get('goodput') or {}
    if g:
        frac = g.get('goodput_fraction')
        out.append(
            f"goodput: {g.get('delivered_tokens', 0)} delivered / "
            f"{g.get('wasted_tokens', 0)} wasted of "
            f"{g.get('emitted_tokens', 0)} emitted"
            + (f"  ({frac * 100:.1f}% goodput)"
               if frac is not None else ''))
        causes = g.get('wasted_by_cause') or {}
        if any(causes.values()):
            out.append('  wasted by cause: ' + '  '.join(
                f'{c}={v}' for c, v in sorted(causes.items()) if v))
        if g.get('spec_shed_tokens'):
            out.append(f"  spec capacity shed (not computed): "
                       f"{g['spec_shed_tokens']} tokens")
        pt = g.get('per_tenant') or {}
        for tid in sorted(pt):
            row = pt[tid]
            out.append(f"  tenant {tid}: "
                       f"{row.get('delivered_tokens', 0)} delivered, "
                       f"{row.get('wasted_tokens', 0)} wasted")
    for site, r in sorted((snap.get('roofline') or {}).items()):
        if 'hbm_gbps' in r:
            line = (f"roofline[{site}]: decode "
                    f"{r['decode_bytes_per_iteration'] / 1e6:.2f} "
                    f"MB/iter -> {r['hbm_gbps']:.2f} GB/s")
            if r.get('mbu') is not None:
                line += (f"  MBU {r['mbu'] * 100:.1f}% of "
                         f"{r['peak_hbm_gbps']} GB/s peak")
            out.append(line)
        if 'prefill_tflops' in r:
            line = (f"roofline[{site}]: prefill "
                    f"{r['prefill_tflops']:.4f} TFLOP/s")
            if r.get('prefill_mfu') is not None:
                line += (f"  MFU {r['prefill_mfu'] * 100:.1f}% of "
                         f"{r['peak_tflops']} TFLOP/s peak")
            out.append(line)
    return '\n'.join(out)
