"""The pipeline train step at pp = 1 — counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/spmd_pipeline.py`.

Ported: the schedule's pure helpers (`resolve_virtual_stages`,
`chunk_layer_order`, `schedule_model`, :79-212), the two error types,
and `SpmdPipelineEngine` on one card: pp = 1, dp = 1, the '1F1B'
schedule in 'stash' memory mode. At pp = 1 the reference's `lax.scan`
runs A ticks (:1300-1590); each tick takes one micro-batch forward under
`jax.vjp` and applies the pullback in the same tick. The port does the
same eagerly, micro-batch by micro-batch:

  * the forward runs the embedding, the blocks (each wrapped by the
    resolved remat policy; the embedding and the head are not) and the
    head, whose mean loss is taken in fp32;
  * the backward starts from that loss with cotangent 1/A (`grad_cot`,
    :1383-1386), so the loss is scaled before the backward and the
    gradients are not divided after it;
  * gradients accumulate in the parameter dtype (`grad_accum_dtype=
    'param'`: torch's own `.grad` accumulation rounds each add to the
    dtype, as `a + g.astype(a.dtype)` does) or in fp32 buffers
    ('float32', the reference's default);
  * the update is the per-parameter `_update_one` (:2113-2127), the
    route the reference takes at dp = 1 (its bucketed route needs
    `dp_on_init`, :581, :603-605), in place: a fusible rule on the fused
    update kernel, one launch for every parameter of the step (where XLA
    fuses each parameter's chain into one pass); Lamb, Lars, Ftrl and
    DGCMomentum on the same op chain (`shard_update_chain`);
  * the loss is the sum of the fp32 micro-batch losses over A (:1340).

Loss scaling (the GradScaler path, :2100-2110, :911-961):
`train_batch(scale=s)` and `train_step(scaler=...)` seed the backward
with s / A, so the gradients come out scaled. `found_inf` is any
nonfinite gradient of any parameter, from the gradient-statistics
kernel's nonfinite count of each gradient; each gradient is unscaled by
1 / s in fp32 and rounded back to its dtype, as the reference does, in
the update kernel's prefactor; and a step with `found_inf` set leaves
every parameter and state bit-equal (the kernel's found-inf select, the
reference's `where`). `last_found_inf` and each AsyncResult's
`found_inf` hold the flag on the device; a scaler passed to
`train_step` gets `update_from_found` when the step drains, in
submission order. No step reads the flag back to the host.

`device_lr` (the kwarg, then `PTPU_DEVICE_LR`) computes a step-indexed
schedule's lr on the card (`optimizer/device_lr.py`).

Telemetry (:537, :678-695, :2137-2302): the engine keeps a
`HostGapMonitor('pipeline')` (`_gap`) that brackets each dispatch and
hears each drain's wait, and a `StepLedger('pipeline')` (`_ledger`) fed
the batch shape at dispatch (host metadata only); `flush()` publishes
both (`AsyncDispatchMixin`). Memory phases `engine.init`,
`pipeline.build` (the first dispatch's kernel-library load) and
`pipeline.step` bracket the engine; every warm step stamps the flight
recorder's heartbeat and a span. The schedule model (`ptpu_pp_*`) and
the comm model at dp = 1 (`ptpu_comm_*`, `enabled` 0) are published at
init. With `FLAGS_tensor_stats` or `FLAGS_check_nan_inf` (latched at the
first dispatch) each step also builds the numerics taps of every
gradient (unscaled) and updated parameter on the card; the drain fetches
them with the found-inf flag in one host sync, skips them on a loss-scale
overflow, publishes the `ptpu_num_*` gauges, and under
`FLAGS_check_nan_inf` raises `NumericsError` naming the first nonfinite
tensor.

Remat: `remat_policy` (the kwarg, then `PTPU_REMAT_POLICY`) picks one of
the four policies of `utils/recompute.py`; without one, `use_remat=True`
means 'full' per block, the reference's choice at pp = 1 (`save_dots`
holds only at pp > 1, :1309-1315, :846-852).

The engine trains the layers' own parameters, moved to its device (the
card unless the caller passes device='cpu'). Dropout draws from the
engine's `torch.Generator` (seeded from `seed`), bound with `rng_guard`:
per micro-batch the embedding's masks, then the blocks' in order, then
the head's. Everything else of the reference raises NotImplementedError
and names the ROADMAP item that brings it (`_UNSERVED`).
"""
import os

import numpy as np
import torch
from torch.profiler import record_function

from ....amp import uncast
from ....core import async_step as A_
from ....core import bucketing as B
from ....core import ledger as _led
from ....core import memory as _mem
from ....core import numerics as _num
from ....core import rng
from ....device import resolve_device
from ....ops.kernels import _build
from ....ops.kernels import fused_optimizer as FO
from ....optimizer import device_lr as dlr
from ..utils import recompute as remat
from .meta_parallel_base import EngineTeardown


class PipelineScheduleError(ValueError):
    """A pipeline-schedule configuration the engine cannot honor
    (layer/chunk divisibility, virtual stages on a schedule without
    them, accumulate_steps not forming whole microbatch groups)."""


class PipelineBatchError(ValueError):
    """A batch whose shape cannot be microbatched by the engine
    (size not divisible by dp x accumulate_steps, or an input/label
    leading-dimension mismatch)."""


def resolve_virtual_stages(virtual_stages=None, from_layer=None):
    """Virtual-stage count resolution: explicit kwarg -> PTPU_PP_VIRTUAL
    env -> PipelineLayer(num_virtual_pipeline_stages=) -> None (unset)."""
    if virtual_stages is not None:
        return int(virtual_stages)
    env = os.environ.get('PTPU_PP_VIRTUAL')
    if env:
        try:
            return int(env)
        except ValueError:
            raise PipelineScheduleError(
                f"PTPU_PP_VIRTUAL={env!r} is not an integer")
    if from_layer is not None:
        return int(from_layer)
    return None


def chunk_layer_order(num_layers, pp, virtual_stages):
    """Round-robin layer -> (stage, chunk) assignment (arXiv:2104.04473
    interleaved schedule): global model chunk g = c*pp + s holds layers
    [g*per, (g+1)*per) with per = num_layers/(pp*v). Returns the
    STACKING order: row i of the [num_layers, ...] stacked block tree
    holds original layer order[i]. Identity when v == 1."""
    pp = max(int(pp), 1)
    v = max(int(virtual_stages or 1), 1)
    if num_layers % (pp * v) or num_layers < pp * v:
        raise PipelineScheduleError(
            f"{num_layers} layers cannot split round-robin into "
            f"pp({pp}) x virtual_stages({v}) = {pp * v} non-empty "
            f"chunks; pick num_layers divisible by pp*virtual_stages "
            f"(PipelineLayer(num_virtual_pipeline_stages=) / "
            f"virtual_stages= / PTPU_PP_VIRTUAL)")
    per = num_layers // (pp * v)
    return [(c * pp + s) * per + i
            for s in range(pp) for c in range(v) for i in range(per)]


def _sim_inflight(pp, A, v):
    """Walk the interleaved-1F1B tick table: per-chunk residual slots
    needed and the peak in-flight microbatch count per device. v=1
    reproduces the classic 1F1B window min(A, 2*pp-1)."""
    ppv = pp * v
    D = 2 * (pp - 1) + (v - 1) * pp
    T = A * v + D

    slots = 1
    peak = 0
    for s in range(pp):
        def t_fwd(c, m):
            r, q = divmod(m, pp)
            return s + r * ppv + c * pp + q

        def t_bwd(c, m):
            r, q = divmod(m, pp)
            return (D - s) + r * ppv + (v - 1 - c) * pp + q

        delta = [0] * (T + 2)
        for c in range(v):
            m0 = 0
            for m in range(A):
                delta[t_fwd(c, m)] += 1
                delta[t_bwd(c, m) + 1] -= 1
                while t_bwd(c, m0) < t_fwd(c, m):
                    m0 += 1
                slots = max(slots, m - m0 + 1)
        live = 0
        for d in delta:
            live += d
            peak = max(peak, live)
    return slots, peak


def schedule_model(schedule, pp, accumulate_steps, virtual_stages=1,
                   memory_mode=None):
    """Static schedule model of one pipeline step: tick count, executed
    chunk sub-steps per device, and the modeled bubble fraction,
    (pp - 1) / (A*v + pp - 1) on the 1F1B schedules."""
    if schedule in ('FThenB', 'F-then-B'):
        schedule = 'F-then-B'
    pp = max(int(pp), 1)
    A = int(accumulate_steps)
    v = max(int(virtual_stages or 1), 1) if schedule == 'interleaved' \
        else 1
    if schedule == 'F-then-B':
        ticks = A + pp - 1
        warmup = pp - 1
        fwd_w = bwd_w = A + pp - 1
        slots, peak = A, A
    else:                           # '1F1B' / 'interleaved'
        D = 2 * (pp - 1) + (v - 1) * pp
        ticks = A * v + D
        warmup = D - (pp - 1)
        fwd_w = bwd_w = A * v + pp - 1
        slots, peak = _sim_inflight(pp, A, v)
        slots = min(slots, A)
    useful = 2 * A * v
    chunk_ticks = fwd_w + bwd_w
    model = {
        'schedule': schedule,
        'pp': pp,
        'virtual_stages': v,
        'accumulate_steps': A,
        'ticks': ticks,
        'warmup_ticks': warmup,
        'fwd_window': fwd_w,
        'bwd_window': bwd_w,
        'chunk_ticks': chunk_ticks,
        'useful_chunk_ticks': useful,
        'bubble_fraction': 1.0 - useful / chunk_ticks,
        'inflight_peak': peak,
        'slots_per_chunk': slots,
        'ppermute_steps': 2 * ticks if pp > 1 else 0,
    }
    if memory_mode is not None:
        model['memory_mode'] = memory_mode
    return model


def publish_schedule_gauges(model, engine='pipeline'):
    """ptpu_pp_* gauges from a schedule_model() dict through
    core.monitor; StepTelemetry.snapshot()['pipeline'] reads them back."""
    try:
        from ....core.monitor import gauge
    except Exception:
        return
    lbl = {'engine': engine}
    for name, key, help_ in (
            ('ptpu_pp_ticks', 'ticks', 'pipeline scan ticks per step'),
            ('ptpu_pp_chunk_ticks', 'chunk_ticks',
             'executed chunk fwd+bwd sub-steps per device per step'),
            ('ptpu_pp_useful_chunk_ticks', 'useful_chunk_ticks',
             'unmasked chunk sub-steps per device per step'),
            ('ptpu_pp_bubble_fraction', 'bubble_fraction',
             'modeled masked-work fraction of the schedule'),
            ('ptpu_pp_inflight_peak', 'inflight_peak',
             'peak in-flight microbatches per device'),
            ('ptpu_pp_virtual_stages', 'virtual_stages',
             'model chunks per physical stage (v)'),
            ('ptpu_pp_stages', 'pp', 'pipeline-parallel degree'),
            ('ptpu_pp_accumulate_steps', 'accumulate_steps',
             'microbatches per step (A)')):
        gauge(name, help=help_, labelnames=('engine',)).set(
            float(model[key]), **lbl)
    g = gauge('ptpu_pp_schedule_info',
              help='active pipeline schedule (value 1; the schedule '
                   'rides in the label)',
              labelnames=('engine', 'schedule'))
    for other in ('1F1B', 'F-then-B', 'interleaved'):
        g.set(1 if other == model['schedule'] else 0,
              engine=engine, schedule=other)


def pipeline_snapshot(engine='pipeline'):
    """StepTelemetry.snapshot()['pipeline'] payload: the published
    schedule census read back from the ptpu_pp_* gauges (None when no
    pipeline engine has been built)."""
    try:
        from ....core import monitor as _m
        reg = _m.metrics()
        if reg.get('ptpu_pp_ticks') is None:
            return None

        def val(name):
            m = reg.get(name)
            if m is None:
                return None
            for labels, child in m._series().items():
                if labels and labels[0] == engine:
                    return child.value()
            return None

        snap = {
            'ticks': int(val('ptpu_pp_ticks') or 0),
            'chunk_ticks': int(val('ptpu_pp_chunk_ticks') or 0),
            'useful_chunk_ticks':
                int(val('ptpu_pp_useful_chunk_ticks') or 0),
            'bubble_fraction': val('ptpu_pp_bubble_fraction'),
            'inflight_peak': int(val('ptpu_pp_inflight_peak') or 0),
            'virtual_stages': int(val('ptpu_pp_virtual_stages') or 1),
            'pp': int(val('ptpu_pp_stages') or 1),
            'accumulate_steps':
                int(val('ptpu_pp_accumulate_steps') or 0),
        }
        info = reg.get('ptpu_pp_schedule_info')
        if info is not None:
            for labels, child in info._series().items():
                if labels and labels[0] == engine and child.value():
                    snap['schedule'] = labels[1]
        return snap
    except Exception:
        return None


# the profiler ranges around the per-parameter update and a micro-batch's
# head (final norm, LM head, cross-entropy)
UPDATE_RANGE = 'SpmdPipelineEngine::update'
HEAD_RANGE = 'SpmdPipelineEngine::head'

_MULTI = 'the multi-GPU engines, ROADMAP Queue 1 item 7'
# Every knob of the reference engine the port does not serve, with the
# values it accepts (the reference's default, or the value that turns the
# feature off) and what brings it. Any other value raises.
_UNSERVED = {
    'use_buckets': ((None, False), 'the bucketed update shards over dp > 1, '
                    + _MULTI),
    'comm_dtype': ((None,), _MULTI), 'bucket_mb': ((None,), _MULTI),
    'comm_block': ((None,), _MULTI), 'comm_overlap': ((None, False), _MULTI),
    'prefetch_depth': ((None,), _MULTI), 'comm_chunk': ((None,), _MULTI),
}


def _not_served(what, needs):
    return NotImplementedError(
        f'SpmdPipelineEngine: {what} is not ported yet ({needs})')


def _check_mesh(mesh):
    """The port runs every mesh axis at size 1."""
    shape = dict(getattr(mesh, 'shape', {}))
    if any(int(n) > 1 for n in shape.values()):
        raise _not_served(f'a mesh of {shape}', _MULTI)


class SpmdPipelineEngine(A_.AsyncDispatchMixin, EngineTeardown):
    """Pipelined train step at pp = 1 on one device.

    Args:
      embed: module mapping input_ids -> activations [mb, L, H].
      blocks: list of structurally identical modules x -> x.
      head: module mapping (activations, labels) -> the micro-batch's
        scalar loss (final norm + LM head + criterion).
      optimizer: a port optimizer (its per-parameter `update` rule).
      accumulate_steps: the number of micro-batches A.
      device: None (the card; raises when there is none) or 'cpu'.
      seed: the seed of the engine's dropout generator.
    """

    def __init__(self, embed, blocks, head, optimizer, accumulate_steps,
                 mesh=None, use_remat=True, schedule='1F1B',
                 grad_accum_dtype='float32', memory_mode='stash',
                 use_buckets=None, comm_dtype=None, bucket_mb=None,
                 comm_block=None, comm_overlap=None, prefetch_depth=None,
                 comm_chunk=None, remat_policy=None,
                 dispatch_window=None, device_lr=None,
                 virtual_stages=None, device=None, seed=0):
        given = dict(use_buckets=use_buckets, comm_dtype=comm_dtype,
                     bucket_mb=bucket_mb, comm_block=comm_block,
                     comm_overlap=comm_overlap,
                     prefetch_depth=prefetch_depth, comm_chunk=comm_chunk)
        for knob, value in given.items():
            ok, needs = _UNSERVED[knob]
            if not any(value is v for v in ok):
                raise _not_served(f'{knob}={value!r}', needs)
        _check_mesh(mesh)
        if memory_mode not in ('stash', 'recompute'):
            raise ValueError(f"memory_mode must be 'stash' or 'recompute', "
                             f"got {memory_mode!r}")
        if memory_mode == 'recompute':
            raise _not_served("memory_mode='recompute'",
                              'at pp = 1 the backward consumes the same '
                              "micro-batch's forward; " + _MULTI)
        if schedule in ('FThenB', 'F-then-B'):
            raise _not_served("schedule='F-then-B'", _MULTI)
        if schedule == 'interleaved':
            raise _not_served("schedule='interleaved'", _MULTI)
        if schedule != '1F1B':
            raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                             "expected '1F1B', 'F-then-B' or "
                             "'interleaved'")
        vv = resolve_virtual_stages(virtual_stages)
        if vv is not None and vv < 1:
            raise PipelineScheduleError(
                f"virtual_stages must be >= 1, got {vv}")
        if vv is not None and vv > 1:
            raise _not_served(f'virtual_stages={vv}', _MULTI)
        if grad_accum_dtype not in ('param', 'float32', torch.float32):
            raise ValueError(f"grad_accum_dtype must be 'param' or "
                             f"'float32', got {grad_accum_dtype!r}")
        if optimizer._grad_clip is not None:
            raise _not_served(
                'an optimizer with a grad_clip',
                'the reference engine stores optimizer._grad_clip '
                '(spmd_pipeline.py:674) and never applies it, so a clip '
                'handed to it is dropped; the port refuses it rather than '
                'drop it, ROADMAP Queue 3')

        self.device = resolve_device(device)
        self.embed = embed.to(self.device)
        self.blocks = [b.to(self.device) for b in blocks]
        self.head = head.to(self.device)
        self.optimizer = optimizer
        self.A = int(accumulate_steps)
        self.grad_accum_dtype = 'param' if grad_accum_dtype == 'param' \
            else 'float32'

        self._remat_policy = remat.resolve_policy(remat_policy, default=None)
        if self._remat_policy is not None:
            use_remat = self._remat_policy != 'none'
        self.use_remat = use_remat
        policy = self._remat_policy or ('full' if use_remat else None)
        self._block_fn = self._block_apply if policy is None else \
            remat.apply_policy(self._block_apply, policy, engine='pipeline')

        self._named = [(f'embed/{n}', p)
                       for n, p in self.embed.named_parameters()] + \
            [(f'blocks/{i}/{n}', p) for i, b in enumerate(self.blocks)
             for n, p in b.named_parameters()] + \
            [(f'head/{n}', p) for n, p in self.head.named_parameters()]
        self._named = [(n, p) for n, p in self._named if p.requires_grad]
        with _mem.phase('engine.init'):
            self._states = {}
            for n, p in self._named:
                st = optimizer.init_state(p.detach())
                if p.dtype != torch.float32 and optimizer._multi_precision:
                    st['master'] = p.detach().float()
                self._states[n] = st
            self._acc = None
            if self.grad_accum_dtype == 'float32':
                self._acc = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=self.device)
                             for _, p in self._named]
        self._cot = torch.tensor(1.0 / self.A, dtype=torch.float32,
                                 device=self.device)
        self._lr_feed = dlr.LrFeed(optimizer, device_lr, self.device)
        self._no_inf = torch.zeros((), dtype=torch.bool, device=self.device)
        self.last_found_inf = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._inflight = A_.DispatchWindow(
            A_.resolve_dispatch_window(dispatch_window))
        self._step_no = 0
        self._closed = False
        self._sched_model = schedule_model('1F1B', 1, self.A)
        publish_schedule_gauges(self._sched_model, engine='pipeline')
        self._publish_comm_model(optimizer)
        self._gap = A_.HostGapMonitor('pipeline')
        self._ledger = _led.StepLedger(
            'pipeline', gap=self._gap,
            params_fn=lambda: _led.count_params(
                [p for _, p in self._named]),
            remat_policy=self._remat_policy or (
                'full' if self.use_remat else 'none'),
            bubble_fraction_fn=lambda: self._sched_model.get(
                'bubble_fraction', 0.0))
        self._taps_on = None        # latched at the first dispatch
        self.last_numerics = None

    def _publish_comm_model(self, optimizer):
        """The reference's per-step comm model of the bucketed layout
        (:581-625) at dp = 1: nothing crosses a link, so it is published
        with `enabled` 0 (the step's exposed comm is modeled, not run)."""
        if not B.elementwise(optimizer) or not self._named:
            return
        _dtype, bucket_bytes = B.resolve_comm_config()
        layout = B.BucketLayout.build(
            {n: (tuple(p.shape), p.dtype) for n, p in self._named},
            bucket_bytes=bucket_bytes, pad_to=8,
            group_fn=lambda name, shape, dtype:
                'blocks' if name.startswith('blocks/') else 'repl')
        comm = torch.float32 if self.grad_accum_dtype == 'float32' \
            else None
        B.publish_comm_gauges(layout, engine='pipeline', n_shards=1,
                              comm_dtype=comm, enabled=False)
        _ov, prefetch, chunk = B.resolve_overlap_config()
        B.publish_overlap_gauges(layout, engine='pipeline', n_shards=1,
                                 comm_dtype=comm, enabled=False,
                                 prefetch=prefetch, chunk=chunk)

    # -- the step ------------------------------------------------------------
    @staticmethod
    def _block_apply(block, x):
        return block(x)

    def _microbatch_loss(self, ids, labels):
        x = self.embed(ids)
        for block in self.blocks:
            x = self._block_fn(block, x)
        with record_function(HEAD_RANGE):
            return self.head(x, labels).float()

    def _to_device(self, b, staged):
        """`b` on the engine's device. A host batch bound for the card is
        staged in pinned memory and copied without blocking the host, so
        the dispatch window runs ahead of the card; the pinned buffer
        joins `staged`, which the step's AsyncResult keeps until it
        drains."""
        if isinstance(b, np.ndarray):
            b = torch.from_numpy(b)
        if self.device.type == 'cuda' and b.device.type == 'cpu':
            b = b.pin_memory()
            staged.append(b)
            return b.to(self.device, non_blocking=True)
        return b.to(self.device)

    def _dispatch(self, data, scale=None, scaler=None):
        self._ensure_open()
        # the gap bracket opens before any call that can wait on the card
        self._gap.dispatch_begin()
        if scaler is not None and scale is None and scaler.is_enable():
            scale = scaler._scale
        input_ids, labels = data
        staged = []
        ids = self._to_device(input_ids, staged)
        lab = self._to_device(labels, staged)
        self._ledger.observe_batch(tuple(ids.shape))
        n = int(ids.shape[0]) if ids.dim() else 0
        if lab.dim() == 0 or int(lab.shape[0]) != n:
            raise PipelineBatchError(
                f"inputs and labels disagree on the batch dimension: "
                f"{tuple(ids.shape)} vs {tuple(lab.shape)}")
        if n == 0 or n % self.A:
            raise PipelineBatchError(
                f"batch size {n} is not divisible by dp(1) x "
                f"accumulate_steps({self.A}); feed dp * A * "
                "micro_batch_size rows per step (adjust "
                "accumulate_steps or pipeline_configs)")
        mb = n // self.A
        first = self._taps_on is None
        if first:
            self._taps_on = _num.taps_enabled()
            with _mem.phase('pipeline.build'):
                if self.device.type == 'cuda':
                    _build.lib()
        with self._step_guard(first, 'pipeline.train_step',
                              'pipeline.step'):
            for _, p in self._named:
                p.grad = None
            if self._acc is not None:
                for a in self._acc:
                    a.zero_()
            cot, scale_t = self._seed(scale)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            with rng.rng_guard(self.generator):
                for m in range(self.A):
                    rows = slice(m * mb, (m + 1) * mb)
                    loss = self._microbatch_loss(ids[rows], lab[rows])
                    loss.backward(cot)
                    loss_sum += loss.detach()
                    if self._acc is not None:
                        for a, (_, p) in zip(self._acc, self._named):
                            if p.grad is not None:
                                a.add_(p.grad)
                                p.grad = None
            lr = self._lr_feed.lr()
            with torch.no_grad(), record_function(UPDATE_RANGE):
                found = self._update(lr, scale_t)
                taps = self._taps(scale_t) if self._taps_on else None
            self._lr_feed.advance()
            loss = self._mean(loss_sum)
        self._step_no += 1
        self.last_found_inf = found
        on_drain = None
        if taps is not None or scaler is not None:
            def on_drain(res, _t=taps, _s=self._step_no, _scaler=scaler):
                found_host = None
                if _t is not None:
                    found_host = self._process_taps(res.found_inf, _t,
                                                    step=_s)
                if _scaler is not None:
                    if found_host is None:
                        found_host = bool(res.found_inf)
                    _scaler.update_from_found(bool(found_host))
        self._gap.dispatch_end(depth=len(self._inflight) + 1)
        # created after dispatch_end: while this is the newest step, a
        # wait on it is the synchronous discipline's (host gap)
        return A_.AsyncResult(loss, self._step_no, staged, found_inf=found,
                              on_drain=on_drain, taps=taps,
                              monitor=self._gap)

    @uncast
    def _taps(self, scale_t):
        """The step's numerics taps on the card (no host sync): every
        gradient's stats, unscaled by 1/scale in fp32 on a loss-scaled
        step, and every updated parameter's."""
        inv = None if scale_t is None else 1.0 / scale_t
        return _num.jit_taps(
            {n: g for (n, _p), g in zip(self._named, self._grads())},
            {n: p.detach() for n, p in self._named}, scale=inv)

    def _process_taps(self, found, taps, step=None):
        """found_inf and the taps in ONE host fetch; a loss-scale
        overflow's taps are skipped (its gradients are nonfinite by
        design and its update was skipped). Returns the host flag."""
        found_host, taps_host = _num._host_fetch((found, taps))
        found_host = bool(found_host)
        if found_host:
            self.last_numerics = None
            return found_host
        meta = {kind: {n: (tuple(p.shape),
                           str(p.dtype).replace('torch.', ''))
                       for n, p in self._named}
                for kind in ('grads', 'params')}
        self.last_numerics = _num.process_jit_taps(
            taps_host, site='pipeline', step=step, meta=meta)
        return found_host

    # the step's own arithmetic is jnp code in the reference, which
    # amp.auto_cast does not reach

    @uncast
    def _seed(self, scale):
        """(the backward's cotangent, the loss scale as a device fp32
        scalar or None): 1/A, or scale/A in fp32 (:1383-1386). A fill,
        not a host copy: no step waits on the card."""
        if scale is None:
            return self._cot, None
        scale_t = torch.full((), float(scale), dtype=torch.float32,
                             device=self.device)
        return scale_t / self.A, scale_t

    @uncast
    def _mean(self, loss_sum):
        return loss_sum / self.A

    def _grads(self):
        for i, (_, p) in enumerate(self._named):
            g = self._acc[i] if self._acc is not None else p.grad
            # unused: the reference's zero gradient
            yield g if g is not None else torch.zeros_like(p)

    @uncast
    def _update(self, lr, scale_t):
        """Every parameter's update (one launch of the update kernel for
        all of them); with a loss scale, the found-inf flag from every
        gradient's nonfinite count (the statistics kernel, one launch a
        gradient), the unscale and the skip. Returns the flag (a device
        bool)."""
        grads = list(self._grads())
        found, inv = self._no_inf, None
        if scale_t is not None:
            counts = [FO.grad_stats(g)[1] for g in grads]
            found = torch.stack(counts).sum() > 0
            inv = 1.0 / scale_t
        opt, fi = self.optimizer, None if inv is None else found
        entries = [(p.detach(), g, self._states[n])
                   for (n, p), g in zip(self._named, grads)]
        if FO.fusible(opt):
            out = FO.ParamUpdates(opt, lr, prefactor=inv,
                                  found_inf=fi).apply(entries)
        else:
            out = [FO.shard_update_chain(opt, p, g, st, lr, inv, fi,
                                         round_prefactor=True)
                   for p, g, st in entries]
        for (n, _p), (_new, st) in zip(self._named, out):
            self._states[n] = st
        return found

    def train_batch(self, data, scale=None):
        """data = (input_ids, labels) of A x micro-batch rows: one step;
        returns the mean micro-batch loss as an fp32 0-dim tensor.
        `scale`: a loss scale (the GradScaler path): the gradients are
        unscaled, a nonfinite one skips the update, and
        `last_found_inf` holds the verdict on the device."""
        if len(self._inflight):
            self.flush()
        res = self._dispatch(data, scale=scale)
        res.wait()
        return res.loss

    def train_step(self, data, scaler=None):
        """One step queued without a host fetch: returns an AsyncResult
        (the loss and the found-inf flag on the device); the window waits
        on the oldest step past `dispatch_window`. `flush()` drains it.
        A GradScaler passed here scales the step by its current scale
        and gets that step's `update_from_found` when it drains, in
        submission order: a scale change reaches the steps dispatched
        after its drain (up to the window later than the per-step
        path), as in the reference."""
        return self._inflight.push(self._dispatch(data, scaler=scaler))

    def named_opt_states(self):
        """{'embed/<name>' | 'blocks/<i>/<name>' | 'head/<name>': {state
        key: CPU tensor}}."""
        return {n: {k: v.detach().cpu().clone() for k, v in st.items()}
                for n, st in self._states.items()}

    def sync_model(self):
        """At pp = 1 the engine trains the layers' own parameters, so
        every dispatched step is in them once the window drains."""
        self._ensure_open()
        self.flush()

    def _ensure_open(self):
        if self._closed:
            raise RuntimeError(
                'SpmdPipelineEngine was shut down; build a new engine to '
                'keep training')

    def shutdown(self):
        """Drain the window, disarm the heartbeat, and drop the optimizer
        state and the fp32 accumulators inside an `engine.shutdown`
        census phase; returns the memory sample after the release. The
        engine refuses work afterwards. Idempotent."""
        if self._closed:
            return _mem.sample(count_buffers=True)
        self.flush()

        def release():
            self._states, self._acc = {}, None
            self._closed = True
        return self._teardown(release)

    close = shutdown
