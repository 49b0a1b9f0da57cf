"""The hybrid-parallel train step at degree 1 — counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/hybrid_engine.py`
(`HybridParallelTrainStep`, :57-910).

At degree 1 (every mesh axis of size 1, one card) the reference's
compiled step is: the loss of `loss_fn(model, *batch)` in fp32 under
the resolved remat policy, its gradients in the parameters' dtypes, the
global-norm clip when the optimizer has a `ClipGradByGlobalNorm`, and
the per-parameter `_update_one` (:660-680) — its bucketed route needs
more than one shard (`_bucketed` is False at `_n_shards == 1`,
:166-168). The port does the same eagerly:

  * the forward and the backward from the fp32 loss, under
    `recompute.apply_policy` (the kwarg, then `PTPU_REMAT_POLICY`, then
    'full' if `use_remat` else 'none'), with dropout drawn from the
    engine's `torch.Generator` (seeded from `seed`);
  * the clip (`clip_factor`, :359-374): the factor clip_norm /
    max(||g||, clip_norm) from the fp32 sum of every gradient's squares
    (the reference's `global_norm_sq`, :333, plain sums), each gradient
    scaled in fp32 and rounded back to its dtype;
  * the update: one launch of the fused update kernel for every
    parameter (`fused_optimizer.ParamUpdates.apply`, in place; the clip
    rides in as its prefactor), with the fp32 master each low-precision parameter keeps
    when `multi_precision` is on and the decay into the gradient when
    the rule asks for it; Lamb, Lars, Ftrl and DGCMomentum on their op
    chain.

A model's buffers stay the model's own: batch norm's running statistics
move in place during each step's forward (once a step under every remat
policy), as PaddlePaddle's engines and both packages' `TrainStep` move
them. The reference's engine binds the parameters only and restores
every buffer on exit (:398-399, `jit/__init__.py:36-58` there), so its
running statistics never move; the port does not copy that (ROADMAP
Queue 3).

`__call__` drains the dispatch window, runs one step and waits;
`train_step` queues one through the window (`core/async_step.py`);
`device_lr` computes a step-indexed schedule's lr on the card.

Telemetry (:245-262, :680-800): a `HostGapMonitor('hybrid')` and a
`StepLedger('hybrid')` as the pipeline engine keeps them, the memory
phases, the flight recorder's heartbeat, and with `FLAGS_tensor_stats`
or `FLAGS_check_nan_inf` (latched at the first dispatch) the numerics
taps: the stats of every pre-clip gradient and updated parameter and
the global grad-norm^2 the clip uses (one sum of squares for both),
fetched in one host sync when the step drains.

Not ported, each raising NotImplementedError that names what brings
it: an axis above 1, the bucketed update and its comm knobs, sequence
parallelism and `sp_shard_args` (ROADMAP Queue 1 item 7).
`accumulate_steps` is stored by the reference and read
nowhere, so a value above 1 is silently ignored there; the port takes 1
and refuses any other (ROADMAP Queue 3). A clip other than the global
norm is dropped by the reference (`clip_factor` returns None); the port
refuses it.
"""
import numpy as np
import torch
from torch.profiler import record_function

from ....amp import uncast
from ....core import async_step as A_
from ....core import ledger as _led
from ....core import memory as _mem
from ....core import numerics as _num
from ....core import rng
from ....device import resolve_device
from ....nn.clip import ClipGradByGlobalNorm, global_factor
from ....ops.kernels import fused_optimizer as FO
from ....optimizer import device_lr as dlr
from ... import topology_runtime
from ..utils import recompute as remat
from .meta_parallel_base import EngineTeardown

# the profiler range around the per-parameter update
UPDATE_RANGE = 'HybridParallelTrainStep::update'

_MULTI = 'the multi-GPU engines, ROADMAP Queue 1 item 7'
# every knob of the reference the port does not serve: the values it
# accepts (the default, or the value that keeps the feature off)
_UNSERVED = {
    'use_buckets': ((None, False), 'the bucketed update shards over more '
                    'than one rank, ' + _MULTI),
    'comm_dtype': ((None,), _MULTI), 'bucket_mb': ((None,), _MULTI),
    'comm_block': ((None,), _MULTI), 'comm_overlap': ((None, False), _MULTI),
    'prefetch_depth': ((None,), _MULTI), 'comm_chunk': ((None,), _MULTI),
    'sequence_parallel': ((None, False), _MULTI),
    'sp_shard_args': ((None,), 'sequence sharding over sp > 1, ' + _MULTI),
}


def _not_served(what, needs):
    return NotImplementedError(
        f'HybridParallelTrainStep: {what} is not ported yet ({needs})')


class HybridParallelTrainStep(A_.AsyncDispatchMixin, EngineTeardown):
    """One train step over the registered degree-1 mesh.

    loss_fn(model, *batch) -> scalar loss. The engine trains the model's
    own parameters, moved to its device (the card unless the caller
    passes device='cpu'); `seed` seeds its dropout generator.
    """

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 accumulate_steps=1, use_remat=False, sp_shard_args=None,
                 use_buckets=None, comm_dtype=None, bucket_mb=None,
                 comm_block=None, comm_overlap=None, prefetch_depth=None,
                 comm_chunk=None, remat_policy=None,
                 sequence_parallel=None, dispatch_window=None,
                 device_lr=None, device=None, seed=0):
        given = dict(use_buckets=use_buckets, comm_dtype=comm_dtype,
                     bucket_mb=bucket_mb, comm_block=comm_block,
                     comm_overlap=comm_overlap,
                     prefetch_depth=prefetch_depth, comm_chunk=comm_chunk,
                     sequence_parallel=sequence_parallel,
                     sp_shard_args=sp_shard_args)
        for knob, value in given.items():
            ok, needs = _UNSERVED[knob]
            if not any(value is v for v in ok):
                raise _not_served(f'{knob}={value!r}', needs)
        self.mesh = mesh if mesh is not None else topology_runtime.get_mesh()
        if self.mesh is None:
            raise ValueError('no mesh registered; build_mesh() first')
        shape = dict(self.mesh.shape)
        big = {a: n for a, n in shape.items() if int(n) > 1}
        if big:
            raise _not_served(f'a mesh with {big}', _MULTI)
        if int(accumulate_steps) != 1:
            raise _not_served(
                f'accumulate_steps={accumulate_steps}',
                'the reference stores accumulate_steps (hybrid_engine.py:87) '
                'and reads it nowhere, so a value above 1 is silently '
                'ignored there; the port refuses it, ROADMAP Queue 3')
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
            raise _not_served(
                f'a {type(clip).__name__}',
                'the reference engine applies only a global-norm clip and '
                'drops any other (clip_factor, hybrid_engine.py:359-368); '
                'the port refuses it rather than drop it, ROADMAP Queue 3')
        self._remat_policy = remat.resolve_policy(
            remat_policy, default='full' if use_remat else 'none')
        self.use_remat = self._remat_policy != 'none'
        self._loss_of = remat.apply_policy(self._loss, self._remat_policy,
                                           engine='hybrid')

        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._grad_clip = clip
        self._named = [(n, p) for n, p in self.model.named_parameters()
                       if p.requires_grad]
        with _mem.phase('engine.init'):
            self._states = {}
            for n, p in self._named:
                st = optimizer.init_state(p.detach())
                if p.dtype != torch.float32 and optimizer._multi_precision:
                    st['master'] = p.detach().float()
                self._states[n] = st
        self._lr_feed = dlr.LrFeed(optimizer, device_lr, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._inflight = A_.DispatchWindow(
            A_.resolve_dispatch_window(dispatch_window))
        self._step_count = 0
        self._closed = False
        self._gap = A_.HostGapMonitor('hybrid')
        self._ledger = _led.StepLedger(
            'hybrid', gap=self._gap,
            params_fn=lambda: _led.count_params(
                [p for _, p in self._named]),
            remat_policy=self._remat_policy)
        self._taps_on = None        # latched at the first dispatch
        self.last_numerics = None

    # -- the step ------------------------------------------------------------
    def _loss(self, *batch):
        return self.loss_fn(self.model, *batch).float()

    def _to_device(self, b, staged):
        """`b` on the engine's device; a host batch bound for the card is
        staged in pinned memory and copied without blocking the host
        (the pinned buffer joins `staged`, kept until the step drains)."""
        if isinstance(b, np.ndarray):
            b = torch.from_numpy(b)
        if not isinstance(b, torch.Tensor):
            return b
        if self.device.type == 'cuda' and b.device.type == 'cpu':
            b = b.pin_memory()
            staged.append(b)
            return b.to(self.device, non_blocking=True)
        return b.to(self.device)

    def _dispatch(self, batch):
        self._ensure_open()
        self._gap.dispatch_begin()
        staged = []
        batch = [self._to_device(b, staged) for b in batch]
        shapes = [tuple(b.shape) for b in batch
                  if isinstance(b, torch.Tensor)]
        if shapes:
            self._ledger.observe_batch(shapes[0])
        first = self._taps_on is None
        if first:
            self._taps_on = _num.taps_enabled()
        with self._step_guard(first, 'hybrid.train_step', 'hybrid.step'):
            for _, p in self._named:
                p.grad = None
            with rng.rng_guard(self.generator):
                loss = self._loss_of(*batch)
            loss.backward()
            lr = self._lr_feed.lr()
            with torch.no_grad(), record_function(UPDATE_RANGE):
                taps = self._update(lr)
            self._lr_feed.advance()
        self._step_count += 1
        on_drain = None
        if taps is not None:
            def on_drain(res, _t=taps, _s=self._step_count):
                self._process_taps(_t, 'hybrid', step=_s)
        self._gap.dispatch_end(depth=len(self._inflight) + 1)
        # created after dispatch_end: while this is the newest step, a
        # wait on it is the synchronous discipline's (host gap)
        return A_.AsyncResult(loss.detach(), self._step_count, staged,
                              on_drain=on_drain, taps=taps,
                              monitor=self._gap)

    def _process_taps(self, taps, site, step=None):
        """One host sync for the step's taps; publishes the ptpu_num_*
        gauges and raises NumericsError on a nonfinite gradient
        (FLAGS_check_nan_inf) naming the parameter."""
        meta = {kind: {n: (tuple(p.shape),
                           str(p.dtype).replace('torch.', ''))
                       for n, p in self._named}
                for kind in ('grads', 'params')}
        self.last_numerics = _num.process_jit_taps(
            taps, site=site, step=step, meta=meta)

    def _grads(self):
        # an unused parameter: the reference's zero gradient
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for _, p in self._named]

    def _global_norm_sq(self, grads):
        """The fp32 sum of every gradient's squares (:333)."""
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for g in grads:
            g32 = g.float()
            sq = sq + (g32 * g32).sum()
        return sq

    @uncast
    def _clip_factor(self, grads, gn_sq=None):
        """The global-norm clip's fp32 factor on the device, or None
        without a clip (:359-374)."""
        if self._grad_clip is None:
            return None
        if gn_sq is None:
            gn_sq = self._global_norm_sq(grads)
        return global_factor(torch.sqrt(gn_sq), self._grad_clip.clip_norm)

    @uncast
    def _update(self, lr):
        """Every parameter's `_update_one`, in place: one launch of the
        update kernel for all of them (their gradients are fresh each
        step, so only their pointers are read again). The global-norm
        clip's fp32 factor (:359-374) rides in as the prefactor. Returns
        the step's taps (pre-clip gradients, updated parameters) when
        they are on, else None."""
        grads = self._grads()
        gn_sq = None
        if self._taps_on or self._grad_clip is not None:
            gn_sq = self._global_norm_sq(grads)
        factor = self._clip_factor(grads, gn_sq)
        taps_grads = None
        if self._taps_on:
            # the pre-clip gradients' stats before the update reads them
            taps_grads = {n: _num.stats_vec(g)
                          for (n, _p), g in zip(self._named, grads)}
        opt = self.optimizer
        entries = [(p.detach(), g, self._states[n])
                   for (n, p), g in zip(self._named, grads)]
        if FO.fusible(opt):
            out = FO.ParamUpdates(opt, lr, prefactor=factor).apply(entries)
        else:
            out = [FO.shard_update_chain(opt, p, g, st, lr, factor,
                                         round_prefactor=True)
                   for p, g, st in entries]
        for (n, _p), (_new, st) in zip(self._named, out):
            self._states[n] = st
        if taps_grads is None:
            return None
        return {'grads': taps_grads,
                'params': {n: _num.stats_vec(p) for n, p in self._named},
                'grad_norm_sq': gn_sq}

    # -- public --------------------------------------------------------------
    def __call__(self, *batch):
        """One step, waited on; returns the fp32 loss (a 0-dim tensor on
        the engine's device). Queued `train_step`s drain first."""
        if len(self._inflight):
            self.flush()
        res = self._dispatch(batch)
        res.wait()
        return res.loss

    def train_step(self, *batch):
        """One step queued without a host fetch: an AsyncResult holding
        the loss on the device; the window waits on the oldest step past
        `dispatch_window`. `flush()` drains it."""
        return self._inflight.push(self._dispatch(batch))

    @property
    def params(self):
        """{name: the trained parameter}."""
        return {n: p for n, p in self._named}

    def sync_model(self):
        """The engine trains the model's own parameters, so every
        dispatched step is in them once the window drains."""
        self._ensure_open()
        self.flush()

    def state_dict(self):
        """{'params': {name: array}, 'states': {name: {key: array}},
        'step': steps taken}, host numpy in the parameters' and states'
        dtypes (bf16 as fp32, exact), after draining the window."""
        self.flush()

        def host(t):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy().copy()
        return {'params': {n: host(p) for n, p in self._named},
                'states': {n: {k: host(v) for k, v in st.items()}
                           for n, st in self._states.items()},
                'step': self._step_count}

    def set_state_dict(self, sd):
        """Restore `state_dict()`'s output: names absent from `sd` keep
        their values; the on-device lr counter re-syncs to the host
        scheduler."""
        self.flush()
        params = dict(self._named)
        with torch.no_grad():
            for n, a in sd.get('params', {}).items():
                if n in params:
                    params[n].copy_(torch.as_tensor(np.asarray(a)))
            for n, st in sd.get('states', {}).items():
                mine = self._states.get(n)
                if mine is None:
                    continue
                for k, v in st.items():
                    if k in mine:
                        mine[k].copy_(torch.as_tensor(np.asarray(v)))
        self._step_count = sd.get('step', 0)
        if self._lr_feed.fn is not None:
            self._lr_feed.reset_counter()

    def named_opt_states(self):
        """{name: {state key: CPU tensor}}."""
        return {n: {k: v.detach().cpu().clone() for k, v in st.items()}
                for n, st in self._states.items()}

    def _ensure_open(self):
        if self._closed:
            raise RuntimeError(
                'HybridParallelTrainStep was shut down; build a new engine '
                'to keep training')

    def shutdown(self):
        """Drain the window, disarm the heartbeat and drop the optimizer
        state inside an `engine.shutdown` census phase; returns the
        memory sample after the release. The engine refuses work
        afterwards. Idempotent."""
        if self._closed:
            return _mem.sample(count_buffers=True)
        self.flush()

        def release():
            self._states = {}
            self._closed = True
        return self._teardown(release)

    close = shutdown
