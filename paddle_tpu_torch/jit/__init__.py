"""Train step — counterpart of `paddle_tpu.jit.TrainStep`
(paddle_tpu/jit/__init__.py:141-185, 233-239).

PyTorch runs eagerly, so a step is the forward, the backward and the
optimizer update in turn; nothing is compiled. Two routes, chosen as
the reference chooses them (`use_buckets=None` is the default):

* **bucketed** (`use_buckets` not False, the optimizer elementwise, and
  parameters to train): `core/bucketing.py`. The parameters are packed
  into flat dtype-homogeneous buckets (`BucketLayout.build(...,
  bucket_bytes=32 MiB, pad_to=8)` in `named_parameters()` order); each
  parameter's `.data` becomes a view into its parameter bucket and its
  `.grad` a view into a gradient bucket of its dtype, which each step
  zeroes and the backward accumulates into. The update
  (`flat_functional_apply`) then runs the fused stats kernel over each
  bucket and the update kernel over all of them in one launch, in
  place. The bucket cap is `resolve_comm_config`'s (`PTPU_BUCKET_MB`,
  32 MiB by default); the strategy knob comes with the multi-GPU port.
* **per-parameter** (otherwise): `optimizer.functional_apply` over
  {name: tensor} dicts: a fusible rule updates each parameter in place
  on the fused update kernel, one launch for all of them; another rule's
  new values are copied into the parameters.

Either way the parameters are updated IN PLACE, where the JAX step
donates its buffers and returns new ones, and after a call each
parameter's `.grad` holds that step's gradient (clipped by norm in
place on the bucketed route under `ClipGradByNorm`).

A model's buffers stay the model's own: batch norm's running statistics
move in place during the forward, once a step, where the reference
threads them through its step (:216-240).

`remat_policy` (`distributed/fleet/utils/recompute.py`; the kwarg, then
`PTPU_REMAT_POLICY`, then 'none') wraps the whole `loss_fn(model,
*batch)` in its checkpoint, as the reference wraps `loss_of`
(:113-130, :226-231).

The lr is read from `optimizer.get_lr()` at each call and written into
a device scalar only when it changed (the host path of the reference's
`LrFeed`, optimizer/device_lr.py:39-80); the caller steps a scheduler.
With `device_lr` (the kwarg, then `PTPU_DEVICE_LR`) and a schedule that
is a function of the step, the lr is computed on the card from a step
counter kept there (`optimizer/device_lr.py`), with no host feed a step;
other schedules keep the host feed.
The step owns a `torch.Generator` on its device, seeded from `seed`,
and binds it around the forward: the dropout ops draw their keep masks
from it (`core/rng.py`).

Telemetry (:186-300): a `HostGapMonitor('jit')` brackets each call, a
`StepLedger('jit')` takes the batch shape (host metadata only), the
memory phase `jit.step` and the flight recorder's heartbeat bracket the
step, and `flush()` publishes both. With `FLAGS_tensor_stats` or
`FLAGS_check_nan_inf` (latched at construction) each call builds the
numerics taps (every pre-update gradient's stats and every updated
parameter's) and fetches them in one host sync at its end, publishing
the `ptpu_num_*` gauges and, under `FLAGS_check_nan_inf`, raising
`NumericsError` naming the first nonfinite tensor.
"""
import numpy as np
import torch

from ..core import async_step as A_
from ..core import bucketing as B
from ..core import ledger as _led
from ..core import numerics as _num
from ..core import rng
from ..device import resolve_device
from ..distributed.fleet.meta_parallel.meta_parallel_base import (
    EngineTeardown)
from ..distributed.fleet.utils import recompute as remat
from ..optimizer import device_lr as dlr


class TrainStep(EngineTeardown):
    """One train step: loss_fn(model, *batch) -> scalar loss; backward;
    optimizer update. Runs on the card unless the caller passes
    device='cpu'; raises when the card is asked for and absent. Moves
    the model to that device."""

    def __init__(self, model, loss_fn, optimizer, use_buckets=None,
                 remat_policy=None, device=None, seed=0, device_lr=None):
        self._remat_policy = remat.resolve_policy(remat_policy,
                                                  default='none')
        self._loss_of = remat.apply_policy(self._loss, self._remat_policy,
                                           engine='jit')
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = {n: p for n, p in self.model.named_parameters()
                        if p.requires_grad}
        self._use_buckets = (use_buckets is not False
                             and B.elementwise(optimizer)
                             and bool(self._params))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        if self._use_buckets:
            self._build_buckets()
        else:
            self._layout = None
            self._opt_states = {}
            for n, p in self._params.items():
                st = optimizer.init_state(p.detach())
                if p.dtype != torch.float32 and optimizer._multi_precision:
                    # the fp32 master is seeded from the param, as the JAX
                    # step pre-seeds it so its state pytree stays stable
                    st['master'] = p.detach().float()
                self._opt_states[n] = st
        self._lr_feed = dlr.LrFeed(optimizer, device_lr, self.device)
        self._lr = None              # the lr tensor the last step used
        self.last_clip_factor = None
        self._taps_on = _num.taps_enabled()
        self.last_numerics = None
        self._gap = A_.HostGapMonitor('jit')
        self._ledger = _led.StepLedger(
            'jit', gap=self._gap,
            params_fn=lambda: _led.count_params(self._params),
            remat_policy=self._remat_policy)
        self._step_i = 0

    @property
    def use_buckets(self):
        return self._use_buckets

    @property
    def layout(self):
        """The BucketLayout on the bucketed route, else None."""
        return self._layout

    def _build_buckets(self):
        """Move every trained parameter into its bucket (its .data a view)
        and give it a .grad view into a gradient bucket of its dtype."""
        self._layout = B.BucketLayout.build(
            {n: (p.shape, p.dtype) for n, p in self._params.items()},
            bucket_bytes=B.resolve_comm_config()[1], pad_to=8)
        self._flat_params, self._flat_grads, self._opt_states = [], [], []
        with torch.no_grad():
            for b in self._layout.buckets:
                flat = torch.zeros(b.size, dtype=b.dtype, device=self.device)
                grad = torch.zeros(b.size, dtype=b.dtype, device=self.device)
                for s in b.slots:
                    p = self._params[s.name]
                    view = flat[s.offset:s.offset + s.size].view(s.shape)
                    view.copy_(p.detach())
                    p.data = view
                    p.grad = grad[s.offset:s.offset + s.size].view(s.shape)
                self._flat_params.append(flat)
                self._flat_grads.append(grad)
                self._opt_states.append(
                    B.init_bucket_state(self.optimizer, b, flat))

    def _to_device(self, b):
        if isinstance(b, np.ndarray):
            b = torch.from_numpy(b)
        return b.to(self.device) if isinstance(b, torch.Tensor) else b

    def __call__(self, *batch):
        """One step on `batch` (tensors or numpy arrays); returns the
        loss as an fp32 0-dim tensor on the step's device."""
        self._gap.dispatch_begin()
        batch = [self._to_device(b) for b in batch]
        shapes = [tuple(b.shape) for b in batch
                  if isinstance(b, torch.Tensor)]
        if shapes:
            self._ledger.observe_batch(shapes[0])
        with self._step_guard(self._step_i == 0, 'jit.train_step',
                              'jit.step'):
            loss, taps = self._step(batch)
        self._gap.dispatch_end()
        self._step_i += 1
        if taps is not None:
            meta = {kind: {n: (tuple(p.shape),
                               str(p.dtype).replace('torch.', ''))
                           for n, p in self._params.items()}
                    for kind in ('grads', 'params')}
            self.last_numerics = _num.process_jit_taps(
                taps, site='jit', step=self._step_i, meta=meta)
        return loss

    def flush(self):
        """Publish the gap monitor's and the ledger's gauges (a call
        has finished its step when it returns: nothing to drain)."""
        self._gap.drain_point()
        self._gap.publish()
        return self._ledger.publish()

    def host_gap_snapshot(self):
        return self._gap.snapshot()

    def _step(self, batch):
        if self._use_buckets:
            for g in self._flat_grads:
                g.zero_()
        else:
            for p in self._params.values():
                p.grad = None
        with rng.rng_guard(self.generator):
            loss = self._loss_of(*batch)
        loss.backward()
        lr = self._lr = self._lr_feed.lr()
        taps_grads = gn_sq = None
        if self._taps_on:
            # the gradients' stats and squared norm before the update (a
            # clip rewrites the bucketed route's gradients in place)
            taps_grads = {}
            for n, p in self._params.items():
                if p.grad is None:
                    continue
                taps_grads[n] = _num.stats_vec(p.grad)
                sq = (p.grad.float() ** 2).sum()
                gn_sq = sq if gn_sq is None else gn_sq + sq
        with torch.no_grad():
            if self._use_buckets:
                self._opt_states, self.last_clip_factor = \
                    B.flat_functional_apply(
                        self.optimizer, self._layout, self._flat_params,
                        self._flat_grads, self._opt_states, lr)
            else:
                grads = {n: p.grad for n, p in self._params.items()}
                new_params, self._opt_states = \
                    self.optimizer.functional_apply(
                        {n: p.detach() for n, p in self._params.items()},
                        grads, self._opt_states, lr)
                for n, p in self._params.items():
                    if new_params[n].data_ptr() != p.data_ptr():
                        p.copy_(new_params[n])
            self._lr_feed.advance()
        taps = None
        if taps_grads is not None:
            taps = {'grads': taps_grads,
                    'params': {n: _num.stats_vec(p)
                               for n, p in self._params.items()},
                    'grad_norm_sq': gn_sq if gn_sq is not None else
                    torch.zeros((), dtype=torch.float32)}
        return loss.detach(), taps

    def _loss(self, *batch):
        return self.loss_fn(self.model, *batch).float()

    def named_opt_states(self):
        """{param: {state key: CPU tensor}} in the per-parameter schema,
        on either route (bucketing.flat_states_to_named on the bucketed
        one)."""
        if self._use_buckets:
            return B.flat_states_to_named(self._layout, self._opt_states)
        return {n: {k: v.detach().cpu().clone() for k, v in st.items()}
                for n, st in self._opt_states.items()}

    def _ckpt_params(self):
        """The parameters a checkpoint's keys name: the optimizer's list
        when it holds every trained parameter, else the trained ones."""
        own = self.optimizer._parameter_list
        if own is not None and {id(p) for p in self._params.values()} <= \
                {id(p) for p in own}:
            return own
        return list(self._params.values())

    def state_dict(self):
        """The states this step holds as `Optimizer.state_dict()` writes
        them (`{param}.{state}`, `master.{param}`, `LR_Scheduler`,
        `@step` = the steps taken), on either route."""
        keys = self.optimizer.param_keys(self._ckpt_params())
        return self.optimizer.states_to_dict(
            {keys[id(self._params[n])]: st
             for n, st in self.named_opt_states().items()}, self._step_i)

    def set_state_dict(self, state_dict):
        """Restore a checkpoint dict (this step's, an eager optimizer's or
        the reference's) into the states this step holds."""
        params = self._ckpt_params()
        step, named = self.optimizer.dict_to_states(state_dict, params)
        keys = self.optimizer.param_keys(params)
        mine = {n: named[keys[id(p)]] for n, p in self._params.items()
                if keys[id(p)] in named}
        if self._use_buckets:
            self._opt_states = B.named_states_to_flat(
                self._layout, mine, self._opt_states)
        else:
            self._opt_states.update(mine)
        if step is not None:
            self._step_i = step
