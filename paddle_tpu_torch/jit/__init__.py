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
  place. Only the default bucket cap is
  ported; the env and strategy knobs come with the multi-GPU port.
* **per-parameter** (otherwise): `optimizer.functional_apply` over
  {name: tensor} dicts: a fusible rule updates each parameter in place
  on the fused update kernel, one launch for all of them; another rule's
  new values are copied into the parameters.

Either way the parameters are updated IN PLACE, where the JAX step
donates its buffers and returns new ones, and after a call each
parameter's `.grad` holds that step's gradient (clipped by norm in
place on the bucketed route under `ClipGradByNorm`).

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
"""
import numpy as np
import torch

from ..core import bucketing as B
from ..core import rng
from ..device import resolve_device
from ..distributed.fleet.utils import recompute as remat
from ..optimizer import device_lr as dlr


class TrainStep:
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
            bucket_bytes=B.DEFAULT_BUCKET_BYTES, pad_to=8)
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
        batch = [self._to_device(b) for b in batch]
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
        return loss.detach()

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
