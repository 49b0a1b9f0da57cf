"""Train step — counterpart of `paddle_tpu.jit.TrainStep` on its
per-parameter route (`use_buckets=False`, paddle_tpu/jit/__init__.py:
141-143, 174-185, 237-239).

PyTorch runs eagerly, so a step is the forward, the backward and the
optimizer's `functional_apply` in turn; nothing is compiled. The
parameters are updated IN PLACE (`copy_` into each parameter), where the
JAX step donates its buffers and returns new ones; after a call each
parameter's `.grad` holds that step's gradient.
"""
import numpy as np
import torch

from ..device import resolve_device


def _later_slice(what):
    return NotImplementedError(
        f'TrainStep: {what} is not ported yet (the bucketed optimizer '
        f'with the fused-optimizer kernels, and remat, come in slice 3); '
        f'pass use_buckets=False and no remat policy')


class TrainStep:
    """One train step: loss_fn(model, *batch) -> scalar loss; backward;
    per-parameter optimizer update. Runs on the card unless the caller
    passes device='cpu'; raises when the card is asked for and absent.
    Moves the model to that device."""

    def __init__(self, model, loss_fn, optimizer, use_buckets=False,
                 remat_policy=None, device=None):
        if use_buckets is not False:
            raise _later_slice(f'use_buckets={use_buckets!r}')
        if remat_policy not in (None, 'none'):
            raise _later_slice(f'remat_policy={remat_policy!r}')
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = {n: p for n, p in self.model.named_parameters()
                        if p.requires_grad}
        self._opt_states = {}
        for n, p in self._params.items():
            st = optimizer.init_state(p.detach())
            if p.dtype != torch.float32 and optimizer._multi_precision:
                # the fp32 master is seeded from the param, as the JAX
                # step pre-seeds it so its state pytree stays stable
                st['master'] = p.detach().float()
            self._opt_states[n] = st
        self._lr = torch.tensor(optimizer.get_lr(), dtype=torch.float32,
                                device=self.device)

    def _to_device(self, b):
        if isinstance(b, np.ndarray):
            b = torch.from_numpy(b)
        return b.to(self.device) if isinstance(b, torch.Tensor) else b

    def __call__(self, *batch):
        """One step on `batch` (tensors or numpy arrays); returns the
        loss as an fp32 0-dim tensor on the step's device."""
        batch = [self._to_device(b) for b in batch]
        for p in self._params.values():
            p.grad = None
        loss = self.loss_fn(self.model, *batch).float()
        loss.backward()
        grads = {n: p.grad for n, p in self._params.items()}
        with torch.no_grad():
            new_params, self._opt_states = self.optimizer.functional_apply(
                {n: p.detach() for n, p in self._params.items()}, grads,
                self._opt_states, self._lr)
            for n, p in self._params.items():
                p.copy_(new_params[n])
        return loss.detach()
