"""hapi.Model — counterpart of `paddle_tpu/hapi/model.py`.

`Model(network, inputs=None, labels=None, device=None)` moves the
network to the resolved device (the card unless the caller passes
device='cpu'; raises when the card is asked for and absent) and moves
each batch there; the loaders (`io.DataLoader`) yield CPU tensors.

Two routes, as the reference's `prepare(jit=...)` picks them:
* eager (`jit=False`): forward, `backward()`, `optimizer.step()` (row
  15, one launch a learning-rate group) and `clear_grad()`; with
  `accumulate_grad_batches = k` the gradients of k batches add up
  before a step, as the reference's do.
* jit: `jit.TrainStep` on the model's device (its default route:
  bucketed for an elementwise rule, one row-15 launch a step). The
  parameters are the step's bucket views, so the network always holds
  the trained values and nothing syncs them back. The reference's jit
  route drops the gradients of `accumulate_grad_batches > 1` (its
  non-update batches run the eager backward into gradients the jitted
  step never reads); the port refuses that pair.

Each train or eval step reads its losses back to the host (one sync a
step, `_update_logs`), and the learning-rate scheduler steps once an
epoch, as the reference's loop does.

`save` writes `.pdparams` (the network's state dict) and `.pdopt` with
the reference's keys (`Optimizer.state_dict`); after a jit fit, the
states the train step holds (`TrainStep.state_dict`), where the
reference's file keeps the eager optimizer's, empty after a jit fit.
`load` restores both; into a jit model before its first step, the
states wait for the step to be built.
"""
import os

import numpy as np
import torch

from .. import framework
from ..device import resolve_device
from ..io import DataLoader
from .callbacks import CallbackList, ProgBarLogger


class Model:
    """A network with its optimizer, loss and metrics, trained through
    `fit`, measured by `evaluate`, run by `predict`."""

    def __init__(self, network, inputs=None, labels=None, device=None):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._jit = False
        self._train_step = None
        self._pending_opt_state = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=False):
        if amp_configs is not None:
            raise NotImplementedError(
                'Model.prepare(amp_configs=...) is not ported: the '
                'reference accepts it and ignores it')
        self._optimizer = optimizer
        self._loss = loss
        self._jit = jit
        self._train_step = None
        if metrics is not None:
            self._metrics = list(metrics) if isinstance(
                metrics, (list, tuple)) else [metrics]

    # -- single steps ----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        if self._jit:
            if not update:
                raise NotImplementedError(
                    'Model: a batch without an update (accumulated '
                    'gradients) is not ported on the jit route: the '
                    'reference\'s jitted step never reads the gradients '
                    'it accumulates; use prepare(jit=False)')
            return self._train_batch_jit(inputs, labels)
        self.network.train()
        ins = [self._to_tensor(x) for x in self._to_list(inputs)]
        labs = [self._to_tensor(x) for x in self._to_list(labels)]
        outs = self._to_list(self.network(*ins))
        loss_list = self._to_list(self._loss(*(outs + labs)))
        total = loss_list[0]
        for extra in loss_list[1:]:
            total = total + extra
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = [m.update(m.compute(outs[0], *labs))
                   for m in self._metrics]
        out_loss = [[float(l.detach())] for l in loss_list]
        return (out_loss, metrics) if metrics else out_loss

    def _train_batch_jit(self, inputs, labels):
        from ..jit import TrainStep
        inputs = self._to_list(inputs)
        labels = self._to_list(labels)
        if self._train_step is None:
            n_in = len(inputs)
            loss_obj = self._loss

            def loss_fn(model, *batch):
                outs = self._to_list(model(*batch[:n_in]))
                losses = self._to_list(loss_obj(*(outs + list(
                    batch[n_in:]))))
                total = losses[0]
                for extra in losses[1:]:
                    total = total + extra
                return total
            self.network.train()
            self._train_step = TrainStep(self.network, loss_fn,
                                         self._optimizer, device=self.device)
            if self._pending_opt_state is not None:
                self._train_step.set_state_dict(self._pending_opt_state)
                self._pending_opt_state = None
        self.network.train()
        loss = self._train_step(*[self._to_tensor(x)
                                  for x in inputs + labels])
        return [[float(loss)]]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        ins = [self._to_tensor(x) for x in self._to_list(inputs)]
        labs = [self._to_tensor(x) for x in self._to_list(labels)]
        outs = self._to_list(self.network(*ins))
        out_loss = []
        if self._loss is not None and labs:
            out_loss = [[float(l)] for l in
                        self._to_list(self._loss(*(outs + labs)))]
        metrics = [m.update(m.compute(outs[0], *labs))
                   for m in self._metrics]
        return (out_loss, metrics) if metrics else out_loss

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        ins = [self._to_tensor(x) for x in self._to_list(inputs)]
        return [o.detach().cpu().numpy()
                for o in self._to_list(self.network(*ins))]

    # -- loops -------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from .. import profiler as _prof
        if self._jit and accumulate_grad_batches > 1:
            raise NotImplementedError(
                'Model.fit(accumulate_grad_batches > 1) on the jit route '
                'is not ported: the reference\'s jitted step drops the '
                'accumulated gradients; use prepare(jit=False)')
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = self._to_loader(eval_data, batch_size, False, False,
                                      num_workers) \
            if eval_data is not None else None
        cbks = CallbackList(callbacks or ([ProgBarLogger(log_freq, verbose)]
                                          if verbose else []))
        cbks.set_model(self)
        cbks.set_params({'epochs': epochs, 'verbose': verbose,
                         'metrics': self._metrics_name(),
                         'steps': self._safe_len(train_loader)})
        cbks.on_begin('train')
        telemetry_cbs = [c for c in cbks.callbacks
                         if hasattr(c, 'observe_batch')]
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                if num_iters is not None and step >= num_iters:
                    break
                for tc in telemetry_cbs:
                    tc.observe_batch(batch)
                cbks.on_batch_begin('train', step, logs)
                ins, labs = self._split_batch(batch)
                with _prof.RecordEvent('hapi::train_batch',
                                       event_type='train', step=step):
                    result = self.train_batch(
                        ins, labs,
                        update=(step + 1) % accumulate_grad_batches == 0)
                logs = self._update_logs(result, logs, step)
                cbks.on_batch_end('train', step, logs)
                if self.stop_training:
                    break
            sched = self._optimizer_lr_scheduler()
            if sched is not None:
                sched.step()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            if self.stop_training:
                break
        cbks.on_end('train')
        if save_dir:
            self.save(f"{save_dir}/final")

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        for m in self._metrics:
            m.reset()
        logs = {}
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            ins, labs = self._split_batch(batch)
            logs = self._update_logs(self.eval_batch(ins, labs), logs, step)
        out = {}
        if 'loss' in logs:
            out['loss'] = logs['loss']
        for m in self._metrics:
            for n, v in self._metric_items(m):
                out[n] = v
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, has_label=False)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        framework.save(self.network.state_dict(), path + '.pdparams')
        if training and self._optimizer is not None:
            state = self._train_step.state_dict() \
                if self._train_step is not None \
                else self._optimizer.state_dict()
            framework.save(state, path + '.pdopt')

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        sd = framework.load(path + '.pdparams')
        if skip_mismatch:
            own = self.network.state_dict()
            sd = {k: v for k, v in sd.items()
                  if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.network.load_state_dict(sd, strict=not skip_mismatch)
        if reset_optimizer or self._optimizer is None or \
                not os.path.exists(path + '.pdopt'):
            return
        opt_sd = framework.load(path + '.pdopt')
        if self._train_step is not None:
            self._train_step.set_state_dict(opt_sd)
        elif self._jit:
            self._pending_opt_state = opt_sd
        else:
            self._optimizer.set_state_dict(opt_sd)

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtype)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _safe_len(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    @staticmethod
    def _to_list(x):
        if x is None:
            return []
        if isinstance(x, (list, tuple)):
            return list(x)
        return [x]

    def _to_tensor(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self.device)

    def _to_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def _split_batch(self, batch, has_label=True):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if not has_label or self._loss is None:
            return batch, []
        n_in = len(self._inputs) if self._inputs else max(1, len(batch) - 1)
        return batch[:n_in], batch[n_in:]

    @staticmethod
    def _metric_items(m):
        res = m.accumulate()
        names = m.name() if isinstance(m.name(), list) else [m.name()]
        vals = res if isinstance(res, list) else [res]
        return zip(names, vals)

    def _metrics_name(self):
        names = ['loss']
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _update_logs(self, result, logs, step):
        losses = result[0] if isinstance(result, tuple) else result
        loss_v = losses[0][0]
        logs = dict(logs)
        prev = logs.get('loss', loss_v)
        logs['loss'] = (prev * step + loss_v) / (step + 1)
        logs['step'] = step
        for m in self._metrics:
            for n, v in self._metric_items(m):
                logs[n] = v
        return logs

    def _optimizer_lr_scheduler(self):
        if self._optimizer is None:
            return None
        from ..optimizer.lr import LRScheduler
        lr = self._optimizer._learning_rate
        return lr if isinstance(lr, LRScheduler) else None
