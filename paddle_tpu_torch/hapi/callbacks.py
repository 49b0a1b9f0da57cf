"""hapi callbacks — counterpart of `paddle_tpu/hapi/callbacks.py`:
`ProgBarLogger`, `ModelCheckpoint`, `LRSchedulerCallback`,
`EarlyStopping`, `ReduceLROnPlateau`, `VisualDL` (a no-op, as the
reference's) and `StepTelemetry` (the port's `profiler.StepTelemetry`
around the train loop), firing at the reference's epochs and steps."""
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        pass

    def on_batch_end(self, mode, step, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)
        return call


class ProgBarLogger(Callback):
    """Parity: hapi/callbacks.py:297."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.t0 = time.time()
        if self.verbose:
            total = self.params.get('epochs')
            print(f"Epoch {epoch + 1}/{total}")

    def on_batch_end(self, mode, step, logs=None):
        if self.verbose and mode == 'train' and \
                (step + 1) % self.log_freq == 0:
            msg = ' - '.join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                             if isinstance(v, (int, float)) and k != 'step')
            steps = self.params.get('steps')
            print(f"step {step + 1}/{steps} - {msg}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self.t0
            msg = ' - '.join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                             if isinstance(v, (int, float)) and k != 'step')
            print(f"epoch {epoch + 1} done ({dur:.1f}s) - {msg}")


class ModelCheckpoint(Callback):
    """Parity: hapi/callbacks.py:533."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class LRSchedulerCallback(Callback):
    """Parity: hapi/callbacks.py LRScheduler:598."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, '_optimizer', None)
        if opt is None:
            return None
        from ..optimizer.lr import LRScheduler
        lr = opt._learning_rate
        return lr if isinstance(lr, LRScheduler) else None

    def on_batch_end(self, mode, step, logs=None):
        if mode == 'train' and self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    """Parity: hapi/callbacks.py:688."""

    def __init__(self, monitor='loss', mode='auto', patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == 'max' or (mode == 'auto' and 'acc' in monitor):
            self.compare = lambda a, b: a > b + self.min_delta
        else:
            self.compare = lambda a, b: a < b - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor) or logs.get('eval_' + self.monitor)
        if current is None:
            return
        if self.best is None or self.compare(current, self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class ReduceLROnPlateau(Callback):
    """Parity: hapi/callbacks.py:956 — reduce the optimizer's learning
    rate by `factor` once `monitor` stops improving for `patience`
    epochs, with a cooldown and a floor."""

    def __init__(self, monitor='loss', factor=0.1, patience=10, verbose=1,
                 mode='auto', min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.wait = 0
        self.best = None
        if mode == 'max' or (mode == 'auto' and 'acc' in monitor):
            self.compare = lambda a, b: a > b + self.min_delta
        else:
            self.compare = lambda a, b: a < b - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor)
        if current is None:
            current = logs.get('eval_' + self.monitor)
        if current is None:
            return
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.best is None or self.compare(current, self.best):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, '_optimizer', None)
                if opt is not None:
                    old = float(opt.get_lr())
                    new = max(old * self.factor, self.min_lr)
                    if old - new > 1e-12:
                        opt.set_lr(new)
                        if self.verbose:
                            print(f"Epoch {epoch}: ReduceLROnPlateau "
                                  f"reducing learning rate to {new}.")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Accepted for API parity; logs to stdout in this environment."""

    def __init__(self, log_dir=None):
        super().__init__()
        self.log_dir = log_dir

    def on_epoch_end(self, epoch, logs=None):
        pass


class StepTelemetry(Callback):
    """`profiler.StepTelemetry` around the train loop: each batch's host
    wall (its loss read included) and examples/s (the batch size from
    the first input's leading dim), published into core.monitor;
    `snapshot()` (also stamped into the epoch logs under 'telemetry')
    carries device memory and the numerics beside the throughput."""

    def __init__(self, window=20, tokens_per_example=None, log_freq=0):
        super().__init__()
        from ..profiler import StepTelemetry as _Reporter
        self.reporter = _Reporter(window=window)
        self.tokens_per_example = tokens_per_example
        self.log_freq = log_freq
        self._batch_examples = None

    def on_batch_begin(self, mode, step, logs=None):
        if mode == 'train':
            self.reporter.begin_step()

    def on_batch_end(self, mode, step, logs=None):
        if mode != 'train':
            return
        ex = self._batch_examples
        if ex is None:
            ex = (logs or {}).get('batch_size')
        tokens = None
        if ex is not None and self.tokens_per_example:
            tokens = int(ex) * int(self.tokens_per_example)
        self.reporter.end_step(examples=ex, tokens=tokens)
        if self.log_freq and (step + 1) % self.log_freq == 0:
            s = self.reporter.snapshot()
            line = (f"[telemetry] step {step + 1}: "
                    f"{s['examples_per_sec']:.1f} ex/s, "
                    f"{s['avg_step_ms']:.1f} ms/step, "
                    f"compile {s['compile_seconds_total']:.2f}s")
            numerics = s.get('numerics') or {}
            if numerics.get('grad_norm_global') is not None:
                line += f", |g|={numerics['grad_norm_global']:.3g}"
            if numerics.get('nonfinite_steps'):
                line += (f", nonfinite_steps="
                         f"{int(numerics['nonfinite_steps'])}")
            print(line)

    def observe_batch(self, batch):
        """Called by Model.fit with the raw batch to size examples/sec."""
        try:
            first = batch[0] if isinstance(batch, (list, tuple)) else batch
            self._batch_examples = int(first.shape[0])
        except Exception:
            self._batch_examples = None

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs['telemetry'] = self.snapshot()

    def snapshot(self):
        return self.reporter.snapshot()
