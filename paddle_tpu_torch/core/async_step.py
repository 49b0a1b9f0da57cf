"""Asynchronous train steps — the subset of `paddle_tpu/core/async_step.py`
that the engines' `train_step` needs: `resolve_dispatch_window`
(:56-62), `AsyncResult` (:328-418), `AsyncDispatchMixin.flush` and
`DispatchWindow` (:421-483); an engine's `flush` drains its window.

A step's work is queued on the card's stream when `train_step` returns;
its `AsyncResult` holds the loss and the found-inf flag as device
tensors and a CUDA event recorded after the step's last launch. `wait()`
synchronises on that event (not a transfer) and then runs the step's
deferred drain work once (a GradScaler's found-inf accounting, applied
in drain order, :199-217 of paddle_tpu/amp); `result()` is the one host
fetch of the loss. On the CPU the step has finished when it returns,
and there is no event.
"""
import collections
import os

import torch

DEFAULT_DISPATCH_WINDOW = 2


def resolve_dispatch_window(window=None):
    """In-flight dispatch window: the kwarg, then `PTPU_DISPATCH_WINDOW`,
    then 2; clamped to at least 1."""
    if window is None:
        env = os.environ.get('PTPU_DISPATCH_WINDOW')
        try:
            window = int(env) if env else DEFAULT_DISPATCH_WINDOW
        except ValueError:
            window = DEFAULT_DISPATCH_WINDOW
    return max(int(window), 1)


class AsyncResult:
    """One dispatched train step: the fp32 loss on the device, no host
    fetch."""

    __slots__ = ('loss', 'step', 'found_inf', '_event', '_drained',
                 '_host_loss', '_staged', '_on_drain')

    def __init__(self, loss, step, staged=(), found_inf=None,
                 on_drain=None):
        """`staged`: host buffers the step's copies read, kept until the
        step drains; `found_inf`: the step's device flag (a nonfinite
        gradient skipped its update); `on_drain(result)`: run once when
        the step drains."""
        self.loss = loss
        self.step = step
        self.found_inf = found_inf
        self._on_drain = on_drain
        self._event = None
        if loss.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        self._drained = False
        self._host_loss = None
        self._staged = staged

    def done(self):
        """Whether the step was drained (waited on), as the reference's."""
        return self._drained

    def wait(self):
        """Block until the card finished this step."""
        if not self._drained:
            if self._event is not None:
                self._event.synchronize()
            self._drained = True
            self._staged = ()
            if self._on_drain is not None:
                drain, self._on_drain = self._on_drain, None
                drain(self)
        return self

    def result(self):
        """The loss as a host float: the one host fetch."""
        if self._host_loss is None:
            self.wait()
            self._host_loss = float(self.loss)
        return self._host_loss

    def __float__(self):
        return self.result()

    def __repr__(self):
        state = 'drained' if self._drained else 'in-flight'
        return f'AsyncResult(step={self.step}, {state})'


class DispatchWindow:
    """Bounded FIFO of in-flight AsyncResults: `push` waits on the oldest
    past `size`; drain order is submission order."""

    def __init__(self, size):
        self.size = max(int(size), 1)
        self._q = collections.deque()

    def __len__(self):
        return len(self._q)

    def push(self, result):
        self._q.append(result)
        while len(self._q) > self.size:
            self._q[0].wait()
            self._q.popleft()
        return result

    def flush(self):
        drained = []
        while self._q:
            self._q[0].wait()
            drained.append(self._q.popleft())
        return drained
