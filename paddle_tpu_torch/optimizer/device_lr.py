"""On-device LR schedules — counterpart of
`paddle_tpu/optimizer/device_lr.py`.

For the schedules that are a pure function of the step index (constant,
Noam, cosine, polynomial, inverse-time, exponential, natural-exp, step,
multi-step, and linear warm-up into any of these) the lr is computed on
the card from an int32 step counter that lives there and that the train
step increments: no host work a step and no host-to-device feed.
`device_lr_fn(schedule)` returns that function, or None for a schedule
whose value depends on host state (ReduceOnPlateau, LambdaDecay, a user
subclass overriding `get_lr()`, ...): the checks are on the exact type,
so a subclass keeps the host feed rather than run its parent's rule.

Each function takes the fp32 ops of the reference's in the same order,
so it matches the host's float64 schedule to fp32 rounding, not bit for
bit (the reference's documented equivalence). The counter starts at the
scheduler's `last_epoch`; the host scheduler keeps reporting
`get_lr()`, and the two agree when the loop steps the scheduler once a
train step (the opt-in contract of `resolve_device_lr`).
"""
import math
import os

import torch

from ..amp import uncast
from .lr import (CosineAnnealingDecay, ExponentialDecay, InverseTimeDecay,
                 LinearWarmup, LRScheduler, MultiStepDecay, NaturalExpDecay,
                 NoamDecay, PolynomialDecay, StepDecay)


def resolve_device_lr(flag=None):
    """The on-device LR knob (core/async_step.py:73-86): the kwarg, then
    `PTPU_DEVICE_LR`, then False."""
    if flag is not None:
        return bool(flag)
    v = os.environ.get('PTPU_DEVICE_LR')
    if not v:
        return False
    return v.lower() in ('1', 'true', 'yes')


def lr_epoch(schedule):
    """The device counter's start: the scheduler's current epoch."""
    return max(int(getattr(schedule, 'last_epoch', 0)), 0)


class LrFeed:
    """The lr a train step reads, as a device fp32 0-dim tensor
    (device_lr.py:39-80): under the on-device schedule `fn(counter)`
    with the int32 counter on the device, which `advance()` increments
    after the step's update; otherwise `get_lr()` written into a device
    scalar only when it changed (a constant lr is fed once)."""

    def __init__(self, optimizer, flag, device):
        self._optimizer = optimizer
        self.device = torch.device(device)
        sched = optimizer._learning_rate
        self.fn = device_lr_fn(sched) if (
            isinstance(sched, LRScheduler) and resolve_device_lr(flag)) \
            else None
        self.counter = None
        self._host = None
        self._dev = torch.zeros((), dtype=torch.float32, device=self.device)

    @uncast
    def lr(self):
        if self.fn is not None:
            if self.counter is None:
                self.reset_counter()
            return self.fn(self.counter)
        v = float(self._optimizer.get_lr())
        if v != self._host:
            self._dev.fill_(v)
            self._host = v
        return self._dev

    def advance(self):
        """After a step's update: the device counter moves one step."""
        if self.fn is not None:
            self.counter.add_(1)

    def reset_counter(self):
        """(Re)sync the device counter to the host scheduler's epoch."""
        self.counter = torch.tensor(lr_epoch(self._optimizer._learning_rate),
                                    dtype=torch.int32, device=self.device)


def _f32(step):
    return step.to(torch.float32)


def device_lr_fn(schedule):
    """`fn(step int32 tensor) -> fp32 0-dim lr` for `schedule`, or None
    (device_lr.py:98-228)."""
    if isinstance(schedule, (int, float)):
        v = float(schedule)

        def const_fn(step):
            return torch.full((), v, dtype=torch.float32, device=step.device)
        return const_fn

    if not isinstance(schedule, LRScheduler):
        return None

    t = type(schedule)
    if t is NoamDecay:
        base = float(schedule.base_lr)
        d = float(schedule.d_model)
        warm = float(schedule.warmup_steps)

        def noam_fn(step):
            s = _f32(step)
            a = torch.where(s > 0, s, torch.ones_like(s)) ** -0.5
            b = warm ** -1.5 * s
            lr = base * (d ** -0.5) * torch.minimum(a, b)
            return torch.where(s == 0, torch.zeros_like(lr), lr)
        return noam_fn

    if t is CosineAnnealingDecay:
        base = float(schedule.base_lr)
        eta = float(schedule.eta_min)
        tmax = float(schedule.T_max)

        def cos_fn(step):
            s = _f32(step)
            return eta + (base - eta) * (1.0 + torch.cos(math.pi * s / tmax)) \
                / 2.0
        return cos_fn

    if t is PolynomialDecay:
        base = float(schedule.base_lr)
        end = float(schedule.end_lr)
        decay = float(schedule.decay_steps)
        power = float(schedule.power)
        cycle = bool(schedule.cycle)

        def poly_fn(step):
            s = _f32(step)
            if cycle:
                div = torch.where(s > 0, torch.ceil(s / decay),
                                  torch.ones_like(s))
                ds = decay * torch.clamp_min(div, 1.0)
            else:
                ds = torch.full((), decay, dtype=torch.float32,
                                device=step.device)
                s = torch.minimum(s, ds)
            return (base - end) * (1.0 - s / ds) ** power + end
        return poly_fn

    if t is InverseTimeDecay:
        base = float(schedule.base_lr)
        gamma = float(schedule.gamma)

        def inv_fn(step):
            return base / (1.0 + gamma * _f32(step))
        return inv_fn

    if t is ExponentialDecay:
        base = float(schedule.base_lr)
        gamma = float(schedule.gamma)

        def exp_fn(step):
            return base * gamma ** _f32(step)
        return exp_fn

    if t is NaturalExpDecay:
        base = float(schedule.base_lr)
        gamma = float(schedule.gamma)

        def nexp_fn(step):
            return base * torch.exp(-gamma * _f32(step))
        return nexp_fn

    if t is StepDecay:
        base = float(schedule.base_lr)
        gamma = float(schedule.gamma)
        size = int(schedule.step_size)

        def stepdecay_fn(step):
            return base * gamma ** _f32(torch.div(step, size,
                                                  rounding_mode='floor'))
        return stepdecay_fn

    if t is MultiStepDecay:
        base = float(schedule.base_lr)
        gamma = float(schedule.gamma)
        miles = [int(m) for m in schedule.milestones]

        def multistep_fn(step):
            n = torch.zeros((), dtype=torch.float32, device=step.device)
            for m in miles:
                n = n + _f32(step >= m)
            return base * gamma ** n
        return multistep_fn

    if t is LinearWarmup:
        inner = device_lr_fn(schedule.lr)
        if inner is None:
            return None
        warm = int(schedule.warmup_steps)
        start = float(schedule.start_lr)
        end = float(schedule.end_lr)

        def warmup_fn(step):
            s = _f32(step)
            ramp = (end - start) * s / max(warm, 1) + start
            after = inner(torch.clamp_min(step - warm, 0))
            return torch.where(step < warm, ramp, after)
        return warmup_fn

    return None
