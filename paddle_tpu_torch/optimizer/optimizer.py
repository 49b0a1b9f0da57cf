"""Optimizers' functional update — counterpart of
`paddle_tpu/optimizer/optimizer.py`: the base class's `functional_apply`
(:103-158) and eager `step()` (:161-230), and the SGD (:398), Momentum
(:415), Adagrad (:489), RMSProp (:511), Adam (:546), AdamW (:589),
Adamax (:626), Adadelta (:699) and DecayedAdagrad (:730) rules.

`functional_apply(params, grads, states, lr)` maps {name: tensor} dicts
to new ones, as the JAX package's pure update does: for a low-precision
param with `multi_precision` on, an fp32 master rides in the state and
the update runs on it; otherwise the update runs on an fp32 copy of the
param and the result is stored back in the param's dtype (:81-92, 146,
156), so bf16 params with `multi_precision=False` round every step.
Weight decay goes into the gradient when `_decay_into_grad()` (SGD,
Momentum and Adam); AdamW decays the param instead, `param * (1 - lr *
coeff)`, before the Adam rule (:608-612). The update math is fp32
throughout: `lr` is an fp32 0-dim tensor, and Adam's beta powers are
fp32 0-dim tensors in the state (:572-573), never Python floats.

`learning_rate` is a float or an `LRScheduler` (`optimizer/lr.py`),
read through `get_lr()` (:56-67). `grad_clip` (`nn/clip.py`) is applied
first, as :108-129 applies it: under `ClipGradByGlobalNorm` the factor
is cast to each gradient's dtype before the multiply, so a bf16
gradient is scaled in bf16.

The `_elementwise` tag (:31) says the rule is strictly per element, so
`jit.TrainStep` may run it over flat buckets (`core/bucketing.py`); the
`_pallas_fusible` tag (:37) says the fused update kernel
(`ops/kernels/fused_optimizer.py`) implements it. Every rule here carries
both. Each rule is written op for op in the reference's order (a Python
float constant multiplies as an fp32 scalar, as a weakly typed one does
in jnp), so the kernel, which rounds the same ops in the same order, is
bit-equal to it. The states of Adagrad, RMSProp, Adamax, Adadelta and
DecayedAdagrad are fp32, as the reference's are; like the reference's,
these five take no `multi_precision` argument (one passed lands in
`**kwargs`), so their bf16 params always carry an fp32 master.

The update route is chosen by rule: a fusible rule runs the parameters
through the fused update kernel (`ops/kernels/fused_optimizer.py`,
`ParamUpdates.apply`: one launch for all of them, in place, bit-equal
to the op chain), where the reference's jitted step fuses each parameter's chain
into one XLA pass; the others (Lamb, Lars, Ftrl, DGCMomentumOptimizer,
`_pallas_fusible = False` in the reference too) run their op chain. On
the fused route `functional_apply` updates the params and the vector
states it is given IN PLACE (where the JAX step donates) and returns
those tensors.

`weight_decay` is a float or an `L2Decay` (its coefficient). A
parameter's own `regularizer` attribute (`paddle_tpu_torch.regularizer`,
a `ParamAttr`'s) replaces the optimizer's decay in the eager `step()`
(:219-227), which also multiplies the learning rate by the parameter's
`optimize_attr['learning_rate']` (:218-219) and leaves a parameter whose
`need_clip` is False out of the clip; the functional routes
(`functional_apply`, `TrainStep`, the engines) ignore all three, as the
reference's do.

`step()` is the eager update of the `parameters` the optimizer was built
with: each parameter with a `.grad` takes the update in place, its state
(and fp32 master) kept in the optimizer. The updates are jnp code in the
reference, which `amp.auto_cast` does not reach, so both entries are
`@uncast`.

Refused with NotImplementedError, rather than copied silently: AdamW's
`apply_decay_param_fun` and `lr_ratio` (the reference's functional
routes decay every parameter whatever they say: `_cur_decay` is a class
attribute that is True, :609, :614), Lamb's
`exclude_from_weight_decay_fn` (honoured only by the reference's eager
`step()`, :696-700), Lars's `exclude_from_weight_decay` (ignored by the
reference everywhere) and `L1Decay` as an optimizer's `weight_decay`
(taken by the reference as an L2 coefficient, :45-49).
"""
import math
import re

import numpy as np
import torch

from ..amp import uncast
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                       ClipGradByValue, _publish_preclip_norm,
                       global_factor, norm_factor)
from ..ops.kernels import fused_optimizer as FO
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

_COUNTER = re.compile(r'param_\d+')     # an unnamed parameter's key


def _not_ported(what, cls='AdamW'):
    return NotImplementedError(
        f'{cls}({what}=...) is not ported: the reference\'s functional '
        f'routes (TrainStep, the engines) ignore it and decay every '
        f'parameter, and the port does not ignore an argument silently')


def weight_decay_coeff(weight_decay):
    """An optimizer's `weight_decay` as its float coefficient (None for
    none): a float, or an `L2Decay`'s coefficient. `L1Decay` raises."""
    if weight_decay is None:
        return None
    if isinstance(weight_decay, L2Decay):
        return weight_decay._coeff
    if isinstance(weight_decay, L1Decay):
        raise NotImplementedError(
            'L1Decay as an optimizer\'s weight_decay is not ported: the '
            'reference applies it as an L2 coefficient '
            '(optimizer.py:45-49); set it as the parameters\' own '
            '`regularizer` (eager step()) or pass an L2Decay or a float')
    if isinstance(weight_decay, bool) or \
            not isinstance(weight_decay, (int, float)):
        raise TypeError(f'weight_decay must be a float or an L2Decay, got '
                        f'{weight_decay!r}')
    return float(weight_decay)


def _as_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype or torch.float32
    return getattr(torch, str(dtype))


class Optimizer:
    _elementwise = False
    _pallas_fusible = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        """`parameters` are what `step()` updates (the functional update
        takes its params per call); `name` is accepted for the JAX
        package's signature."""
        if not isinstance(learning_rate, LRScheduler):
            if isinstance(learning_rate, bool) or \
                    not isinstance(learning_rate, (int, float)):
                raise TypeError(f'learning_rate must be a float or an '
                                f'LRScheduler, got {learning_rate!r}')
            learning_rate = float(learning_rate)
        if grad_clip is not None and not isinstance(
                grad_clip, (ClipGradByGlobalNorm, ClipGradByNorm,
                            ClipGradByValue)):
            raise TypeError(f'grad_clip must be a ClipGradBy* of '
                            f'paddle_tpu_torch.nn.clip, got {grad_clip!r}')
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay_coeff(weight_decay)
        self._multi_precision = multi_precision
        self._parameter_list = None if parameters is None \
            else list(parameters)
        self._accumulators = {}           # id(param) -> state
        self._step_count = 0              # eager step() calls

    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _decay_into_grad(self):
        return True

    def init_state(self, param):
        """The per-param state dict for a param tensor (its shape and
        device; moments are created zero)."""
        return {}

    def update(self, param, grad, state, lr):
        """(fp32 param, fp32 grad, state, lr) -> (new param, new state)."""
        raise NotImplementedError

    @uncast
    def functional_apply(self, params, grads, states, lr):
        """One update of every param that has a gradient: returns
        ({name: new param in its dtype}, {name: new state}). On the fused
        route the params and vector states passed in are updated in
        place and returned."""
        return self._apply(params, self._clip(grads), states, lr)

    def _apply(self, params, grads, states, lr, regularizers=None, slot=0):
        """The update after the clip; `regularizers` ({name: regularizer},
        eager `step()` only) replace the optimizer's decay into the
        gradient for those params; `slot` keys the fused route's cached
        table (one a learning-rate multiplier of the eager step)."""
        fused = FO.ParamUpdates(self, lr, slot=slot) if FO.fusible(self) \
            else None
        new_params, new_states, entries = {}, {}, {}
        for n, p in params.items():
            g = grads.get(n)
            if g is None:
                new_params[n] = p
                new_states[n] = states.get(n, {})
                continue
            st = dict(states.get(n) or {})
            reg = (regularizers or {}).get(n)
            if fused is not None and (reg is None or type(reg) is L2Decay):
                if not any(k != 'master' for k in st):
                    st.update(self.init_state(p))
                # the slot keeps the params' order; one launch fills all
                new_params[n] = new_states[n] = None
                entries[n] = (p, g, st, None if reg is None else reg._coeff)
                continue
            low_precision = p.dtype != torch.float32
            if low_precision and self._multi_precision:
                p32 = st.pop('master', None)
                if p32 is None:
                    p32 = p.float()
            else:
                p32 = p.float() if low_precision else p
            g32 = g.float() if g.dtype != torch.float32 else g
            if reg is not None:
                g32 = g32 + reg(p32)
            elif self._weight_decay and self._decay_into_grad():
                g32 = g32 + self._weight_decay * p32
            if not st:
                st = self.init_state(p32)
            np_, ns = self.update(p32, g32, st, lr)
            if low_precision and self._multi_precision:
                ns = dict(ns)
                ns['master'] = np_
            new_params[n] = np_.to(p.dtype)
            new_states[n] = ns
        if entries:
            for n, (p, ns) in zip(entries, fused.apply(list(
                    entries.values()))):
                new_params[n], new_states[n] = p, ns
        return new_params, new_states

    @torch.no_grad()
    @uncast
    def step(self):
        """The eager update (:161-230) of every parameter of the list that
        requires a gradient and has one, in place: grad_clip over them
        all, each parameter's own `regularizer` or the optimizer's decay,
        the rule at `get_lr()`."""
        if self._parameter_list is None:
            raise ValueError('optimizer created without a parameter list')
        from .. import profiler as _prof
        from ..core import memory as _mem
        from ..core import monitor as _m
        from ..core import numerics as _num
        _m.counter('ptpu_optimizer_steps_total',
                   help='eager optimizer.step() calls',
                   labelnames=('optimizer',)).inc(
                       1, optimizer=type(self).__name__)
        with _prof.RecordEvent('optimizer::step', event_type='optimizer'), \
                _mem.oom_guard('optimizer.step'), \
                _mem.phase('optimizer.step'), _num.paused():
            live = {id(p): p for p in self._parameter_list
                    if p.requires_grad and p.grad is not None}
            self._numerics_boundary(live)
            if live:
                self._eager_update(live)
        self._step_count += 1

    def _numerics_boundary(self, live):
        """The numerics observatory's step boundary (:187-201): flush
        the eager NaN/Inf guard (its one deferred host sync, BEFORE the
        update, so a poisoned gradient is caught before it reaches the
        parameters) and, with FLAGS_tensor_stats, publish every
        gradient's stats and the global norm as ptpu_num_* gauges (one
        batched fetch)."""
        from ..core import numerics as _num
        from ..core.flags import flag
        if _num.guard().has_pending():
            _num.flush(site='optimizer.step', step=self._step_count)
        if flag('FLAGS_tensor_stats') and live:
            named = {getattr(p, 'param_name', None) or f'param_{i}': p.grad
                     for i, p in enumerate(live.values())}
            stats = _num.collect(named)
            gn = math.sqrt(sum(st.l2_norm ** 2 for st in stats.values()))
            _num.publish_stats(stats, kind='grad', global_norm=gn)

    def _eager_update(self, live):
        """The clip over the parameters whose `need_clip` is not False,
        then the update of each group of one learning-rate multiplier
        (`optimize_attr['learning_rate']`, a ParamAttr's) at the
        optimizer's rate times it (:218-219): on the fused route one
        launch a group, and one for a step without multipliers."""
        dev = next(iter(live.values())).device
        base = self.get_lr()
        given = {k: p.detach() for k, p in live.items()}
        regs = {k: p.regularizer for k, p in live.items()
                if getattr(p, 'regularizer', None) is not None}
        grads = self._clip({k: p.grad for k, p in live.items()},
                           publish=True,
                           skip={k for k, p in live.items()
                                 if not getattr(p, 'need_clip', True)})
        groups = {}
        for k, p in live.items():
            mult = getattr(p, 'optimize_attr', None) or {}
            groups.setdefault(float(mult.get('learning_rate', 1.0)),
                              []).append(k)
        for slot, (mult, keys) in enumerate(groups.items()):
            lr = torch.tensor(base * mult, dtype=torch.float32, device=dev)
            new_params, new_states = self._apply(
                {k: given[k] for k in keys}, {k: grads[k] for k in keys},
                {k: self._accumulators.get(k, {}) for k in keys}, lr, regs,
                slot)
            for k in keys:
                if new_params[k] is not given[k]:
                    live[k].copy_(new_params[k])
            self._accumulators.update(new_states)

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or ():
            p.grad = None

    # -- checkpoint (:366-395) ---------------------------------------------
    def param_keys(self, params=None):
        """{id(param): checkpoint key} of `params` (the optimizer's own
        list by default): a `ParamAttr` name, else `param_{i}` by position,
        where the reference names each parameter `param_{n}` from one
        process-wide counter."""
        params = self._parameter_list if params is None else params
        return {id(p): getattr(p, 'param_name', None) or f'param_{i}'
                for i, p in enumerate(params or ())}

    def state_dict(self):
        """The eager step's states under the reference's keys:
        `{param}.{state}` for each state, `master.{param}` for an fp32
        master, `LR_Scheduler` and `@step`. (`jit.TrainStep.state_dict`
        gives the same for the states a train step holds.)"""
        keys = self.param_keys()
        return self.states_to_dict(
            {keys[k]: st for k, st in self._accumulators.items()
             if k in keys}, self._step_count)

    def states_to_dict(self, named_states, step):
        """{key: {state: tensor}} and a step count as a checkpoint dict
        in the reference's key order (states, then masters)."""
        sd, masters = {}, {}
        for key, st in named_states.items():
            for name, t in st.items():
                if name == 'master':
                    masters[f'master.{key}'] = t.detach()
                else:
                    sd[f'{key}.{name}'] = t.detach()
        sd.update(masters)
        if isinstance(self._learning_rate, LRScheduler):
            sd['LR_Scheduler'] = self._learning_rate.state_dict()
        sd['@step'] = int(step)
        return sd

    def set_state_dict(self, state_dict):
        """Restore `state_dict()`'s (or a reference checkpoint's) states
        into the eager step."""
        step, named = self.dict_to_states(state_dict, self._parameter_list)
        keys = self.param_keys()
        self._accumulators = {id(p): named[keys[id(p)]]
                              for p in self._parameter_list or ()
                              if keys[id(p)] in named}
        if step is not None:
            self._step_count = step

    set_dict = set_state_dict

    def dict_to_states(self, state_dict, params):
        """(step or None, {key: {state: tensor}}) from a checkpoint dict,
        each state cast to the dtype and device its parameter's fresh
        state has, and the scheduler's state restored. The file's
        parameter names match `params` by key; or else by position, but
        only where the file holds as many parameters as `params` and at
        each position the two names agree or both are counter names
        (`param_{n}`): a reference file names its parameters from a
        process-wide counter, which a fresh model does not repeat. Any
        other file (a frozen parameter's states missing, a `ParamAttr`
        name out of place) raises, as does a shape that does not fit."""
        step, raw, order = None, {}, []
        for k, v in state_dict.items():
            if k == 'LR_Scheduler':
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(v)
                continue
            if k == '@step':
                step = int(v.item() if isinstance(v, torch.Tensor) else v)
                continue
            if k.startswith('master.'):
                key, name = k[len('master.'):], 'master'
            else:
                key, name = k.rsplit('.', 1)
            if key not in raw:
                raw[key] = {}
                order.append(key)
            raw[key][name] = v
        params = list(params or ())
        keys = self.param_keys(params)
        by_key = {keys[id(p)]: p for p in params}
        if not set(order) <= set(by_key):
            mine = [keys[id(p)] for p in params]
            if len(order) != len(params) or not all(
                    a == b or (_COUNTER.fullmatch(a) and _COUNTER.fullmatch(b))
                    for a, b in zip(order, mine)):
                raise ValueError(
                    f'set_state_dict: the file holds states of parameters '
                    f'{order}, which match neither the names of the '
                    f'{len(params)} parameters here ({mine}) nor, one for '
                    f'one, their positions')
            renamed = dict(zip(order, mine))
            raw = {renamed[k]: st for k, st in raw.items()}
        out = {}
        for key, st in raw.items():
            p = by_key[key]
            fresh = self.init_state(p.detach())
            fresh['master'] = torch.empty(p.shape, dtype=torch.float32)
            conv = {}
            for name, v in st.items():
                v = torch.as_tensor(np.asarray(v) if not isinstance(
                    v, torch.Tensor) else v)
                tmpl = fresh.get(name)
                if tmpl is None:
                    raise KeyError(f'set_state_dict: {type(self).__name__} '
                                   f'keeps no state {name!r}')
                if v.numel() != tmpl.numel():
                    raise ValueError(
                        f'set_state_dict: {key}.{name} has shape '
                        f'{tuple(v.shape)}, the parameter\'s state '
                        f'{tuple(tmpl.shape)}')
                conv[name] = v.reshape(tmpl.shape).to(
                    device=p.device, dtype=tmpl.dtype).clone()
            out[key] = conv
        return step, out

    def _clip(self, grads, publish=False, skip=()):
        """grad_clip on {name: grad}, as functional_apply (:108-129)
        applies it; the names in `skip` (the eager step's parameters with
        `need_clip` False) are left out of the norm and not clipped."""
        clip = self._grad_clip
        live = {n: g for n, g in grads.items()
                if g is not None and n not in skip}
        if isinstance(clip, ClipGradByGlobalNorm):
            sq = None
            for g in live.values():
                s = (g.float() ** 2).sum()
                sq = s if sq is None else sq + s
            if sq is None:
                return grads
            norm = torch.sqrt(sq)
            if publish:             # the eager step's, as the reference's
                _publish_preclip_norm(norm, 'global_norm_clip')
            factor = global_factor(norm, clip.clip_norm)
            live = {n: g * factor.to(g.dtype) for n, g in live.items()}
        elif isinstance(clip, ClipGradByNorm):
            live = {n: g * norm_factor(g, clip.clip_norm).to(g.dtype)
                    for n, g in live.items()}
        elif isinstance(clip, ClipGradByValue):
            live = {n: g.clamp(clip.min, clip.max) for n, g in live.items()}
        else:
            return grads
        return {n: live.get(n, grads[n]) for n in grads}


class SGD(Optimizer):
    """Parity: operators/optimizers/sgd_op."""

    _elementwise = True
    _pallas_fusible = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def update(self, param, grad, state, lr):
        return param - lr * grad, state


class Momentum(Optimizer):
    """Parity: operators/optimizers/momentum_op (use_nesterov
    supported); the velocity is fp32."""

    _elementwise = True
    _pallas_fusible = True

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def init_state(self, param):
        return {'velocity': torch.zeros(param.shape, dtype=torch.float32,
                                        device=param.device)}

    def update(self, param, grad, state, lr):
        v = self._momentum * state['velocity'] + grad
        if self._use_nesterov:
            new_p = param - lr * (grad + self._momentum * v)
        else:
            new_p = param - lr * v
        return new_p, {'velocity': v}


class Adam(Optimizer):
    """Parity: operators/optimizers/adam_op, with beta-power states.
    `moment_dtype` ('bfloat16' or a torch dtype) stores the moments in
    fewer bits; the update math stays fp32."""

    _elementwise = True
    _pallas_fusible = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None, moment_dtype=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._moment_dtype = _as_dtype(moment_dtype)

    def init_state(self, param):
        zeros = lambda: torch.zeros(param.shape, dtype=self._moment_dtype,
                                    device=param.device)
        one = lambda: torch.ones((), dtype=torch.float32,
                                 device=param.device)
        return {'moment1': zeros(), 'moment2': zeros(),
                'beta1_pow': one(), 'beta2_pow': one()}

    def update(self, param, grad, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        mdt = state['moment1'].dtype
        m1 = b1 * state['moment1'].float() + (1 - b1) * grad
        m2 = b2 * state['moment2'].float() + (1 - b2) * grad * grad
        b1p = state['beta1_pow'] * b1
        b2p = state['beta2_pow'] * b2
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        new_p = param - lr_t * m1 / (torch.sqrt(m2) + eps)
        return new_p, {'moment1': m1.to(mdt), 'moment2': m2.to(mdt),
                       'beta1_pow': b1p, 'beta2_pow': b2p}


class AdamW(Adam):
    """Parity: operators/optimizers/adamw_op — decoupled weight decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None,
                 moment_dtype=None, **kwargs):
        if apply_decay_param_fun is not None:
            raise _not_ported('apply_decay_param_fun')
        if lr_ratio is not None:
            raise _not_ported('lr_ratio')
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name,
                         moment_dtype=moment_dtype)
        self._coeff = weight_decay_coeff(weight_decay) or 0.0

    def _decay_into_grad(self):
        return False

    def update(self, param, grad, state, lr):
        decayed = param * (1.0 - lr * self._coeff)
        return super().update(decayed, grad, state, lr)


def _zeros(param):
    return torch.zeros(param.shape, dtype=torch.float32, device=param.device)


class Adagrad(Optimizer):
    """Parity: operators/optimizers/adagrad_op; the accumulator starts at
    `initial_accumulator_value`."""

    _elementwise = True
    _pallas_fusible = True

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, param):
        return {'moment': torch.full(param.shape, float(self._init_acc),
                                     dtype=torch.float32,
                                     device=param.device)}

    def update(self, param, grad, state, lr):
        m = state['moment'] + grad * grad
        new_p = param - lr * grad / (torch.sqrt(m) + self._epsilon)
        return new_p, {'moment': m}


class RMSProp(Optimizer):
    """Parity: operators/optimizers/rmsprop_op, centered or not, with
    momentum."""

    _elementwise = True
    _pallas_fusible = True

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def init_state(self, param):
        s = {'mean_square': _zeros(param), 'momentum': _zeros(param)}
        if self._centered:
            s['mean_grad'] = _zeros(param)
        return s

    def update(self, param, grad, state, lr):
        rho = self._rho
        ms = rho * state['mean_square'] + (1 - rho) * grad * grad
        new_state = {'mean_square': ms}
        if self._centered:
            mg = rho * state['mean_grad'] + (1 - rho) * grad
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
            new_state['mean_grad'] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * state['momentum'] + lr * grad / denom
        new_state['momentum'] = mom
        return param - mom, new_state


class Adamax(Optimizer):
    """Parity: operators/optimizers/adamax_op, with a beta1-power state
    (an fp32 0-dim tensor)."""

    _elementwise = True
    _pallas_fusible = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, param):
        return {'moment': _zeros(param), 'inf_norm': _zeros(param),
                'beta1_pow': torch.ones((), dtype=torch.float32,
                                        device=param.device)}

    def update(self, param, grad, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * state['moment'] + (1 - b1) * grad
        u = torch.maximum(b2 * state['inf_norm'], grad.abs())
        b1p = state['beta1_pow'] * b1
        new_p = param - lr / (1 - b1p) * m / (u + eps)
        return new_p, {'moment': m, 'inf_norm': u, 'beta1_pow': b1p}


class Adadelta(Optimizer):
    """Parity: operators/optimizers/adadelta_op — the accumulated
    gradient / accumulated update RMS ratio rule."""

    _elementwise = True
    _pallas_fusible = True

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def init_state(self, param):
        return {'avg_squared_grad': _zeros(param),
                'avg_squared_update': _zeros(param)}

    def update(self, param, grad, state, lr):
        rho, eps = self._rho, self._epsilon
        g2 = rho * state['avg_squared_grad'] + (1 - rho) * grad * grad
        upd = grad * torch.sqrt(state['avg_squared_update'] + eps) \
            / torch.sqrt(g2 + eps)
        u2 = rho * state['avg_squared_update'] + (1 - rho) * upd * upd
        return param - lr * upd, {'avg_squared_grad': g2,
                                  'avg_squared_update': u2}


class DecayedAdagrad(Optimizer):
    """Parity: operators/optimizers/decayed_adagrad_op."""

    _elementwise = True
    _pallas_fusible = True

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-06,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._decay = decay
        self._epsilon = epsilon

    def init_state(self, param):
        return {'moment': _zeros(param)}

    def update(self, param, grad, state, lr):
        m = self._decay * state['moment'] + (1 - self._decay) * grad * grad
        return param - lr * grad / (torch.sqrt(m) + self._epsilon), \
            {'moment': m}


class DGCMomentumOptimizer(Momentum):
    """Parity: fluid.optimizer.DGCMomentumOptimizer + dgc_op.cc (Deep
    Gradient Compression, optimizer.py:441-486): the momentum-corrected
    gradient accumulates in `v`; the entries at or above the sparsity
    quantile of |v| are applied and cleared from `u` and `v`, the rest
    wait. The sparsity steps through its list once every `rampup_step`
    steps from `rampup_begin_step`; before it every entry is applied.
    Per parameter (the quantile), so not elementwise."""

    _elementwise = False

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 parameters=None, use_nesterov=False, weight_decay=None,
                 grad_clip=None, name=None, **kwargs):
        super().__init__(learning_rate, momentum, parameters, use_nesterov,
                         weight_decay, grad_clip, name=name)
        self._rampup_begin_step = float(rampup_begin_step)
        self._rampup_step = max(1.0, float(rampup_step))
        if not isinstance(sparsity, (list, tuple)):
            sparsity = [sparsity]
        self._sparsity_schedule = tuple(float(x) for x in sparsity)

    def init_state(self, param):
        return {'u': _zeros(param), 'v': _zeros(param),
                'step': torch.zeros((), dtype=torch.float32,
                                    device=param.device)}

    def update(self, param, grad, state, lr):
        step = state['step']
        u = self._momentum * state['u'] + grad
        corrected = grad + self._momentum * u if self._use_nesterov else u
        v = state['v'] + corrected
        sched = torch.tensor(self._sparsity_schedule, dtype=torch.float32,
                             device=param.device)
        idx = ((step - self._rampup_begin_step) / self._rampup_step).to(
            torch.int32).clamp(0, len(self._sparsity_schedule) - 1)
        thr = _quantile_linear(v.abs().reshape(-1), sched[idx.long()])
        mask = (v.abs() >= thr).to(v.dtype)
        ramping = step >= self._rampup_begin_step
        mask = torch.where(ramping, mask, torch.ones_like(mask))
        new_p = param - lr * (v * mask)
        return new_p, {'u': u * (1 - mask), 'v': v * (1 - mask),
                       'step': step + 1}


def _quantile_linear(a, q):
    """jnp.quantile(a, q) for a 1-D fp32 `a` and a 0-dim fp32 `q`, method
    'linear', as jax computes it: q * (n - 1) in fp32, the sorted values
    at its floor and ceiling weighted by (1 - frac, frac); NaN if `a`
    holds one."""
    srt = torch.sort(a).values
    n = torch.tensor(float(a.numel()), dtype=torch.float32, device=a.device)
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    out = srt[low] * lw + srt[high] * hw
    return torch.where(torch.isnan(a).any(),
                       torch.full_like(out, float('nan')), out)


class Lamb(Optimizer):
    """Parity: operators/optimizers/lamb_op — Adam's moments with a
    layerwise trust ratio ||w|| / ||r + decay w|| (optimizer.py:651-700);
    per parameter (the norms), so not elementwise."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, **kwargs):
        if exclude_from_weight_decay_fn is not None:
            raise _not_ported('exclude_from_weight_decay_fn', 'Lamb')
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_decay = lamb_weight_decay

    def init_state(self, param):
        one = lambda: torch.ones((), dtype=torch.float32,
                                 device=param.device)
        return {'moment1': _zeros(param), 'moment2': _zeros(param),
                'beta1_pow': one(), 'beta2_pow': one()}

    def update(self, param, grad, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1 = b1 * state['moment1'] + (1 - b1) * grad
        m2 = b2 * state['moment2'] + (1 - b2) * grad * grad
        b1p = state['beta1_pow'] * b1
        b2p = state['beta2_pow'] * b2
        r = (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p)) + eps)
        upd = r + self._lamb_decay * param
        w_norm = torch.sqrt(torch.sum(param * param))
        u_norm = torch.sqrt(torch.sum(upd * upd))
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        new_p = param - lr * trust * upd
        return new_p, {'moment1': m1, 'moment2': m2, 'beta1_pow': b1p,
                       'beta2_pow': b2p}


class Ftrl(Optimizer):
    """Parity: operators/optimizers/ftrl_op — follow the regularized
    leader (optimizer.py:754-782). Elementwise, so `jit.TrainStep` runs
    it over flat buckets, but it has no update-kernel rule (not
    `_pallas_fusible` in the reference either): its op chain runs."""

    _elementwise = True

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def init_state(self, param):
        return {'squared': _zeros(param), 'linear': _zeros(param)}

    def update(self, param, grad, state, lr):
        l1, l2, p = self._l1, self._l2, self._lr_power
        n, z = state['squared'], state['linear']
        n_new = n + grad * grad
        sigma = (torch.pow(n_new, -p) - torch.pow(n, -p)) / lr
        z_new = z + grad - sigma * param
        new_p = torch.where(
            torch.abs(z_new) <= l1, torch.zeros_like(param),
            (torch.sign(z_new) * l1 - z_new)
            / (torch.pow(n_new, -p) / lr + 2 * l2))
        return new_p, {'squared': n_new, 'linear': z_new}


class Lars(Momentum):
    """Parity: operators/optimizers/lars_momentum_op (optimizer.py:785-
    809): momentum on a layerwise local lr coeff * ||w|| / (||g|| +
    decay ||w|| + eps); per parameter, so not elementwise."""

    _elementwise = False

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None,
                 **kwargs):
        if exclude_from_weight_decay is not None:
            raise _not_ported('exclude_from_weight_decay', 'Lars')
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name=name)
        self._lars_coeff = lars_coeff
        self._lars_decay = lars_weight_decay
        self._lars_eps = epsilon

    def update(self, param, grad, state, lr):
        w_norm = torch.sqrt(torch.sum(param * param))
        g_norm = torch.sqrt(torch.sum(grad * grad))
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm
            / (g_norm + self._lars_decay * w_norm + self._lars_eps),
            torch.ones_like(w_norm))
        g = grad + self._lars_decay * param
        v = self._momentum * state['velocity'] + lr * local_lr * g
        return param - v, {'velocity': v}


LarsMomentum = Lars
