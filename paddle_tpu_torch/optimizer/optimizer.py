"""Optimizers' functional update — counterpart of
`paddle_tpu/optimizer/optimizer.py`: the base class's `functional_apply`
(:103-158) and the SGD (:398), Adam (:546) and AdamW (:589) rules.

`functional_apply(params, grads, states, lr)` maps {name: tensor} dicts
to new ones, as the JAX package's pure update does: for a low-precision
param with `multi_precision` on, an fp32 master rides in the state and
the update runs on it; otherwise the update runs on an fp32 copy of the
param and the result is stored back in the param's dtype (:81-92, 146,
156), so bf16 params with `multi_precision=False` round every step.
Weight decay goes into the gradient when `_decay_into_grad()` (SGD and
Adam); AdamW decays the param instead, `param * (1 - lr * coeff)`,
before the Adam rule (:608-612). The update math is fp32 throughout:
`lr` is an fp32 0-dim tensor, and Adam's beta powers are fp32 0-dim
tensors in the state (:572-573), never Python floats.

This slice takes a constant float learning rate only. An LRScheduler,
`grad_clip` and AdamW's `apply_decay_param_fun` raise
NotImplementedError; none is ignored.
"""
import torch


def _not_ported(what):
    return NotImplementedError(
        f'{what} is not ported yet: the port\'s optimizers take a '
        f'constant float learning rate, no grad_clip and no per-param '
        f'decay selection')


def _as_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype or torch.float32
    return getattr(torch, str(dtype))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        """`parameters` and `name` are accepted for the JAX package's
        signature; the functional update takes its params per call."""
        if isinstance(learning_rate, bool) or \
                not isinstance(learning_rate, (int, float)):
            raise _not_ported('an LRScheduler')
        if grad_clip is not None:
            raise _not_ported('grad_clip')
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise _not_ported('a regularizer object as weight_decay')
        self._learning_rate = float(learning_rate)
        self._weight_decay = None if weight_decay is None \
            else float(weight_decay)
        self._multi_precision = multi_precision

    def get_lr(self):
        return self._learning_rate

    def _decay_into_grad(self):
        return True

    def init_state(self, param):
        """The per-param state dict for a param tensor (its shape and
        device; moments are created zero)."""
        return {}

    def update(self, param, grad, state, lr):
        """(fp32 param, fp32 grad, state, lr) -> (new param, new state)."""
        raise NotImplementedError

    def functional_apply(self, params, grads, states, lr):
        """One update of every param that has a gradient: returns
        ({name: new param in its dtype}, {name: new state})."""
        new_params, new_states = {}, {}
        for n, p in params.items():
            g = grads.get(n)
            if g is None:
                new_params[n] = p
                new_states[n] = states.get(n, {})
                continue
            st = dict(states.get(n) or {})
            low_precision = p.dtype != torch.float32
            if low_precision and self._multi_precision:
                p32 = st.pop('master', None)
                if p32 is None:
                    p32 = p.float()
            else:
                p32 = p.float() if low_precision else p
            g32 = g.float() if g.dtype != torch.float32 else g
            if self._weight_decay and self._decay_into_grad():
                g32 = g32 + self._weight_decay * p32
            if not st:
                st = self.init_state(p32)
            np_, ns = self.update(p32, g32, st, lr)
            if low_precision and self._multi_precision:
                ns = dict(ns)
                ns['master'] = np_
            new_params[n] = np_.to(p.dtype)
            new_states[n] = ns
        return new_params, new_states


class SGD(Optimizer):
    """Parity: operators/optimizers/sgd_op."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def update(self, param, grad, state, lr):
        return param - lr * grad, state


class Adam(Optimizer):
    """Parity: operators/optimizers/adam_op, with beta-power states.
    `moment_dtype` ('bfloat16' or a torch dtype) stores the moments in
    fewer bits; the update math stays fp32."""

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
        self._coeff = float(weight_decay)

    def _decay_into_grad(self):
        return False

    def update(self, param, grad, state, lr):
        decayed = param * (1.0 - lr * self._coeff)
        return super().update(decayed, grad, state, lr)
