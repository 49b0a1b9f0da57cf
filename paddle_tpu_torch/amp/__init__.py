"""Automatic mixed precision — counterpart of `paddle_tpu/amp/__init__.py`.

`auto_cast` (`amp_guard`): inside it, each op whose reference counterpart
goes through the reference's autocast hook (the ops built by `unary`,
`binary` and `defop`, paddle_tpu/ops/common.py:33-80: the Tensor
operators, `matmul_v2` and the other elementwise and unary math ops) casts
its floating inputs as the reference does (:60-85): to the amp dtype when
the op is white-listed (or, at O2, on neither list), to fp32 when it is
black-listed, and not at all otherwise (O1: the op follows its inputs).
The reference runs its other ops through `run_op` with no hook: `linear`,
`layer_norm`, the embedding lookup, GELU, dropout, the attention, the
reductions and `softmax_with_cross_entropy` never cast, whatever the lists
say. The port's layers call torch directly, so the reach is drawn with a
`torch.overrides.TorchFunctionMode`, active only inside `auto_cast`, that
maps torch functions to the reference's op names (`OP_NAMES`); the port's
functions that stand for one `run_op` of the reference are marked
`@uncast`, and the mode does not reach inside them. `torch.autocast`
would not match the reference: it casts `linear`, which the reference
does not.

`GradScaler`: the reference's dynamic loss scaling (:88-273) with all of
its API. `unscale_` unscales the eager optimizer's gradients in fp32,
rounds each back to its dtype and reads the found-inf verdict with one
host fetch; `step` skips the optimizer's update on a nonfinite gradient.
The engines' loss-scaling path takes the scaler through
`SpmdPipelineEngine.train_step(scaler=...)`, which calls
`update_from_found` when the step drains. Every step publishes
`ptpu_amp_steps_total`, `ptpu_amp_skipped_steps_total` and
`ptpu_amp_loss_scale` (:160-169), and a skipped step resets the eager
numerics guard (:171-186): its overflow was survived on purpose, so its
flag and journal must not be blamed on the next clean step.

`decorate`: casts the models' floating parameters to the amp dtype at
O2; at O1 it returns them as they are, as paddle's does (the reference
casts at either level).
"""
import contextlib
import functools
import threading

import torch
from torch.overrides import TorchFunctionMode

# Parity: dygraph/amp/auto_cast.py:27-52 (paddle_tpu/amp/__init__.py:24-30)
WHITE_LIST = {'conv2d', 'matmul', 'matmul_v2', 'mul', 'linear',
              'fused_attention'}
BLACK_LIST = {'exp', 'square', 'log', 'mean', 'sum', 'cos_sim', 'softmax',
              'softmax_with_cross_entropy',
              'sigmoid_cross_entropy_with_logits', 'cross_entropy',
              'cross_entropy2', 'reduce_sum', 'reduce_mean', 'layer_norm',
              'batch_norm'}

_T = torch.Tensor
# the reference's op name of each torch function that auto_cast reaches
# (paddle_tpu/ops/math.py:17-105; `-x` is `scale(x, -1.0)` there,
# core/tensor.py:262)
OP_NAMES = {}
for _name, _fns in {
        'elementwise_add': (torch.add, _T.add, _T.__add__, _T.__radd__),
        'elementwise_sub': (torch.sub, torch.subtract, _T.sub, _T.subtract,
                            _T.__sub__, _T.__rsub__),
        'elementwise_mul': (torch.mul, torch.multiply, _T.mul, _T.multiply,
                            _T.__mul__, _T.__rmul__),
        'elementwise_div': (torch.div, torch.divide, torch.true_divide,
                            _T.div, _T.divide, _T.true_divide,
                            _T.__truediv__, _T.__rtruediv__, _T.__rdiv__),
        'elementwise_floordiv': (torch.floor_divide, _T.floor_divide,
                                 _T.__floordiv__, _T.__rfloordiv__),
        'elementwise_mod': (torch.remainder, _T.remainder, _T.__mod__),
        'elementwise_pow': (torch.pow, _T.pow, _T.__pow__, _T.__rpow__),
        'elementwise_max': (torch.maximum, _T.maximum),
        'elementwise_min': (torch.minimum, _T.minimum),
        'elementwise_fmax': (torch.fmax, _T.fmax),
        'elementwise_fmin': (torch.fmin, _T.fmin),
        'atan2': (torch.atan2, _T.atan2), 'hypot': (torch.hypot, _T.hypot),
        'matmul_v2': (torch.matmul, _T.matmul, _T.__matmul__, torch.mm,
                      _T.mm),
        'bmm': (torch.bmm, _T.bmm),
        'scale': (torch.neg, _T.neg, _T.__neg__),
        'clip': (torch.clamp, torch.clip, _T.clamp, _T.clip),
        'abs': (torch.abs, _T.abs, _T.__abs__)}.items():
    for _fn in _fns:
        OP_NAMES[_fn] = _name
for _name in ('exp', 'expm1', 'log', 'log2', 'log10', 'log1p', 'sqrt',
              'rsqrt', 'square', 'sign', 'floor', 'ceil', 'round', 'trunc',
              'reciprocal', 'sin', 'cos', 'tan', 'asin', 'acos', 'atan',
              'sinh', 'cosh', 'tanh', 'asinh', 'acosh', 'atanh', 'sigmoid',
              'erf', 'lgamma', 'digamma'):
    for _fn in (getattr(torch, _name), getattr(_T, _name, None)):
        if _fn is not None:
            OP_NAMES[_fn] = _name
del _name, _fns, _fn, _T


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = 'O1'
        self.custom_white = frozenset()
        self.custom_black = frozenset()
        self.opaque = 0


_state = _AmpState()


def amp_state():
    """This thread's auto_cast settings."""
    return _state


def _amp_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    name = {'bfloat16': 'bfloat16', 'float16': 'float16',
            'bf16': 'bfloat16', 'fp16': 'float16'}.get(str(dtype))
    if name is None:
        raise ValueError(f'auto_cast dtype must be bfloat16 or float16, got '
                         f'{dtype!r}')
    return getattr(torch, name)


def _should_cast_to_low(op_name):
    """True (the amp dtype), False (fp32) or None (follow the inputs)
    for `op_name` under the current settings (:60-72)."""
    if not _state.enabled:
        return None
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    black = (BLACK_LIST | _state.custom_black) - _state.custom_white
    if op_name in white:
        return True
    if op_name in black:
        return False
    if _state.level == 'O2':
        return True
    return None


def _cast(x, target):
    if isinstance(x, torch.Tensor) and x.is_floating_point() and \
            x.dtype != target:
        return x.to(target)
    return x


class _AmpMode(TorchFunctionMode):
    """Casts the floating tensor inputs of the torch functions in
    OP_NAMES as the reference's hook casts its ops' inputs."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = OP_NAMES.get(func)
        if name is not None and not _state.opaque:
            decision = _should_cast_to_low(name)
            if decision is not None:
                target = _state.dtype if decision else torch.float32
                args = tuple(_cast(a, target) for a in args)
                kwargs = {k: (v if k == 'out' else _cast(v, target))
                          for k, v in kwargs.items()}
        return func(*args, **kwargs)


def run_hooked(op_name, fn, tensors, kwargs=None):
    """`fn(*tensors, **kwargs)` as the reference runs an op built by
    `unary`, `binary` or `defop` (its ops/common.py:33-38): inside
    auto_cast the floating inputs are cast as `op_name`'s lists say,
    and the torch calls inside `fn` are not reached again."""
    kwargs = kwargs or {}
    if not _state.enabled or _state.opaque:
        return fn(*tensors, **kwargs)
    decision = _should_cast_to_low(op_name)
    if decision is not None:
        target = _state.dtype if decision else torch.float32
        tensors = [_cast(t, target) for t in tensors]
    _state.opaque += 1
    try:
        return fn(*tensors, **kwargs)
    finally:
        _state.opaque -= 1


def uncast(fn):
    """Marks a port function that stands for one `run_op` of the
    reference, or for jnp code its hook never sees (the optimizers'
    updates, the engines' own arithmetic): auto_cast does not reach the
    torch calls inside it."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _state.enabled:
            return fn(*args, **kwargs)
        _state.opaque += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _state.opaque -= 1
    return wrapper


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level='O1', dtype='bfloat16'):
    """Parity: paddle.amp.auto_cast (:38-57). White-listed ops run in the
    amp dtype, black-listed ones in fp32, the others follow their inputs
    (O1) or run in the amp dtype (O2); only the ops in OP_NAMES are
    reached, as only the reference's hooked ops are."""
    if level not in ('O0', 'O1', 'O2'):
        raise ValueError(f"level must be 'O0', 'O1' or 'O2', got {level!r}")
    saved = (_state.enabled, _state.dtype, _state.level,
             _state.custom_white, _state.custom_black, _state.opaque)
    _state.enabled = bool(enable) and level != 'O0'
    _state.dtype = _amp_dtype(dtype)
    _state.level = level
    _state.custom_white = frozenset(custom_white_list or ())
    _state.custom_black = frozenset(custom_black_list or ())
    _state.opaque = 0
    mode = _AmpMode() if _state.enabled else contextlib.nullcontext()
    try:
        with mode:
            yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black, _state.opaque) = saved


amp_guard = auto_cast


class GradScaler:
    """Parity: paddle.amp.GradScaler (grad_scaler.py:20 / AmpScaler
    loss_scaler.py:28): dynamic loss scaling with incr/decr_every_n
    (paddle_tpu/amp/__init__.py:88-273)."""

    def __init__(self, enable=True, init_loss_scaling=2.**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, var):
        """var * the loss scale, in var's dtype (the reference's `scale`
        op)."""
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    @uncast
    def unscale_(self, optimizer):
        """Parity: check_finite_and_unscale (:121-150): each gradient of
        the optimizer's parameters times 1 / scale in fp32, rounded back
        to its dtype, the found-inf verdict from the fp32 products, one
        host fetch."""
        if not self._enable or self._unscaled:
            return
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        if not grads:
            self._found_inf = False
            self._unscaled = True
            return
        inv = 1.0 / self._scale
        flags = []
        for g in grads:
            g32 = g.float() * inv
            flags.append((~torch.isfinite(g32)).any())
            g.copy_(g32)
        self._found_inf = bool(torch.stack(flags).any())
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        try:
            self.unscale_(optimizer)
            if not self._found_inf:
                optimizer.step()
            else:
                # the update is skipped, so optimizer.step's numerics
                # boundary never flushes: drop the survived overflow's
                # flag and journal here
                from ..core import numerics as _numerics
                _numerics.guard().reset()
            self._update()
            self._publish_metrics(self._found_inf)
        finally:
            # always re-arm, or a failed step would leave the next one's
            # gradients scaled
            self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        return [], []

    def _publish_metrics(self, skipped):
        from ..core import monitor as _m
        _m.counter('ptpu_amp_steps_total',
                   help='GradScaler.step() calls').inc(1)
        if skipped:
            _m.counter('ptpu_amp_skipped_steps_total',
                       help='optimizer updates skipped on nonfinite '
                            'gradients').inc(1)
        _m.gauge('ptpu_amp_loss_scale',
                 help='current dynamic loss scale').set(self._scale)

    def update_from_found(self, found):
        """Deferred found-inf accounting for the engines' async path: one
        drained step's verdict drives the dynamic-scale schedule, in
        drain (= submission) order (:199-217). The step already skipped
        its update on the card; this is the host bookkeeping."""
        if not self._enable:
            return
        self._found_inf = bool(found)
        self._update()
        self._publish_metrics(self._found_inf)

    def update(self):
        pass  # folded into step(), as AmpScaler.minimize does

    def _update(self):
        """Parity: the update_loss_scaling op."""
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        """The loss-scale schedule a checkpoint carries, under paddle's
        incr_count / decr_count names (good_steps / bad_steps kept as
        aliases, :236-250)."""
        return {'scale': self._scale, 'incr_ratio': self._incr_ratio,
                'decr_ratio': self._decr_ratio,
                'incr_every_n_steps': self._incr_every_n,
                'decr_every_n_nan_or_inf': self._decr_every_n,
                'incr_count': self._good_steps,
                'decr_count': self._bad_steps,
                'good_steps': self._good_steps, 'bad_steps': self._bad_steps,
                'use_dynamic_loss_scaling': self._dynamic,
                'enable': self._enable}

    def set_state_dict(self, sd):
        self._scale = float(sd.get('scale', self._scale))
        self._incr_ratio = float(sd.get('incr_ratio', self._incr_ratio))
        self._decr_ratio = float(sd.get('decr_ratio', self._decr_ratio))
        self._incr_every_n = int(sd.get('incr_every_n_steps',
                                        self._incr_every_n))
        self._decr_every_n = int(sd.get('decr_every_n_nan_or_inf',
                                        self._decr_every_n))
        self._good_steps = int(sd.get('incr_count',
                                      sd.get('good_steps', 0)))
        self._bad_steps = int(sd.get('decr_count', sd.get('bad_steps', 0)))
        self._dynamic = bool(sd.get('use_dynamic_loss_scaling',
                                    self._dynamic))
        # 'enable' is saved for inspection only and deliberately not
        # restored: a checkpoint from a debug run must not switch loss
        # scaling off on an enabled scaler

    load_state_dict = set_state_dict


def decorate(models=None, optimizers=None, level='O2', dtype='bfloat16',
             master_weight=None, save_dtype=None):
    """Parity: paddle.amp.decorate (:276-293). At O2 the models' floating
    parameters are cast to the amp dtype in place; the optimizers keep
    their fp32 master weights (multi_precision). At O1 the models are
    returned unchanged."""
    if level not in ('O1', 'O2'):
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    target = _amp_dtype(dtype)
    if models is None:
        return None
    single_model = not isinstance(models, (list, tuple))
    ms = [models] if single_model else list(models)
    if level == 'O2':
        with torch.no_grad():
            for m in ms:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(target)
    out = ms[0] if single_model else ms
    return out if optimizers is None else (out, optimizers)
