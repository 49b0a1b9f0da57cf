"""Fused optimizer step over flat buckets — counterpart of
`paddle_tpu/ops/pallas/fused_optimizer.py`: `fusible` (:61),
`grad_stats_pallas` (:96, its `_stats_kernel` :81) and
`fused_shard_update` (:164, its `_update_kernel` :117).

`grad_stats(flat)` returns (sum of squares, nonfinite count) of a flat
gradient bucket as fp32 0-dim tensors on its device, in one pass. The
sum is not masked: a NaN or an inf gradient poisons it, as the
reference's `jnp.sum(g * g)` does, and the count reports it apart.

`fused_shard_update(optimizer, p, g, state, lr, prefactor=None,
found_inf=None)` has `core.bucketing.shard_update`'s contract
(bucketing.py:581-627): the prefactor multiply, decay into the gradient
when `_decay_into_grad()`, the optimizer's rule in fp32, the found-inf
no-op (a select, so NaN gradients leave every output bit-equal to its
input), and the parameter write in its dtype beside the fp32 master
write where the state has a master. It updates IN PLACE where the JAX
step donates: `p` and every vector state (master, moments, velocity,
accumulators) are overwritten and returned; the scalar states (Adam's
and Adamax's beta powers) come back as new fp32 0-dim tensors. `lr`,
`prefactor`, `found_inf` and the beta powers reach the kernel through
one small fp32 device block, never by value, so no step reads a device
value back to the host. The gradient may be the bucket's dtype or fp32.

The kernel (`csrc/fused_optimizer.cu`) implements every `_pallas_fusible`
rule of the reference: SGD, Momentum (with Nesterov), Adam and AdamW
(moments in fp32 or bf16), Adagrad, RMSProp (centered or not, with
momentum: up to three vector states), Adamax, Adadelta and
DecayedAdagrad (fp32 states); each is written out in CUDA, where Pallas
traced `update` into its body.

`ParamUpdates` runs the same kernel once a parameter, for the
per-parameter routes (the pipeline engine's update and
`Optimizer.functional_apply`): the step's scalar block is built once for
all of a step's parameters, each parameter's beta powers are read where
the last call left them, and the engine's loss-scaling path unscales
with the reference's rounding (the prefactored gradient rounded back to
its dtype) and skips with the found-inf select.

Plain versions: `grad_stats_plain` and `fused_shard_update_plain` (the
reference `shard_update`'s op chain, functional). CPU tensors run the
plain versions (the update's results copied back into its inputs, so
both routes keep one contract); CUDA tensors launch the kernels or
raise.
"""
import torch

from . import _build

STEP = 'optimizer_step'
STATS = 'grad_stats'
_build.register(STATS)
_build.register(STEP)

# csrc/fused_optimizer.cu: Rule
(_SGD, _MOMENTUM, _ADAM, _ADAGRAD, _RMSPROP, _ADAMAX, _ADADELTA,
 _DECAYED_ADAGRAD) = range(8)


def fusible(optimizer):
    """Optimizers whose flat update the fused kernel runs: strictly
    elementwise AND tagged `_pallas_fusible`."""
    return bool(getattr(optimizer, '_elementwise', False)) and \
        bool(getattr(optimizer, '_pallas_fusible', False))


# ---------------------------------------------------------------------------
# grad_stats
# ---------------------------------------------------------------------------
def grad_stats_plain(flat):
    """(sum of x^2, count of nonfinite x) of a flat array, fp32 0-dim."""
    x = flat.reshape(-1).float()
    return (x * x).sum(), (~torch.isfinite(x)).float().sum()


# csrc/fused_optimizer.cu's statistics kernel: CTAs of STATS_THREADS
# threads, each issuing STATS_UNROLL 16-byte loads a trip, up to
# STATS_CTAS_PER_SM CTAs an SM
STATS_THREADS = 256
STATS_UNROLL = 4
STATS_CTAS_PER_SM = 8
# one zeroed uint32 ticket a device, which the kernel's last CTA resets:
# calls on one device must be ordered on one stream (the caller's current
# stream), as every call of the training step is
_TICKETS = {}


def grad_stats_grid(n, dtype, sms):
    """CTAs of the statistics kernel for `n` elements of `dtype` on a card
    of `sms` SMs: up to STATS_CTAS_PER_SM an SM, and no more than give
    each thread one trip of STATS_UNROLL 16-byte vectors."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    trips = -(-n // (vec * STATS_THREADS * STATS_UNROLL))
    return max(1, min(STATS_CTAS_PER_SM * sms, trips))


def _ticket(device):
    t = _TICKETS.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f'{STATS}: call it once on {device} before '
                               'capturing a CUDA graph (its ticket is '
                               'allocated and zeroed at the first call)')
        t = _TICKETS[device.index] = torch.zeros(1, dtype=torch.int32,
                                                 device=device)
    return t


def _stats_kernel(flat):
    code = _build.dtype_code(flat, STATS)
    x = flat.reshape(-1)
    _build.require_contiguous(STATS, flat=x)
    if not x.numel():
        return (torch.zeros((), dtype=torch.float32, device=x.device),
                torch.zeros((), dtype=torch.float32, device=x.device))
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    ctas = grad_stats_grid(x.numel(), x.dtype, _build.sm_count(x.device))
    part = torch.empty(2 * ctas, dtype=torch.float32, device=x.device)
    _build.launch('ptt_grad_stats', STATS, x.device, x.data_ptr(),
                  part.data_ptr(), _ticket(x.device).data_ptr(),
                  out.data_ptr(), x.numel(), ctas, code)
    return out[0], out[1]


def grad_stats(flat):
    """(sum of squares, nonfinite count) as fp32 0-dim tensors: the
    kernel (one launch: per-CTA partials, summed by the last CTA) on a
    CUDA tensor, its plain version on a CPU tensor."""
    if _build.on_cpu(flat):
        return grad_stats_plain(flat)
    return _stats_kernel(flat)


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------
def _decay_into_grad(optimizer):
    wd = getattr(optimizer, '_weight_decay', None)
    return float(wd) if (wd and optimizer._decay_into_grad()) else 0.0


def fused_shard_update_plain(optimizer, p, g, st, lr, prefactor=None,
                             found_inf=None, round_prefactor=False,
                             wd=None):
    """The reference `shard_update`'s op chain (bucketing.py:581-627),
    functional: (new p in its dtype, new state). `round_prefactor` rounds
    the prefactored gradient back to its dtype, as the pipeline engine's
    unscale does (spmd_pipeline.py:923-926); `wd` replaces the
    optimizer's decay into the gradient (a parameter's own L2Decay)."""
    low = p.dtype != torch.float32
    st = dict(st)
    master = st.pop('master', None)
    p32 = master if master is not None else (p.float() if low else p)
    g32 = g.float()
    if prefactor is not None:
        g32 = g32 * prefactor
        if round_prefactor:
            g32 = g32.to(g.dtype).float()
    wd = _decay_into_grad(optimizer) if wd is None else wd
    if wd:
        g32 = g32 + wd * p32
    new32, ns = optimizer.update(p32, g32, st, lr)
    ns = dict(ns)
    if master is not None or (low and getattr(optimizer,
                                              '_multi_precision', True)):
        ns['master'] = new32
    new_p = new32.to(p.dtype)
    if found_inf is not None:
        old = dict(st)
        if master is not None:
            old['master'] = master
        new_p = torch.where(found_inf, p, new_p)
        ns = {k: (torch.where(found_inf, old[k], v) if k in old else v)
              for k, v in ns.items()}
        if 'master' in ns and master is None:
            ns['master'] = torch.where(found_inf, p32, ns['master'])
    return new_p, ns


def _rule(optimizer):
    """(rule code, the rule's constants) for the kernel. Each 1 - x is
    the Python double, rounded once to fp32 by ctypes, as jnp rounds a
    weakly typed scalar."""
    from ...optimizer import optimizer as O
    h = dict(wd=_decay_into_grad(optimizer), coeff=0.0, b1=0.0, b2=0.0,
             omb1=0.0, omb2=0.0, eps=0.0, momentum=0.0, rho=0.0, omr=0.0,
             nesterov=0, decoupled=0, centered=0)
    kind = type(optimizer)
    if kind in (O.Adagrad, O.DecayedAdagrad):
        h.update(eps=optimizer._epsilon)
        if kind is O.Adagrad:
            return _ADAGRAD, h
        h.update(rho=optimizer._decay, omr=1 - optimizer._decay)
        return _DECAYED_ADAGRAD, h
    if kind is O.RMSProp:
        h.update(rho=optimizer._rho, omr=1 - optimizer._rho,
                 eps=optimizer._epsilon, momentum=optimizer._momentum,
                 centered=int(bool(optimizer._centered)))
        return _RMSPROP, h
    if kind is O.Adamax:
        b1 = optimizer._beta1
        h.update(b1=b1, b2=optimizer._beta2, omb1=1 - b1,
                 eps=optimizer._epsilon)
        return _ADAMAX, h
    if kind is O.Adadelta:
        h.update(rho=optimizer._rho, omr=1 - optimizer._rho,
                 eps=optimizer._epsilon)
        return _ADADELTA, h
    if isinstance(optimizer, O.Adam):
        b1, b2 = optimizer._beta1, optimizer._beta2
        h.update(b1=b1, b2=b2, omb1=1 - b1, omb2=1 - b2,
                 eps=optimizer._epsilon)
        if isinstance(optimizer, O.AdamW):
            h.update(coeff=optimizer._coeff, decoupled=1)
        return _ADAM, h
    if isinstance(optimizer, O.Momentum):
        h.update(momentum=optimizer._momentum,
                 nesterov=int(bool(optimizer._use_nesterov)))
        return _MOMENTUM, h
    if kind is O.SGD:
        return _SGD, h
    raise NotImplementedError(
        f'fused_shard_update: no kernel rule for {kind.__name__}')


# the kernel's vector states s1, s2, s3 and its beta powers, by rule
# (RMSProp's mean_grad only when centered)
_VEC_KEYS = {_SGD: (), _MOMENTUM: ('velocity',),
             _ADAM: ('moment1', 'moment2'), _ADAGRAD: ('moment',),
             _RMSPROP: ('mean_square', 'momentum', 'mean_grad'),
             _ADAMAX: ('moment', 'inf_norm'),
             _ADADELTA: ('avg_squared_grad', 'avg_squared_update'),
             _DECAYED_ADAGRAD: ('moment',)}
_SCALAR_KEYS = {_ADAM: ('beta1_pow', 'beta2_pow'), _ADAMAX: ('beta1_pow',)}
# rules whose vector states may be bf16 (moment_dtype); the others' are fp32
_LOW_PRECISION_STATES = (_MOMENTUM, _ADAM)


def _step_block(lr, prefactor, found_inf, device):
    """The kernel's per-step fp32 block [lr, prefactor, found_inf]: one
    launch, shared by every call of a step."""
    one = torch.ones((), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    parts = [lr, one if prefactor is None else prefactor,
             zero if found_inf is None else found_inf]
    return torch.stack([torch.as_tensor(s).to(device=device,
                                              dtype=torch.float32).reshape(())
                        for s in parts])


def _powers(st, keys, device):
    """The beta powers as one contiguous fp32 block: the state's own
    tensors where they already are one (the views of the last call's
    output), else a stack of them."""
    ts = [st[k] for k in keys]
    first = ts[0]
    if all(t.dtype == torch.float32 and t.device == device
           and t.numel() == 1 for t in ts) and all(
            t.data_ptr() == first.data_ptr() + 4 * j
            for j, t in enumerate(ts)):
        return first
    return torch.stack([t.to(device=device, dtype=torch.float32).reshape(())
                        for t in ts])


def _launch(optimizer, rule, h, p, g, st, block, use_pref, use_fi):
    """One in-place call of the update kernel: returns (p, new state)."""
    st = dict(st)
    master = st.get('master')
    if master is None and p.dtype != torch.float32 and \
            getattr(optimizer, '_multi_precision', True):
        master = st['master'] = p.float()       # seeded from the param
    if rule == _RMSPROP and h['centered'] != ('mean_grad' in st):
        raise ValueError('fused_shard_update: a centered RMSProp state has '
                         'mean_grad, an uncentered one has not')
    keys = [k for k in _VEC_KEYS[rule] if k != 'mean_grad' or h['centered']]
    vecs = [st[k] for k in keys]
    n = p.numel()
    for name, t in [('g', g), ('master', master)] + list(zip(keys, vecs)):
        if t is not None and t.numel() != n:
            raise ValueError(f'fused_shard_update: {name} has {t.numel()} '
                             f'elements, p has {n}')
    if master is not None and master.dtype != torch.float32:
        raise TypeError('fused_shard_update: the master must be fp32')
    if len({t.dtype for t in vecs}) > 1:
        raise TypeError('fused_shard_update: the vector states must share a '
                        'dtype')
    if vecs and vecs[0].dtype != torch.float32 and \
            rule not in _LOW_PRECISION_STATES:
        raise TypeError(f'fused_shard_update: {type(optimizer).__name__}\'s '
                        f'states must be fp32')
    _build.require_contiguous(STEP, p=p, g=g, **({} if master is None
                                                  else {'master': master}),
                              **dict(zip(keys, vecs)))
    dev = p.device
    scalar_keys = _SCALAR_KEYS.get(rule, ())
    pw = _powers(st, scalar_keys, dev) if scalar_keys else None
    sc_out = torch.empty(max(len(scalar_keys), 1), dtype=torch.float32,
                         device=dev) if scalar_keys else None
    s1, s2, s3 = (vecs + [None] * 3)[:3]
    m_code = _build.dtype_code(s1, STEP) if s1 is not None else 0
    if n:
        _build.launch(
            'ptt_fused_update', STEP, dev, p.data_ptr(), g.data_ptr(),
            _build.ptr(master), _build.ptr(s1), _build.ptr(s2),
            _build.ptr(s3), block.data_ptr(), _build.ptr(pw),
            _build.ptr(sc_out), n, rule, _build.dtype_code(p, STEP),
            _build.dtype_code(g, STEP), m_code, h['wd'], h['coeff'],
            h['b1'], h['b2'], h['omb1'], h['omb2'], h['eps'],
            h['momentum'], h['rho'], h['omr'], h['nesterov'],
            h['decoupled'], h['centered'], int(use_pref),
            int(h.get('round', 0)), int(use_fi))
        for j, k in enumerate(scalar_keys):
            st[k] = sc_out[j]
    return p, st


def shard_update_chain(optimizer, p, g, st, lr, prefactor=None,
                       found_inf=None, round_prefactor=False, wd=None):
    """The op chain with its results copied into the inputs: the plain
    version of the kernel on CPU tensors, so both routes keep one
    contract; on any device, the update of an elementwise rule the
    kernel does not implement (Ftrl)."""
    new_p, ns = fused_shard_update_plain(optimizer, p, g, st, lr, prefactor,
                                         found_inf, round_prefactor, wd)
    p.copy_(new_p)
    out = {}
    for k, v in ns.items():
        old = st.get(k)
        if old is not None and old.dim() >= 1:
            old.copy_(v)
            v = old
        out[k] = v
    return p, out


def _require_fusible(optimizer):
    if not fusible(optimizer):
        raise NotImplementedError(
            f'fused_shard_update: {type(optimizer).__name__} is not an '
            f'elementwise, fusible optimizer')


def fused_shard_update(optimizer, p, g, st, lr, prefactor=None,
                       found_inf=None):
    """One bucket's update, in place: returns (p, new state), where p
    and the state's vector tensors are the ones passed in, overwritten.
    The kernel on CUDA tensors; on CPU tensors the plain version, its
    results copied into the inputs."""
    _require_fusible(optimizer)
    extra = [t for t in (lr, prefactor, found_inf) if t is not None]
    if _build.on_cpu(p, g, *st.values(), *extra):
        return shard_update_chain(optimizer, p, g, st, lr, prefactor,
                               found_inf)
    rule, h = _rule(optimizer)
    block = _step_block(lr, prefactor, found_inf, p.device)
    return _launch(optimizer, rule, h, p, g, st, block,
                   prefactor is not None, found_inf is not None)


class ParamUpdates:
    """One step's per-parameter updates on the update kernel (the
    reference's per-parameter `_update_one`, spmd_pipeline.py:2113-2127,
    and `Optimizer.functional_apply`, optimizer.py:103-158, which XLA
    fuses into one pass a parameter): one kernel launch a parameter, in
    place, with what is the same for every parameter of the step (the
    rule's constants, the [lr, prefactor, found_inf] block) built once.

    `prefactor` multiplies each gradient first and the product is
    rounded back to the gradient's dtype (the engine's unscale,
    spmd_pipeline.py:923-926; `fused_shard_update`'s bucketed prefactor
    is not rounded, as shard_update's is not); `found_inf` (a 0-dim
    device tensor) turns every call into a no-op
    that leaves each output bit-equal to its input. Calling the object
    on (p, g, state) updates p and the state's vector tensors in place
    and returns (p, new state), as `fused_shard_update` does; `wd`
    replaces the optimizer's decay into the gradient for that parameter
    (a parameter's own L2Decay). CPU tensors take the plain version."""

    def __init__(self, optimizer, lr, prefactor=None, found_inf=None):
        _require_fusible(optimizer)
        self.optimizer = optimizer
        self.lr, self.prefactor, self.found_inf = lr, prefactor, found_inf
        self._rule, self._h = _rule(optimizer)
        self._h['round'] = 1
        self._block = None

    def __call__(self, p, g, st, wd=None):
        extra = [t for t in (self.lr, self.prefactor, self.found_inf)
                 if isinstance(t, torch.Tensor)]
        if _build.on_cpu(p, g, *st.values(), *extra):
            return shard_update_chain(self.optimizer, p, g, st, self.lr,
                                      self.prefactor, self.found_inf,
                                      round_prefactor=True, wd=wd)
        if self._block is None:
            self._block = _step_block(self.lr, self.prefactor,
                                      self.found_inf, p.device)
        h = self._h if wd is None else dict(self._h, wd=float(wd))
        return _launch(self.optimizer, self._rule, h, p, g, st, self._block,
                       self.prefactor is not None,
                       self.found_inf is not None)
