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
and Adamax's beta powers) come back as fp32 0-dim tensors (on the card,
views of the launch's powers block: see `ParamUpdates`). `lr`,
`prefactor` and `found_inf` reach the kernel through one small fp32
device block and the beta powers by pointer, never by value, so no step
reads a device value back to the host. The gradient may be the bucket's
dtype or fp32.

The kernel (`csrc/fused_optimizer.cu`) implements every `_pallas_fusible`
rule of the reference: SGD, Momentum (with Nesterov), Adam and AdamW
(moments in fp32 or bf16), Adagrad, RMSProp (centered or not, with
momentum: up to three vector states), Adamax, Adadelta and
DecayedAdagrad (fp32 states); each is written out in CUDA, where Pallas
traced `update` into its body.

`ParamUpdates` runs the kernel over a list of tensors in one launch
(`apply`), for the per-parameter routes (the pipeline and hybrid
engines' updates and `Optimizer.functional_apply`) and the bucketed one
(`fused_shard_updates`, all buckets of a step): the list becomes a table
of pointers and sizes that rides in the launch's parameters
(`UpdateTable`, cached on the optimizer and rebuilt only when a tensor's
pointer, dtype or size changes), the step's scalar block is built once,
each tensor's beta powers are read where the last step left them, and
the engine's loss-scaling path unscales with the reference's rounding
(the prefactored gradient rounded back to its dtype) and skips with the
found-inf select. Tensors of other dtypes go to other launches, and a
list longer than TABLE_CAP to more (`update_launches`); a CTA takes one
chunk of one tensor (`chunk_starts`). A one-tensor call (`fused_shard_update`,
calling a `ParamUpdates`) fills one row of a shared table instead
(`_update_one`), so a loop of them builds no table.

Plain versions: `grad_stats_plain` and `fused_shard_update_plain` (the
reference `shard_update`'s op chain, functional). CPU tensors run the
plain versions (the update's results copied back into its inputs, so
both routes keep one contract); CUDA tensors launch the kernels or
raise.
"""
import ctypes
import weakref

import numpy as np
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


# csrc/fused_optimizer.cu's update table (`Table`): TABLE_CAP entries, one
# column a field: eight 8-byte columns (the gradient and old-power pointers,
# which change every step, then the static ones), the fp32 decay column and
# the int32 first-chunk column (TABLE_CAP + 1 values)
TABLE_CAP = 384
_COLUMNS = ('g', 'pw', 'p', 'master', 's1', 's2', 's3', 'n')
_COL = {name: i for i, name in enumerate(_COLUMNS)}
# a CTA of the update takes one chunk of one entry, one vector of UPDATE_VEC
# elements a thread (chunks of 1-8 such trips were timed on the card over the
# pipeline's and BERT's lists, one the fastest; PERF.md)
UPDATE_THREADS, UPDATE_VEC = 256, 8
UPDATE_CHUNK = UPDATE_THREADS * UPDATE_VEC


def table_layout():
    """(bytes, wd column's byte offset, start column's byte offset) of the
    table, as the C struct lays it out."""
    wd = 8 * len(_COLUMNS) * TABLE_CAP
    start = wd + 4 * TABLE_CAP
    return -(-(start + 4 * (TABLE_CAP + 1)) // 8) * 8, wd, start


def chunk_starts(sizes):
    """Each entry's first chunk, then the grid's size: entry i owns the
    CTAs starts[i] .. starts[i + 1] - 1, at least one (a zero-element
    entry's CTA only writes its beta powers)."""
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + max(1, -(-n // UPDATE_CHUNK)))
    return starts


def update_launches(groups, sizes, cap=TABLE_CAP):
    """The launches of a list of tensors: entries of one kernel group
    (`groups[i]`: rule dtypes and master, which the kernel is built for)
    go together, groups in the order of their first entry and each in the
    caller's order, cut into runs of at most `cap`; entries of size 0
    launch nothing (the table passes a zero-element tensor that carries
    beta powers as size 1). Returns [(group, [entry indices])]."""
    by = {}
    for i, (grp, n) in enumerate(zip(groups, sizes)):
        if n:
            by.setdefault(grp, []).append(i)
    return [(grp, idx[j:j + cap]) for grp, idx in by.items()
            for j in range(0, len(idx), cap)]


_LAYOUT_CHECKED = []


def _check_layout():
    """The library's Table and chunk against table_layout() and
    UPDATE_CHUNK, once a process."""
    if not _LAYOUT_CHECKED:
        got = (ctypes.c_int * 5)()
        _build.lib().ptt_update_table_layout(ctypes.addressof(got))
        want = (TABLE_CAP, *table_layout(), UPDATE_CHUNK)
        if tuple(got) != want:
            raise RuntimeError(f'{STEP}: the kernel\'s update table is '
                               f'{tuple(got)}, the wrapper\'s {want}')
        _LAYOUT_CHECKED.append(True)


def _host_table():
    """A zeroed host `Table`: (its buffer, the [column, entry] pointer and
    size columns, the wd column, the first-chunk column)."""
    nbytes, wd_at, start_at = table_layout()
    buf = np.zeros(nbytes // 8, dtype=np.int64)
    cols = buf[:len(_COLUMNS) * TABLE_CAP].reshape(len(_COLUMNS), TABLE_CAP)
    wd = buf.view(np.float32)[wd_at // 4:wd_at // 4 + TABLE_CAP]
    start = buf.view(np.int32)[start_at // 4:start_at // 4 + TABLE_CAP + 1]
    return buf, cols, wd, start


def _checked_entry(optimizer, rule, h, keys, p, g, st, ref=None):
    """One entry's checks (element counts, dtypes, contiguity, RMSProp's
    centred state, one device with `ref` unless the caller checked the
    devices): (its state, with an fp32 master seeded from a low-precision
    p that had none, the master or None, its vector states `keys`,
    whether the master was seeded)."""
    st = dict(st)
    master = st.get('master')
    seeded = master is None and p.dtype != torch.float32 and \
        getattr(optimizer, '_multi_precision', True)
    if seeded:
        master = st['master'] = p.float()
    if rule == _RMSPROP and h['centered'] != ('mean_grad' in st):
        raise ValueError('fused_shard_update: a centered RMSProp state has '
                         'mean_grad, an uncentered one has not')
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
    if ref is not None:
        _build.on_cpu(ref, p, g, *st.values())
    return st, master, vecs, seeded


def _group(p, g, master, vecs):
    """The kernel an entry runs on: (p, g and vector-state dtype codes,
    whether it has a master)."""
    return (_build.dtype_code(p, STEP), _build.dtype_code(g, STEP),
            _build.dtype_code(vecs[0], STEP) if vecs else 0,
            int(master is not None))


def _launch_table(rule, h, device, addr, count, group, block, out, use_pref,
                  use_fi):
    """One launch of the first `count` entries of the host table at
    `addr`."""
    _check_layout()
    p_code, g_code, m_code, master = group
    _build.launch(
        'ptt_multi_update', STEP, device, addr, count,
        block.data_ptr(), _build.ptr(out), rule, p_code, g_code, m_code,
        master, h['coeff'], h['b1'], h['b2'], h['omb1'], h['omb2'], h['eps'],
        h['momentum'], h['rho'], h['omr'], h['nesterov'], h['decoupled'],
        h['centered'], int(use_pref), int(h['round']), int(use_fi))


class _Launch:
    """One launch of a table: its entries (indices into the caller's
    list), their kernel group and the host table it passes, with the
    static columns filled; two [count, 2] fp32 blocks that take the new
    beta powers in turns, each with its 0-dim views made once
    ({power key: view} an entry)."""

    def __init__(self, group, idx, cols, wd, sizes, powers, device):
        self.group, self.idx = group, idx
        self.buf, self.cols, wds, start = _host_table()
        self.addr = self.buf.ctypes.data
        k = len(idx)
        for name, values in cols.items():
            self.cols[_COL[name], :k] = values
        wds[:k] = wd
        start[:k + 1] = chunk_starts(sizes)
        self.blocks, self.views, self.turn = [], [], 0
        if powers:
            # each launch writes every row of its block before a step reads
            # it (the first step reads the states' own powers)
            for _ in range(2):
                b = torch.empty(k, 2, dtype=torch.float32, device=device)
                self.blocks.append(b)
                flat = b.view(-1).unbind(0)
                self.views.append([dict(zip(powers, flat[2 * j:2 * j + 2]))
                                   for j in range(k)])


class UpdateTable:
    """A list of tensors as the update kernel's launches. Built once per
    list (the checks a call made: `_checked_entry`), kept while every
    entry's static part (p's pointer, dtype and size, the gradient's
    dtype, size and device, the decay, the state tensors themselves) is
    unchanged; a step refills only the gradient and old-power columns."""

    def __init__(self, optimizer, rule, h, entries):
        self.rule, self.centered = rule, h['centered']
        self.scalar_keys = _SCALAR_KEYS.get(rule, ())
        self.device = entries[0][0].device
        self.seeded, self.checks = {}, []
        self.sizes, self.wds, ptrs, groups = [], [], [], []
        keys = [k for k in _VEC_KEYS[rule] if k != 'mean_grad' or
                h['centered']]
        for i, (p, g, st, wd) in enumerate(entries):
            st, master, vecs, seeded = _checked_entry(
                optimizer, rule, h, keys, p, g, st, ref=entries[0][0])
            if seeded:
                self.seeded[i] = master
            n = p.numel()
            self.wds.append(float(h['wd'] if wd is None else wd))
            held = tuple(zip(['master'] * (master is not None) + keys,
                             [master] * (master is not None) + vecs))
            self.checks.append((p.data_ptr(), p.dtype, n, g.dtype,
                                g.get_device(), self.wds[-1], len(st), held))
            self.sizes.append(n)
            ptrs.append([0 if master is None else master.data_ptr()]
                        + [t.data_ptr() for t in vecs] + [0] * (3 - len(vecs)))
            groups.append(_group(p, g, master, vecs))
        self.launches = []
        # a zero-element tensor launches only to step its beta powers, as
        # the op chain does
        live = [n or len(self.scalar_keys) for n in self.sizes]
        for group, idx in update_launches(groups, live):
            cols = {'p': [entries[i][0].data_ptr() for i in idx],
                    'n': [self.sizes[i] for i in idx]}
            for c, name in enumerate(('master', 's1', 's2', 's3')):
                cols[name] = [ptrs[i][c] for i in idx]
            self.launches.append(_Launch(
                group, idx, cols, [self.wds[i] for i in idx],
                [self.sizes[i] for i in idx], self.scalar_keys, self.device))
            spans = sorted((cols['p'][j], cols['p'][j] + self.sizes[i]
                            * entries[i][0].element_size(), i)
                           for j, i in enumerate(idx))
            for (_a0, a1, i), (b0, _b1, j) in zip(spans, spans[1:]):
                if b0 < a1:
                    raise ValueError(f'fused_shard_update: entries {i} and '
                                     f'{j} share memory')

    def matches(self, entries, h):
        """True when `entries` have this table's static part: the same p
        pointers, sizes, dtypes and decays, and the same state tensors
        (the objects the table was built from; a state whose storage is
        swapped in place is not seen)."""
        if len(entries) != len(self.checks) or h['centered'] != self.centered:
            return False
        default = float(h['wd'])
        for (p, g, st, wd), (ptr, p_dtype, n, g_dtype, dev, w, size,
                             held) in zip(entries, self.checks):
            if p.data_ptr() != ptr or p.dtype is not p_dtype or \
                    p.numel() != n or g.dtype is not g_dtype or \
                    g.numel() != n or g.get_device() != dev or \
                    not g.is_contiguous() or len(st) != size or \
                    (default if wd is None else wd) != w:
                return False
            for k, t in held:
                if st.get(k) is not t:
                    return False
        return True

    def _old_powers(self, launch, entries, keep):
        """The old-power pointers of a launch's entries: the rows of the
        block the last step wrote where the states hold its views, else
        rows of one fp32 stack of the states' own powers (kept alive in
        `keep` until the launch is queued; never the block this launch
        writes)."""
        keys = self.scalar_keys
        for i, views in zip(launch.idx, launch.views[1 - launch.turn]):
            st = entries[i][2]
            for k, v in views.items():
                if st[k] is not v:
                    break
            else:
                continue
            break
        else:
            base = launch.blocks[1 - launch.turn].data_ptr()
            return range(base, base + 8 * len(launch.idx), 8)
        stack = torch.stack([entries[i][2][k].to(
            device=self.device, dtype=torch.float32).reshape(())
            for i in launch.idx for k in keys])
        keep.append(stack)
        step = 4 * len(keys)
        return range(stack.data_ptr(), stack.data_ptr()
                     + step * len(launch.idx), step)

    def run(self, entries, h, block, use_pref, use_fi):
        """One step: every launch, in order; returns [(p, new state)]."""
        new = [None] * len(entries)
        for launch in self.launches:
            k = len(launch.idx)
            launch.cols[_COL['g'], :k] = [entries[i][1].data_ptr()
                                          for i in launch.idx]
            keep, out = [], None
            if self.scalar_keys:
                launch.cols[_COL['pw'], :k] = self._old_powers(
                    launch, entries, keep)
                out = launch.blocks[launch.turn]
            _launch_table(self.rule, h, self.device, launch.addr, k,
                          launch.group, block, out, use_pref, use_fi)
            if out is not None:
                for i, views in zip(launch.idx, launch.views[launch.turn]):
                    new[i] = {**entries[i][2], **views}
                launch.turn = 1 - launch.turn
        for i, (_p, _g, st, _wd) in enumerate(entries):
            if new[i] is None:
                new[i] = st.copy()
        for i, m in self.seeded.items():
            new[i]['master'] = m
        self.seeded = {}
        return [(e[0], ns) for e, ns in zip(entries, new)]


# {optimizer: {list length: UpdateTable}}: a step's table is kept on the
# optimizer whose states it points into
_TABLES = weakref.WeakKeyDictionary()


def update_table(optimizer, rule, h, entries, slot=0):
    """The cached table of `entries` ([(p, g, state, wd)]) in `slot` (one
    a learning-rate multiplier of the eager step), rebuilt when an
    entry's static part changed."""
    tables = _TABLES.setdefault(optimizer, {})
    key = (slot, len(entries))
    table = tables.get(key)
    if table is None or not table.matches(entries, h):
        table = tables[key] = UpdateTable(optimizer, rule, h, entries)
    return table


def _powers(st, keys, device):
    """A state's beta powers as one contiguous fp32 pair: its own tensors
    where they already are one (the views of the last launch's block),
    else a stack of them."""
    ts = [st[k] for k in keys]
    first = ts[0]
    if all(t.dtype == torch.float32 and t.device == device
           and t.numel() == 1 for t in ts) and all(
            t.data_ptr() == first.data_ptr() + 4 * j
            for j, t in enumerate(ts)):
        return first
    return torch.stack([t.to(device=device, dtype=torch.float32).reshape(())
                        for t in ts])


# the host table of one-entry launches, refilled by each (the launch copies
# it into the kernel's parameters)
_ONE = []


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


class ParamUpdates:
    """One step's updates on the update kernel, a list of tensors a launch
    (the reference's per-parameter `_update_one`, spmd_pipeline.py:2113-
    2127, and `Optimizer.functional_apply`, optimizer.py:103-158, which
    XLA fuses into one pass a parameter; and the bucketed
    `shard_update`), in place, with what is the same for every tensor of
    the step (the rule's constants, the [lr, prefactor, found_inf] block)
    built once.

    `apply([(p, g, state, wd), ...])` updates every p and its state's
    vector tensors in place and returns [(p, new state)] in order: one
    kernel launch for the list (one a group of tensors of the same
    dtypes, and one per TABLE_CAP of them), from a table kept on the
    optimizer and rebuilt only when a tensor's static part changed. Each
    state's new beta powers are 0-dim views of one [entries, 2] fp32
    block of the launch, which the next step reads in place (the launch
    writes its other block: a state's powers, like its vector states, are
    overwritten two steps later). Calling the object on (p, g, state)
    is `apply` of that one entry: (p, new state), as `fused_shard_update`
    returns; its launch takes the entry alone, its new powers one fresh
    fp32 pair. `wd` replaces the optimizer's decay into the gradient for
    that tensor (a parameter's own L2Decay); None keeps it.

    `prefactor` multiplies each gradient first; with `round_prefactor`
    (the default) the product is rounded back to the gradient's dtype
    (the engine's unscale, spmd_pipeline.py:923-926), without it not (the
    bucketed prefactor, as shard_update's); `found_inf` (a 0-dim device
    tensor) turns the step into a no-op that leaves each output
    bit-equal to its input. CPU tensors take the plain version, entry by
    entry. `slot` keys the cached table, so the eager step's groups of
    one learning-rate multiplier each keep their own."""

    def __init__(self, optimizer, lr, prefactor=None, found_inf=None,
                 round_prefactor=True, slot=0):
        _require_fusible(optimizer)
        self.optimizer = optimizer
        self.slot = slot
        self.lr, self.prefactor, self.found_inf = lr, prefactor, found_inf
        self.round_prefactor = round_prefactor
        self._rule, self._h = _rule(optimizer)
        self._h['round'] = int(round_prefactor)
        self._keys = [k for k in _VEC_KEYS[self._rule]
                      if k != 'mean_grad' or self._h['centered']]
        self._block = None

    def _extra(self):
        return [t for t in (self.lr, self.prefactor, self.found_inf)
                if isinstance(t, torch.Tensor)]

    def __call__(self, p, g, st, wd=None):
        if _build.on_cpu(p, g, *st.values(), *self._extra()):
            return shard_update_chain(
                self.optimizer, p, g, st, self.lr, self.prefactor,
                self.found_inf, round_prefactor=self.round_prefactor, wd=wd)
        return self._update_one(p, g, st, wd)

    def apply(self, entries):
        entries = list(entries)
        if not entries:
            return []
        if len(entries[0]) == 3:
            entries = [(p, g, st, None) for p, g, st in entries]
        if len(entries) == 1:
            return [self(*entries[0])]
        if _build.on_cpu(entries[0][0], *self._extra()):
            # every tensor of the list on the CPU, or a raise before any
            # update
            _build.on_cpu(*(t for p, g, st, _wd in entries
                            for t in (p, g, *st.values())))
            out = []
            for p, g, st, wd in entries:
                out.append(shard_update_chain(
                    self.optimizer, p, g, st, self.lr, self.prefactor,
                    self.found_inf, round_prefactor=self.round_prefactor,
                    wd=wd))
            return out
        return self._kernel_route(entries)

    def _step_block(self, device):
        if self._block is None:
            self._block = _step_block(self.lr, self.prefactor,
                                      self.found_inf, device)
        return self._block

    def _kernel_route(self, entries):
        """The launches of `entries` (4-tuples on one CUDA device): one
        entry on its own, a longer list from its cached table."""
        if len(entries) == 1:
            return [self._update_one(*entries[0])]
        table = update_table(self.optimizer, self._rule, self._h, entries,
                             self.slot)
        return table.run(entries, self._h, self._step_block(table.device),
                         self.prefactor is not None,
                         self.found_inf is not None)

    def _update_one(self, p, g, st, wd):
        """One entry without a cached table, which a loop of one-tensor
        calls would rebuild at every call: the entry's checks, its row in
        the shared one-entry table, its old powers read where its state
        holds them and one new fp32 pair; returns (p, new state)."""
        rule, h = self._rule, self._h
        st, master, vecs, _seeded = _checked_entry(
            self.optimizer, rule, h, self._keys, p, g, st)
        scalar_keys = _SCALAR_KEYS.get(rule, ())
        n = p.numel()
        if not (n or scalar_keys):
            return p, st
        pw = _powers(st, scalar_keys, p.device) if scalar_keys else None
        out = torch.empty(2, dtype=torch.float32, device=p.device) \
            if scalar_keys else None
        if not _ONE:
            table = _host_table()
            _ONE.append((table[0].ctypes.data, *table))
        addr, _buf, cols, wds, start = _ONE[0]
        cols[:, 0] = [g.data_ptr(), 0 if pw is None else pw.data_ptr(),
                      p.data_ptr(), 0 if master is None else master.data_ptr(),
                      *(t.data_ptr() for t in vecs), *[0] * (3 - len(vecs)),
                      n]
        wds[0] = h['wd'] if wd is None else wd
        start[1] = max(1, -(-n // UPDATE_CHUNK))
        _launch_table(rule, h, p.device, addr, 1, _group(p, g, master, vecs),
                      self._step_block(p.device), out,
                      self.prefactor is not None, self.found_inf is not None)
        for j, k in enumerate(scalar_keys):
            st[k] = out[j]
        return p, st


def fused_shard_update(optimizer, p, g, st, lr, prefactor=None,
                       found_inf=None):
    """One bucket's update, in place: returns (p, new state), where p
    and the state's vector tensors are the ones passed in, overwritten.
    The kernel on CUDA tensors; on CPU tensors the plain version, its
    results copied into the inputs."""
    return fused_shard_updates(optimizer, [p], [g], [st], lr, prefactor,
                               found_inf)[0]


def fused_shard_updates(optimizer, ps, gs, states, lr, prefactor=None,
                        found_inf=None):
    """Every bucket's update in one call (`fused_shard_update` of each, in
    one launch): [(p, new state)] in order."""
    return ParamUpdates(optimizer, lr, prefactor, found_inf,
                        round_prefactor=False).apply(
        list(zip(ps, gs, states)))
