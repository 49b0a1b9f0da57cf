"""paddle_tpu_torch's multi-tensor update (`ParamUpdates.apply`: one
launch of the fused update kernel for a list of tensors) against the
per-parameter calls and the JAX package's `_update_one`, on the CPU.

On CPU tensors the list form runs the kernel's plain version entry by
entry. Its kernel route (the table of pointers, sizes and decays that
rides in the launch's parameters, its groups and splits, the beta powers
read from the block the last step wrote, the masters it seeds) is driven
here too, with the launch replaced by an emulation that reads the table
the kernel would get, applies the plain chain to the memory its pointers
name and writes the new powers into the launch's block
(`_emulated_kernel`). The kernel's own arithmetic is held against the
plain chain on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: the list form, on both routes, bit-equal to per-parameter
calls (the same op chain on the same values). Against the JAX
reference's `_update_one`, rtol 1e-5 with at least 3/4 of the compared
tensors bit-equal: XLA's CPU compiler rewrites a few elements of some
rules' chains (a contracted multiply-add or a reordered product), up to
1.05e-6 relative after 3 steps on these inputs (DecayedAdagrad's fp32
master), so the bar leaves a margin of ten.
"""
import bisect
import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.fleet.meta_parallel import spmd_pipeline as jsp
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.distributed import topology_runtime as ttr
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    hybrid_engine as the)
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    spmd_pipeline as tsp)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_optimizer as TFO
from test_torch_update import FUSIBLE, STEPS

CPU = torch.device('cpu')
NEAR = dict(rtol=1e-5, atol=1e-12)
DTYPES = {0: torch.float32, 1: torch.bfloat16}
SHAPES = {'w': (6, 5), 'b': (5,), 'e': (3, 7, 2), 'z': (0,), 'x': (4, 3)}


def _make(rule, storage):
    """The rule's port optimizer at a storage: fp32, bf16 (no master;
    bf16 moments for Adam) or bf16 with an fp32 master."""
    kw = {'multi_precision': storage == 'bf16-master'} \
        if rule in ('sgd', 'momentum', 'nesterov', 'adam', 'adamw') else {}
    if rule in ('adam', 'adamw') and storage == 'bf16':
        kw['moment_dtype'] = 'bfloat16'
    opt = FUSIBLE[rule][0](**kw)
    if storage == 'bf16' and 'multi_precision' not in kw:
        opt._multi_precision = False
    return opt


def _inputs(seed, storage):
    """{name: param} and STEPS {name: gradient}, from a seeded numpy
    generator: the storage's dtype, except 'x' in the other one (a second
    kernel group); 'z' has no element. Gradients carry a loss scale of
    2^10."""
    rng = np.random.RandomState(seed)
    low = storage != 'fp32'
    dt = {n: (torch.bfloat16 if low != (n == 'x') else torch.float32)
          for n in SHAPES}
    params = {n: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dt[n])
              for n, s in SHAPES.items()}
    grads = [{n: torch.from_numpy(2.0 ** 10 * rng.randn(*s).astype(
        np.float32)).to(dt[n]) for n, s in SHAPES.items()}
        for _ in range(STEPS)]
    return params, grads


def _grid(starts, sizes, chunk):
    """What each CTA of a launch updates, as the kernel finds it: [(entry,
    first element, end)] in CTA order (the entry by a search for the last
    first chunk at or before the CTA's index)."""
    out = []
    for c in range(starts[-1]):
        e = bisect.bisect_right(starts, c, 0, len(sizes)) - 1
        first = (c - starts[e]) * chunk
        out.append((e, first, min(sizes[e], first + chunk)))
    return out


def _raw(ptr, n, dtype):
    """A tensor over the n elements of `dtype` at host address `ptr`."""
    if not n:
        return torch.empty(0, dtype=dtype)
    size = torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_uint8 * (n * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype, count=n)


def _emulated_kernel(opt, calls):
    """`_build.launch` for `ptt_multi_update` on CPU memory: reads the
    host table the kernel would get (every column, the chunk starts),
    reads each entry's OLD beta powers first, applies the plain chain to
    the tensors the pointers name, writes the new powers into the
    launch's block, and counts the launch. Records each launch in
    `calls`."""
    nbytes, wd_at, start_at = TFO.table_layout()
    cap, col = TFO.TABLE_CAP, {c: i for i, c in enumerate(TFO._COLUMNS)}

    def launch(fn, kernel, device, addr, count, sc, out, rule, p_code,
               g_code, m_code, master, *rest, launches=1):
        assert fn == 'ptt_multi_update' and kernel == TFO.STEP
        assert device.type == 'cpu' and 1 <= count <= cap
        words = np.frombuffer((ctypes.c_uint8 * nbytes).from_address(addr),
                              dtype=np.int64)
        cols = words[:8 * cap].reshape(8, cap)
        wd = words.view(np.float32)[wd_at // 4:wd_at // 4 + count]
        start = words.view(np.int32)[start_at // 4:start_at // 4 + count + 1]
        sizes = [int(cols[col['n'], e]) for e in range(count)]
        assert list(start) == TFO.chunk_starts(sizes)
        centered, use_pref, round_pref, use_fi = rest[11], *rest[12:]
        scal = _raw(sc, 3, torch.float32).clone()
        pref = scal[1] if use_pref else None
        found = scal[2] > 0.5 if use_fi else None
        keys = [k for k in TFO._VEC_KEYS[rule]
                if k != 'mean_grad' or centered]
        skeys = TFO._SCALAR_KEYS.get(rule, ())
        work = []
        for e, n in enumerate(sizes):
            st = {k: _raw(int(cols[col[c], e]), n, DTYPES[m_code])
                  for k, c in zip(keys, ('s1', 's2', 's3'))}
            if master:
                st['master'] = _raw(int(cols[col['master'], e]), n,
                                    torch.float32)
            if skeys:
                pw = int(cols[col['pw'], e])
                # the kernel reads the old powers, never the block it writes
                assert not out <= pw < out + 8 * count
                old = _raw(pw, len(skeys), torch.float32).clone()
                st.update({k: old[j] for j, k in enumerate(skeys)})
            work.append((_raw(int(cols[col['p'], e]), n, DTYPES[p_code]),
                         _raw(int(cols[col['g'], e]), n, DTYPES[g_code]),
                         st, float(wd[e])))
        for e, (p, g, st, w) in enumerate(work):
            new_p, ns = TFO.fused_shard_update_plain(
                opt, p, g, st, scal[0], pref, found,
                round_prefactor=bool(round_pref), wd=w)
            p.copy_(new_p)
            for k in keys + (['master'] if master else []):
                st[k].copy_(ns[k])
            if skeys:
                row = _raw(out + 8 * e, 2, torch.float32)
                for j, k in enumerate(skeys):
                    row[j] = ns[k]
        calls.append(dict(count=count, group=(p_code, g_code, m_code,
                                              master),
                          pw=[int(cols[col['pw'], e]) for e in range(count)],
                          out=out))
        _build.count_launch(kernel, launches)
    return launch


@pytest.fixture
def emulated(monkeypatch):
    """Route ParamUpdates' kernel route through `_emulated_kernel`:
    yields (run(upd, entries), the recorded launches)."""
    calls = []
    monkeypatch.setattr(TFO, '_check_layout', lambda: None)

    def run(upd, entries):
        monkeypatch.setattr(_build, 'launch',
                            _emulated_kernel(upd.optimizer, calls))
        return upd._kernel_route([(p, g, st, wd)
                                  for p, g, st, wd in entries])
    _build.reset_launches()
    yield run, calls
    # the emulated launches were counted: leave the counters as found
    _build.reset_launches()


def _three_routes(opt_of, storage, emulated, wd=0.02, **upd_kw):
    """STEPS steps of the same list on three routes, each from the same
    values: per-parameter calls, the list form on CPU tensors, and the
    list form's kernel route (emulated). Parameter 'w' carries its own
    decay `wd`. Returns {route: (params, states)} and the launches a
    step of the kernel route."""
    run, calls = emulated
    params, grads = _inputs(5, storage)
    lr = torch.tensor(0.01)
    pref = torch.tensor(2.0 ** -10)
    out, per_step = {}, []
    for route in ('per_param', 'list', 'kernel'):
        opt = opt_of()
        ps = {n: p.clone() for n, p in params.items()}
        sts = {n: opt.init_state(p) for n, p in ps.items()}
        for g in grads:
            upd = TFO.ParamUpdates(opt, lr, prefactor=pref, **upd_kw)
            entries = [(ps[n], g[n].clone(), sts[n], wd if n == 'w' else
                        None) for n in ps]
            if route == 'per_param':
                res = [upd(p, gg, st, wd=w) for p, gg, st, w in entries]
            elif route == 'list':
                res = upd.apply(entries)
            else:
                before = len(calls)
                res = run(upd, entries)
                per_step.append(len(calls) - before)
            for n, (p, st) in zip(ps, res):
                assert p is ps[n]                       # in place
                sts[n] = st
        out[route] = (ps, sts)
    return out, per_step


def _assert_equal(a, b):
    (pa, sa), (pb, sb) = a, b
    for n in pa:
        assert pa[n].dtype == pb[n].dtype and torch.equal(pa[n], pb[n]), n
        assert set(sa[n]) == set(sb[n]), n
        for k in sa[n]:
            assert torch.equal(sa[n][k], sb[n][k]), (n, k)


@pytest.mark.parametrize('storage', ['fp32', 'bf16', 'bf16-master'])
@pytest.mark.parametrize('rule', list(FUSIBLE))
def test_list_form_equals_per_parameter_calls(rule, storage, emulated):
    """Every fusible rule over a list holding a zero-element tensor, a
    tensor of the other dtype and a tensor with its own decay, under a
    loss-scale prefactor rounded to the gradient's dtype, for STEPS
    steps: the list form on CPU tensors and its kernel route equal the
    per-parameter calls bit for bit (the empty tensor's beta powers step
    too). The kernel route launches once per dtype group a step."""
    out, per_step = _three_routes(lambda: _make(rule, storage), storage,
                                  emulated)
    _assert_equal(out['list'], out['per_param'])
    _assert_equal(out['kernel'], out['per_param'])
    assert per_step == [2] * STEPS
    assert _build.routes_snapshot()[TFO.STEP] == 2 * STEPS


@pytest.mark.parametrize('storage', ['fp32', 'bf16-master'])
def test_unrounded_prefactor_is_the_bucketed_update(storage, emulated):
    """round_prefactor=False (the bucketed route's prefactor, not rounded
    to the gradient's dtype) on all three routes, and `fused_shard_update`
    per tensor, agree bit for bit."""
    out, _ = _three_routes(lambda: _make('adamw', storage), storage,
                           emulated, wd=None, round_prefactor=False)
    _assert_equal(out['kernel'], out['per_param'])
    _assert_equal(out['list'], out['per_param'])
    opt = _make('adamw', storage)
    params, grads = _inputs(5, storage)
    sts = {n: opt.init_state(p) for n, p in params.items()}
    for g in grads:
        for n, p in params.items():
            _p, sts[n] = TFO.fused_shard_update(
                opt, p, g[n], sts[n], torch.tensor(0.01),
                prefactor=torch.tensor(2.0 ** -10))
    _assert_equal((params, sts), out['list'])


@pytest.mark.parametrize('rule', ['momentum', 'adamw', 'rmsprop', 'adamax'])
def test_found_inf_leaves_every_entry_bit_equal(rule, emulated):
    """found_inf set on NaN gradients: every parameter, vector state and
    beta power of every entry keeps its bits, on both list routes."""
    run, _calls = emulated
    opt = _make(rule, 'bf16-master')
    params, grads = _inputs(6, 'bf16-master')
    for route in ('list', 'kernel'):
        ps = {n: p.clone() for n, p in params.items()}
        sts = {n: opt.init_state(p) for n, p in ps.items()}
        for st in sts.values():
            for k, v in st.items():
                v.fill_(0.5 if v.dim() else 0.9)
        before = ({n: p.clone() for n, p in ps.items()},
                  {n: {k: v.clone() for k, v in st.items()}
                   for n, st in sts.items()})
        upd = TFO.ParamUpdates(opt, torch.tensor(0.01),
                               prefactor=torch.tensor(0.5),
                               found_inf=torch.tensor(True))
        entries = [(ps[n], torch.full_like(grads[0][n], float('nan')),
                    sts[n], None) for n in ps]
        res = upd.apply(entries) if route == 'list' else run(upd, entries)
        for n, (p, st) in zip(ps, res):
            assert torch.equal(p, before[0][n]), (route, n)
            for k, v in before[1][n].items():
                assert torch.equal(st[k], v), (route, n, k)


@pytest.mark.parametrize('storage', ['fp32', 'bf16-master'])
@pytest.mark.parametrize('rule', list(FUSIBLE))
def test_list_form_matches_the_reference_update_one(rule, storage,
                                                    emulated):
    """The list form (both routes) against the JAX engine's
    `_update_one` (spmd_pipeline.py:2113) on the same numpy values over
    STEPS steps, no prefactor: within NEAR, mostly bit-equal."""
    run, _calls = emulated
    rng = np.random.RandomState(8)
    shapes = {n: s for n, s in SHAPES.items() if n != 'x'}
    low = storage != 'fp32'
    arrays = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (0.5 * rng.randn(*s)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(STEPS)]
    cast = (lambda t: t.bfloat16()) if low else (lambda t: t)
    jdt = jnp.bfloat16 if low else jnp.float32
    jopt = FUSIBLE[rule][1]()
    eng = SimpleNamespace(optimizer=jopt)
    jp = {n: jnp.asarray(np.array(a)).astype(jdt) for n, a in arrays.items()}
    jst = {}
    for n, p in jp.items():
        jst[n] = dict(jopt.init_state(Tensor(p.astype(jnp.float32))))
        if low:
            jst[n]['master'] = p.astype(jnp.float32)
    lr = 0.1
    for g in grads:
        for n in jp:
            jg = jnp.asarray(np.array(g[n])).astype(jdt)
            jp[n], jst[n] = jsp.SpmdPipelineEngine._update_one(
                eng, jp[n], jg, dict(jst[n]), jnp.asarray(lr, jnp.float32))
    exact = total = 0
    for route in ('list', 'kernel'):
        opt = _make(rule, storage)
        ps = {n: cast(torch.from_numpy(np.array(a))) for n, a in
              arrays.items()}
        sts = {n: opt.init_state(p) for n, p in ps.items()}
        for g in grads:
            upd = TFO.ParamUpdates(opt, torch.tensor(lr))
            entries = [(ps[n], cast(torch.from_numpy(np.array(g[n]))),
                        sts[n], None) for n in ps]
            res = upd.apply(entries) if route == 'list' else \
                run(upd, entries)
            sts = {n: st for n, (_p, st) in zip(ps, res)}
        for n in ps:
            pairs = [('p', ps[n], jp[n])] + [(k, sts[n][k], v)
                                              for k, v in jst[n].items()]
            for k, got, want in pairs:
                got = got.float().numpy()
                want = np.asarray(jnp.asarray(want).astype(jnp.float32))
                np.testing.assert_allclose(got, want, err_msg=f'{n}.{k}',
                                           **NEAR)
                exact += int(np.array_equal(got, want))
                total += 1
    # XLA's rewrites touch a few elements of a few rules' chains
    assert exact >= 0.75 * total


def test_new_beta_powers_are_views_of_one_block_read_next_step(emulated):
    """AdamW over a list: after a step each state's beta1_pow and
    beta2_pow are the two floats of its row of one [entries, 2] fp32
    block; the next step reads exactly those rows (the pw column) and
    writes the other block; the step after, the first block again."""
    run, calls = emulated
    opt = _make('adamw', 'fp32')
    params, grads = _inputs(7, 'fp32')
    ps = {n: p for n, p in params.items() if n not in ('z', 'x')}
    sts = {n: opt.init_state(p) for n, p in ps.items()}
    outs = []
    for g in grads:
        upd = TFO.ParamUpdates(opt, torch.tensor(0.01))
        res = run(upd, [(p, g[n], sts[n], None) for n, p in ps.items()])
        sts = {n: st for n, (_p, st) in zip(ps, res)}
        block = calls[-1]['out']
        outs.append(block)
        for j, st in enumerate(sts.values()):
            assert st['beta1_pow'].dim() == 0
            assert st['beta1_pow'].data_ptr() == block + 8 * j
            assert st['beta2_pow'].data_ptr() == block + 8 * j + 4
        if len(outs) > 1:
            assert calls[-1]['pw'] == [outs[-2] + 8 * j
                                       for j in range(len(ps))]
    assert outs[0] != outs[1] and outs[2] == outs[0]
    want = {n: opt.init_state(p) for n, p in params.items()}
    for st in want.values():
        st['beta1_pow'] = st['beta1_pow'] * 0.9 ** STEPS
        st['beta2_pow'] = st['beta2_pow'] * 0.999 ** STEPS
    for n, st in sts.items():
        for k in ('beta1_pow', 'beta2_pow'):
            torch.testing.assert_close(st[k], want[n][k], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------
def test_launches_group_by_kernel_keep_order_and_split():
    groups = ['a', 'b', 'a', 'a', 'c', 'b', 'a', 'a']
    sizes = [3, 1, 0, 5, 2, 7, 1, 4]
    assert TFO.update_launches(groups, sizes) == [
        ('a', [0, 3, 6, 7]), ('b', [1, 5]), ('c', [4])]
    assert TFO.update_launches(groups, sizes, cap=2) == [
        ('a', [0, 3]), ('a', [6, 7]), ('b', [1, 5]), ('c', [4])]
    assert TFO.update_launches(groups, sizes, cap=3) == \
        TFO.update_launches(list(groups), list(sizes), cap=3)
    assert TFO.update_launches(['a'] * 3, [0, 0, 0]) == []


CHUNK = TFO.UPDATE_CHUNK


@pytest.mark.parametrize('sizes', [
    [1, 7, 768, 0, 20000, 8],
    [CHUNK, 0, CHUNK + 1, 3 * CHUNK - 5, 1, 2 * CHUNK]],
    ids=['ragged', 'chunk-edges'])
def test_every_element_lies_in_exactly_one_chunk(sizes):
    starts = TFO.chunk_starts(sizes)
    assert starts[0] == 0 and all(a < b for a, b in zip(starts, starts[1:]))
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    ctas = [0] * len(sizes)
    for e, first, end in _grid(starts, sizes, CHUNK):
        assert 0 <= first <= end <= sizes[e] and end - first <= CHUNK
        assert first < end or sizes[e] == 0
        seen[e][first:end] += 1
        ctas[e] += 1
    assert all((s == 1).all() for s in seen)
    # a zero-element entry's one CTA writes its beta powers only
    assert [c for c, n in zip(ctas, sizes) if not n] == [1]


def _table_entries(opt):
    ps = [torch.randn(6, 5), torch.randn(5), torch.randn(70)]
    sts = [opt.init_state(p) for p in ps]
    return [(p, torch.randn_like(p), st, None) for p, st in zip(ps, sts)]


def test_table_columns_and_when_it_is_rebuilt():
    """The static columns hold each entry's pointers, size, decay and
    first chunk; the same list with new gradients keeps the cached table;
    a new state tensor or another decay rebuilds it."""
    opt = topt.AdamW(0.01, weight_decay=0.05)
    upd = TFO.ParamUpdates(opt, torch.tensor(0.01))
    entries = _table_entries(opt)
    table = TFO.update_table(opt, upd._rule, upd._h, entries)
    (launch,) = table.launches
    col = {c: i for i, c in enumerate(TFO._COLUMNS)}
    for j, (p, _g, st, _wd) in enumerate(entries):
        assert launch.cols[col['p'], j] == p.data_ptr()
        assert launch.cols[col['s1'], j] == st['moment1'].data_ptr()
        assert launch.cols[col['s2'], j] == st['moment2'].data_ptr()
        assert launch.cols[col['master'], j] == launch.cols[col['s3'], j] == 0
        assert launch.cols[col['n'], j] == p.numel()
    start_at = TFO.table_layout()[2] // 4
    assert list(launch.buf.view(np.int32)[start_at:start_at + 4]) == \
        TFO.chunk_starts([30, 5, 70])
    wd = launch.buf.view(np.float32)[TFO.table_layout()[1] // 4:][:3]
    assert list(wd) == [0.0] * 3             # AdamW decays the param
    fresh = [(p, torch.randn_like(p), st, wd) for p, _g, st, wd in entries]
    assert TFO.update_table(opt, upd._rule, upd._h, fresh) is table
    moved = list(fresh)
    p, g, st, _wd = moved[1]
    moved[1] = (p, g, dict(st, moment2=st['moment2'].clone()), None)
    assert TFO.update_table(opt, upd._rule, upd._h, moved) is not table
    table = TFO.update_table(opt, upd._rule, upd._h, fresh)
    decayed = fresh[:2] + [fresh[2][:3] + (0.5,)]
    other = TFO.update_table(opt, upd._rule, upd._h, decayed)
    assert other is not table and other.wds == [0.0, 0.0, 0.5]


def test_table_seeds_masters_and_refuses_what_a_call_refused():
    opt = topt.Adam(0.01)                       # bf16: an fp32 master
    upd = TFO.ParamUpdates(opt, torch.tensor(0.01))
    p = torch.randn(9).bfloat16()
    st = opt.init_state(p)
    table = TFO.update_table(opt, upd._rule, upd._h,
                             [(p, torch.randn(9).bfloat16(), st, None)])
    assert torch.equal(table.seeded[0], p.float())
    assert table.launches[0].group == (1, 1, 0, 1)
    st = dict(st, master=table.seeded[0])   # the state the step returns
    assert TFO.update_table(opt, upd._rule, upd._h, [
        (p, torch.randn(9).bfloat16(), st, None)]) is table
    # fp32 gradients of a bf16 tensor (clipped by value): another group
    widened = TFO.update_table(opt, upd._rule, upd._h,
                               [(p, torch.randn(9), st, None)])
    assert widened is not table and widened.launches[0].group == (1, 0, 0, 1)
    for bad, err in (((p, torch.randn(8).bfloat16(), st, None), ValueError),
                     ((p, torch.randn(9).half(), st, None), TypeError),
                     ((p, torch.randn(18).bfloat16()[::2], st, None),
                      ValueError)):
        with pytest.raises(err):
            TFO.update_table(opt, upd._rule, upd._h, [bad])
    with pytest.raises(ValueError, match='share memory'):
        TFO.update_table(opt, upd._rule, upd._h, [
            (p, torch.randn(9).bfloat16(), st, None),
            (p[:4], torch.randn(4).bfloat16(), opt.init_state(p[:4]), None)])
    rms = topt.RMSProp(0.01, centered=True)
    upd = TFO.ParamUpdates(rms, torch.tensor(0.01))
    q = torch.randn(4)
    with pytest.raises(ValueError, match='centered'):
        TFO.update_table(rms, upd._rule, upd._h, [
            (q, torch.randn(4), topt.RMSProp(0.01).init_state(q), None)])


def test_a_list_above_capacity_splits_in_order(emulated):
    """TABLE_CAP + 16 tensors of one group take two launches, the first
    TABLE_CAP entries and then the rest, and equal per-tensor calls."""
    run, calls = emulated
    opt = topt.Momentum(0.05, weight_decay=1e-3)
    n = TFO.TABLE_CAP + 16
    gen = torch.Generator().manual_seed(3)
    ps = [torch.randn(3 + i % 5, generator=gen) for i in range(n)]
    gs = [torch.randn(p.shape, generator=gen) for p in ps]
    want = [(p.clone(), opt.init_state(p)) for p in ps]
    for (p, st), g in zip(want, gs):
        TFO.ParamUpdates(opt, torch.tensor(0.1))(p, g, st)
    res = run(TFO.ParamUpdates(opt, torch.tensor(0.1)),
              [(p, g, opt.init_state(p), None) for p, g in zip(ps, gs)])
    assert [c['count'] for c in calls] == [TFO.TABLE_CAP, 16]
    for (p, st), (wp, ws) in zip(res, want):
        assert torch.equal(p, wp) and torch.equal(st['velocity'],
                                                  ws['velocity'])


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the wrapper's route
    choice sees of a tensor on the card (no card here)."""

    @property
    def device(self):
        return torch.device('cuda', 0)


@pytest.mark.parametrize('lr', [0.1, torch.tensor(0.1)],
                         ids=['float-lr', 'tensor-lr'])
def test_a_card_tensor_after_a_cpu_one_raises(lr):
    """A list whose first tensor is on the CPU takes the plain route; a
    later tensor on the card raises there, under a Python lr too (the
    eager step's), and the CPU tensor before it is left as it was."""
    opt = topt.Momentum(0.05)
    p, q = torch.randn(5), torch.randn(4)
    card = q.as_subclass(_OnCard)
    assert card.device.type == 'cuda'
    entries = [(p, torch.randn(5), opt.init_state(p), None),
               (card, torch.randn(4).as_subclass(_OnCard),
                {k: v.as_subclass(_OnCard)
                 for k, v in opt.init_state(q).items()}, None)]
    before = p.clone()
    with pytest.raises(ValueError, match='different devices'):
        TFO.ParamUpdates(opt, lr).apply(entries[1:] + entries[:1])
    with pytest.raises(ValueError, match='different devices'):
        TFO.ParamUpdates(opt, lr).apply(entries)
    with pytest.raises(ValueError, match='different devices'):
        opt._apply({'p': p, 'q': card}, {'p': entries[0][1],
                                         'q': entries[1][1]},
                   {'p': entries[0][2], 'q': entries[1][2]}, lr, {})
    assert torch.equal(p, before)


@pytest.mark.parametrize('rule', ['sgd', 'momentum', 'adamw', 'adamax'])
def test_one_entry_calls_launch_alone_without_a_table(rule, emulated):
    """A loop of one-tensor calls on the kernel route
    (`ParamUpdates._update_one`): one launch of one entry a call, no
    cached table, each call's new beta
    powers a fresh fp32 pair that the next step's call reads, and bit for
    bit the per-parameter calls on the plain route, over STEPS steps of
    every tensor (the zero-element one included)."""
    run, calls = emulated
    params, grads = _inputs(9, 'bf16-master')
    got, want = {}, {}
    for route, out in (('kernel', got), ('plain', want)):
        opt = _make(rule, 'bf16-master')
        ps = {n: p.clone() for n, p in params.items()}
        sts = {n: opt.init_state(p) for n, p in ps.items()}
        for g in grads:
            upd = TFO.ParamUpdates(opt, torch.tensor(0.01),
                                   prefactor=torch.tensor(2.0 ** -10))
            for n, p in ps.items():
                entry = (p, g[n].clone(), sts[n], None)
                if route == 'plain':
                    _p, sts[n] = upd(*entry)
                    continue
                before = len(calls)
                ((_p, sts[n]),) = run(upd, [entry])
                skeys = TFO._SCALAR_KEYS.get(upd._rule, ())
                # a zero-element tensor launches only to step its powers
                assert _p is p and len(calls) == before + bool(
                    p.numel() or skeys)
                assert calls[-1]['count'] == 1
                for j, k in enumerate(skeys):
                    assert sts[n][k].data_ptr() == calls[-1]['out'] + 4 * j
            assert 1 not in TFO._TABLES.get(opt, {})
        out.update(ps=ps, sts=sts)
    _assert_equal((got['ps'], got['sts']), (want['ps'], want['sts']))
    if rule in ('adamw', 'adamax'):
        # the step after the first reads the pair the last call wrote
        outs = [c['out'] for c in calls]
        assert all(c['pw'][0] in outs[:i] for i, c in
                   enumerate(calls) if i >= len(SHAPES))


# ---------------------------------------------------------------------------
# the callers: one list a step
# ---------------------------------------------------------------------------
def _count_lists(monkeypatch):
    """Spy on ParamUpdates.apply: the list lengths it is called with."""
    seen = []
    orig = TFO.ParamUpdates.apply

    def apply(self, entries):
        entries = list(entries)
        seen.append(len(entries))
        return orig(self, entries)
    monkeypatch.setattr(TFO.ParamUpdates, 'apply', apply)
    return seen


def test_callers_take_one_list_a_step(monkeypatch):
    """The pipeline engine, the hybrid engine, functional_apply with a
    parameter's own L2Decay, and TrainStep on both routes each hand the
    update one list a step (the bucketed route: every bucket)."""
    seen = _count_lists(monkeypatch)
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                         num_heads=2, max_seq_len=16, hidden_dropout=0.0,
                         attn_dropout=0.0)
    ids = np.random.RandomState(0).randint(0, 64, (4, 16)).astype('int32')
    data = (ids, np.roll(ids, -1, 1).astype('int32'))
    triple = tgpt.build_gpt_pipeline(
        cfg, generator=torch.Generator().manual_seed(1))
    eng = tsp.SpmdPipelineEngine(*triple, topt.AdamW(1e-3),
                                 accumulate_steps=2, device='cpu')
    for _ in range(2):
        eng.train_batch(data)
    assert seen == [len(eng._named)] * 2
    seen.clear()

    model = tgpt.GPTForCausalLM(cfg, generator=torch.Generator()
                                .manual_seed(2))

    def loss(m, x, y):
        return tgpt.GPTPretrainingCriterion()(m(x), y)
    ttr.build_mesh(['dp', 'sharding'], [1, 1])
    heng = the.HybridParallelTrainStep(model, loss, topt.SGD(0.1),
                                       device='cpu')
    heng(torch.from_numpy(data[0]), torch.from_numpy(data[1]))
    assert seen == [len(heng._named)]
    seen.clear()

    opt = topt.Momentum(0.1)
    ps = {'a': torch.randn(4), 'b': torch.randn(3)}
    gs = {'a': torch.randn(4), 'b': torch.randn(3)}
    got, _ = opt._apply(ps, gs, {}, torch.tensor(0.1),
                        {'a': treg.L2Decay(0.5), 'b': treg.L1Decay(0.5)})
    assert seen == [1] and list(got) == ['a', 'b']
    seen.clear()

    for buckets in (False, True):
        model = tgpt.GPTForCausalLM(cfg, generator=torch.Generator()
                                    .manual_seed(2))
        step = tjit.TrainStep(model, loss, topt.AdamW(1e-3),
                              use_buckets=buckets, device='cpu')
        step(torch.from_numpy(data[0]), torch.from_numpy(data[1]))
        n = len(step.layout.buckets) if buckets else \
            len(list(model.parameters()))
        assert seen == [n], buckets
        seen.clear()
