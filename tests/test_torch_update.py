"""paddle_tpu_torch's one-card update step against `paddle_tpu`: the
per-parameter route on the fused update kernel's plain version, the
optimizers without a kernel rule (Lamb, Lars, Ftrl, DGCMomentum), the
regularizers, the softmax_with_cross_entropy variants and the
on-device LR schedules.

Tolerances:
- the per-parameter route (`ParamUpdates`, used by
  `Optimizer.functional_apply` and the pipeline engine for a fusible
  rule) against the op chain it replaces: bit-equal (the same ops
  rounded in the same order), for all nine fusible rules;
- against the JAX package, fp32: rtol 2e-4 / atol 2e-5 (the reference
  tests' fp32 bars: summation order), for params, states and losses;
- the on-device LR against the JAX package's traced schedule: rtol
  1e-6 (both take fp32 ops; torch's and XLA's cos, exp and pow may
  round an ulp apart) and against the host float64 schedule rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.fleet.meta_parallel import spmd_pipeline as jsp
from paddle_tpu.ops import nn_ops as jF
from paddle_tpu.optimizer import device_lr as jdlr
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    spmd_pipeline as tsp)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import nn_ops as tF
from paddle_tpu_torch.ops.kernels import fused_optimizer as TFO
from paddle_tpu_torch.optimizer import device_lr as tdlr
from paddle_tpu_torch.optimizer import lr as tlr
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-4, atol=2e-5)
STEPS = 3


def _tt(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _case(seed, dtype=np.float32):
    """{name: param}, and STEPS gradients of each, from a seeded numpy
    generator: a matrix, a vector and a ragged tensor."""
    rng = np.random.RandomState(seed)
    shapes = {'w': (6, 5), 'b': (5,), 'e': (3, 7, 2)}
    params = {n: rng.randn(*s).astype(dtype) for n, s in shapes.items()}
    grads = [{n: (0.5 * rng.randn(*s)).astype(dtype)
              for n, s in shapes.items()} for _ in range(STEPS)]
    return params, grads


# every fusible rule, as its port constructor (bf16-able) and the JAX one
FUSIBLE = {
    'sgd': (lambda **kw: topt.SGD(0.1, weight_decay=0.01, **kw),
            lambda: paddle.optimizer.SGD(0.1, weight_decay=0.01,
                                         parameters=[])),
    'momentum': (lambda **kw: topt.Momentum(0.05, weight_decay=1e-3, **kw),
                 lambda: paddle.optimizer.Momentum(
                     0.05, weight_decay=1e-3, parameters=[])),
    'nesterov': (lambda **kw: topt.Momentum(0.05, use_nesterov=True, **kw),
                 lambda: paddle.optimizer.Momentum(
                     0.05, use_nesterov=True, parameters=[])),
    'adam': (lambda **kw: topt.Adam(0.01, weight_decay=0.01, **kw),
             lambda: paddle.optimizer.Adam(0.01, weight_decay=0.01,
                                           parameters=[])),
    'adamw': (lambda **kw: topt.AdamW(0.01, weight_decay=0.05, **kw),
              lambda: paddle.optimizer.AdamW(0.01, weight_decay=0.05,
                                             parameters=[])),
    'adagrad': (lambda **kw: topt.Adagrad(
                    0.1, initial_accumulator_value=0.1, weight_decay=0.01),
                lambda: paddle.optimizer.Adagrad(
                    0.1, initial_accumulator_value=0.1, weight_decay=0.01,
                    parameters=[])),
    'rmsprop': (lambda **kw: topt.RMSProp(0.01, momentum=0.9,
                                          centered=True),
                lambda: paddle.optimizer.RMSProp(
                    0.01, momentum=0.9, centered=True, parameters=[])),
    'adamax': (lambda **kw: topt.Adamax(0.01),
               lambda: paddle.optimizer.Adamax(0.01, parameters=[])),
    'adadelta': (lambda **kw: topt.Adadelta(0.5),
                 lambda: paddle.optimizer.Adadelta(0.5, parameters=[])),
    'decayed_adagrad': (lambda **kw: topt.DecayedAdagrad(0.05),
                        lambda: paddle.optimizer.DecayedAdagrad(
                            0.05, parameters=[])),
}


def _chain(opt):
    """The same optimizer with its fused route off: `_apply` runs the op
    chain it ran before the route existed."""
    opt._pallas_fusible = False
    assert not TFO.fusible(opt)
    return opt


def _steps(opt, params, grads, lr=0.1):
    """STEPS functional_apply calls; (params, states) after them."""
    ps = {n: _tt(a) for n, a in params.items()}
    states = {}
    for g in grads:
        ps, states = opt.functional_apply(
            ps, {n: _tt(a) for n, a in g.items()}, states,
            torch.tensor(lr, dtype=torch.float32))
    return ps, states


@pytest.mark.parametrize('storage', ['fp32', 'bf16', 'bf16-master'])
@pytest.mark.parametrize('rule', list(FUSIBLE))
def test_per_parameter_route_equals_the_chain_bit_for_bit(rule, storage):
    make = FUSIBLE[rule][0]
    kw = {'multi_precision': storage == 'bf16-master'} \
        if rule in ('sgd', 'momentum', 'nesterov', 'adam', 'adamw') else {}
    if rule in ('adam', 'adamw') and storage == 'bf16':
        kw['moment_dtype'] = 'bfloat16'
    params, grads = _case(1)
    if storage != 'fp32':
        params = {n: _np(_tt(a).bfloat16()) for n, a in params.items()}
    cast = (lambda t: t.bfloat16()) if storage != 'fp32' else (lambda t: t)
    fused, chain = make(**kw), _chain(make(**kw))
    for opt in (fused, chain):
        if storage == 'bf16' and 'multi_precision' not in kw:
            opt._multi_precision = False
    got, want = [], []
    for opt, out in ((fused, got), (chain, want)):
        ps = {n: cast(_tt(a)) for n, a in params.items()}
        states = {}
        for g in grads:
            new, states = opt.functional_apply(
                ps, {n: cast(_tt(a)) for n, a in g.items()}, states,
                torch.tensor(0.1))
            if opt is fused:
                assert all(new[n] is ps[n] for n in ps)   # in place
            ps = new
        out.append((ps, states))
    (gp, gs), (wp, ws) = got[0], want[0]
    for n in params:
        assert gp[n].dtype == wp[n].dtype and torch.equal(gp[n], wp[n]), n
        assert set(gs[n]) == set(ws[n])
        for k in ws[n]:
            assert torch.equal(gs[n][k], ws[n][k]), (n, k)


@pytest.mark.parametrize('rule', list(FUSIBLE))
def test_per_parameter_route_matches_the_reference(rule):
    tmk, jmk = FUSIBLE[rule]
    params, grads = _case(2)
    tp, tst = _steps(tmk(), params, grads)
    jopt = jmk()
    jp, jst = dict(params), {}
    for g in grads:
        jp, jst = jopt.functional_apply(
            {n: jnp.asarray(a) for n, a in jp.items()},
            {n: jnp.asarray(a) for n, a in g.items()}, jst,
            jnp.asarray(0.1, jnp.float32))
    for n in params:
        np.testing.assert_allclose(_np(tp[n]), np.asarray(jp[n]),
                                   err_msg=n, **FP32)
        for k, v in jst[n].items():
            np.testing.assert_allclose(_np(tst[n][k]), np.asarray(v,
                                                                  np.float32),
                                       err_msg=f'{n}.{k}', **FP32)


def test_param_updates_round_the_unscaled_gradient_as_the_engine_does():
    """The engine's unscale (spmd_pipeline.py:923-926) rounds g * inv
    back to the gradient's dtype before the update, and the route does
    the same; the bucketed route's prefactor (shard_update) does not.
    Off a power of two the two differ: the fp32 master shows it."""
    opt = topt.SGD(1.0)                     # a bf16 param: an fp32 master
    g = torch.tensor([1.0, 5.0], dtype=torch.bfloat16)
    inv = torch.tensor(1.0 / 3.0)
    p = torch.zeros(2, dtype=torch.bfloat16)
    _p, st = TFO.ParamUpdates(opt, torch.tensor(1.0), prefactor=inv)(
        p, g, {})
    rounded = (g.float() * inv).bfloat16().float()
    assert torch.equal(st['master'], -rounded)
    assert not torch.equal(rounded, g.float() * inv)
    for round_prefactor in (True, False):
        _np_, ns = TFO.fused_shard_update_plain(
            opt, torch.zeros(2, dtype=torch.bfloat16), g, {},
            torch.tensor(1.0), prefactor=inv,
            round_prefactor=round_prefactor)
        assert torch.equal(ns['master'], st['master']) == round_prefactor


def test_param_updates_found_inf_leaves_everything_bit_equal():
    opt = topt.AdamW(0.01, moment_dtype='bfloat16', multi_precision=False)
    p = torch.randn(9).bfloat16()
    st = opt.init_state(p)
    st['moment1'].fill_(0.5)
    before = (p.clone(), {k: v.clone() for k, v in st.items()})
    g = torch.full((9,), float('nan')).bfloat16()
    _p, ns = TFO.ParamUpdates(opt, torch.tensor(0.01),
                              prefactor=torch.tensor(0.5),
                              found_inf=torch.tensor(True))(p, g, st)
    assert torch.equal(p, before[0])
    for k, v in before[1].items():
        assert torch.equal(ns[k], v), k


def test_engine_routes_are_bit_equal():
    """SpmdPipelineEngine's per-parameter update on the fused route
    equals its op chain (`_update_one`), 3 steps of the bench's AdamW
    (bf16 params and moments, no master, 'param' accumulation)."""
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=2, max_seq_len=64, hidden_dropout=0.0,
                         attn_dropout=0.0)
    ids = np.random.RandomState(0).randint(0, 128, (4, 32)).astype('int32')
    data = (ids, np.roll(ids, -1, 1).astype('int32'))
    out = []
    for fused in (True, False):
        triple = tgpt.build_gpt_pipeline(
            cfg, dtype=torch.bfloat16,
            generator=torch.Generator().manual_seed(3))
        opt = topt.AdamW(1e-3, weight_decay=0.01, multi_precision=False,
                         moment_dtype='bfloat16')
        if not fused:
            _chain(opt)
        eng = tsp.SpmdPipelineEngine(*triple, opt, accumulate_steps=2,
                                     grad_accum_dtype='param', device='cpu')
        losses = [float(eng.train_batch(data)) for _ in range(STEPS)]
        out.append((losses, [p.detach().clone() for _, p in eng._named],
                    eng.named_opt_states()))
    (la, pa, sa), (lb, pb, sb) = out
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    for n in sa:
        for k in sa[n]:
            assert torch.equal(sa[n][k], sb[n][k]), (n, k)


def test_the_route_is_chosen_by_rule():
    assert TFO.fusible(topt.AdamW()) and TFO.fusible(topt.SGD())
    for opt in (topt.Lamb(), topt.Lars(), topt.Ftrl(0.1),
                topt.DGCMomentumOptimizer()):
        assert not TFO.fusible(opt)
        with pytest.raises(NotImplementedError, match='fusible'):
            TFO.ParamUpdates(opt, torch.tensor(0.1))


# ---------------------------------------------------------------------------
# the optimizers without a kernel rule
# ---------------------------------------------------------------------------
UNFUSED = {
    'lamb': (lambda: topt.Lamb(0.01, lamb_weight_decay=0.01),
             lambda: paddle.optimizer.Lamb(0.01, lamb_weight_decay=0.01,
                                           parameters=[])),
    'lars': (lambda: topt.Lars(0.1, momentum=0.9, lars_coeff=0.001,
                               lars_weight_decay=0.0005),
             lambda: paddle.optimizer.Lars(0.1, momentum=0.9,
                                           lars_coeff=0.001,
                                           lars_weight_decay=0.0005,
                                           parameters=[])),
    'ftrl': (lambda: topt.Ftrl(0.1, l1=0.01, l2=0.02),
             lambda: paddle.optimizer.Ftrl(0.1, l1=0.01, l2=0.02,
                                           parameters=[])),
    'ftrl_power': (lambda: topt.Ftrl(0.1, l1=0.0, l2=0.0, lr_power=-0.25),
                   lambda: paddle.optimizer.Ftrl(0.1, lr_power=-0.25,
                                                 parameters=[])),
    'dgc': (lambda: topt.DGCMomentumOptimizer(
                0.1, momentum=0.9, rampup_begin_step=1, rampup_step=1,
                sparsity=(0.5, 0.8)),
            lambda: jopt_dgc(0.1, momentum=0.9, rampup_begin_step=1,
                             rampup_step=1, sparsity=(0.5, 0.8))),
    'dgc_nesterov': (lambda: topt.DGCMomentumOptimizer(
                         0.1, momentum=0.9, use_nesterov=True,
                         sparsity=0.75),
                     lambda: jopt_dgc(0.1, momentum=0.9, use_nesterov=True,
                                      sparsity=0.75)),
}


def jopt_dgc(*args, **kw):
    from paddle_tpu.optimizer.optimizer import DGCMomentumOptimizer
    return DGCMomentumOptimizer(*args, parameters=[], **kw)


@pytest.mark.parametrize('name', list(UNFUSED))
def test_unfused_rules_match_the_reference_over_three_steps(name):
    tmk, jmk = UNFUSED[name]
    params, grads = _case(3)
    if name.startswith('ftrl'):
        params = {n: np.abs(a) * 0 for n, a in params.items()}
    tp, tst = _steps(tmk(), params, grads)
    jopt = jmk()
    jp, jst = dict(params), {}
    for g in grads:
        jp, jst = jopt.functional_apply(
            {n: jnp.asarray(a) for n, a in jp.items()},
            {n: jnp.asarray(a) for n, a in g.items()}, jst,
            jnp.asarray(0.1, jnp.float32))
    for n in params:
        np.testing.assert_allclose(_np(tp[n]), np.asarray(jp[n]),
                                   err_msg=n, **FP32)
        assert set(tst[n]) == set(jst[n])
        for k, v in jst[n].items():
            np.testing.assert_allclose(_np(tst[n][k]),
                                       np.asarray(v, np.float32),
                                       err_msg=f'{n}.{k}', **FP32)


@pytest.mark.parametrize('q', [0.0, 0.5, 0.8, 0.999, 1.0])
def test_dgc_quantile_is_jax_linear_quantile(q):
    from paddle_tpu_torch.optimizer.optimizer import _quantile_linear
    a = np.abs(np.random.RandomState(4).randn(1037)).astype(np.float32)
    got = _quantile_linear(_tt(a), torch.tensor(q, dtype=torch.float32))
    want = jnp.quantile(jnp.asarray(a), jnp.asarray(q, jnp.float32))
    assert float(got) == float(want)
    a[5] = np.nan
    assert np.isnan(float(_quantile_linear(_tt(a), torch.tensor(q))))


def test_ftrl_runs_the_bucketed_route_on_its_chain():
    """Ftrl is elementwise, so TrainStep buckets it (as the reference
    does), and it has no kernel rule, so the bucket update is its op
    chain: 2 steps equal the per-parameter route."""
    def model():
        trng.seed(0)   # the layers' default draws
        return torch.nn.Sequential(tnn.Linear(8, 16), torch.nn.Tanh(),
                                   tnn.Linear(16, 4))

    def loss(m, x, y):
        return ((m(x) - y) ** 2).mean()

    x = np.random.RandomState(1).randn(5, 8).astype(np.float32)
    y = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    out = []
    for buckets in (None, False):
        m = model()
        step = tjit.TrainStep(m, loss, topt.Ftrl(0.1, l1=1e-3, l2=1e-3),
                              use_buckets=buckets, device='cpu')
        assert step.use_buckets == (buckets is None)
        losses = [float(step(x, y)) for _ in range(2)]
        out.append((losses, [p.detach().clone() for p in m.parameters()]))
    np.testing.assert_allclose(out[0][0], out[1][0], **FP32)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(_np(a), _np(b), **FP32)


def test_unfused_rules_refuse_what_the_reference_ignores():
    with pytest.raises(NotImplementedError, match='exclude_from_weight'):
        topt.Lamb(exclude_from_weight_decay_fn=lambda n: True)
    with pytest.raises(NotImplementedError, match='exclude_from_weight'):
        topt.Lars(exclude_from_weight_decay=['bias'])


# ---------------------------------------------------------------------------
# regularizers
# ---------------------------------------------------------------------------
REG_CASES = {
    'sgd-l1': (lambda ps: topt.SGD(0.1, parameters=ps),
               lambda ps: paddle.optimizer.SGD(0.1, parameters=ps),
               {'weight': 'l1'}),
    'sgd-l2-and-l1': (lambda ps: topt.SGD(0.1, parameters=ps),
                      lambda ps: paddle.optimizer.SGD(0.1, parameters=ps),
                      {'weight': 'l2', 'bias': 'l1'}),
    'adam-decay-overridden': (
        lambda ps: topt.Adam(0.01, weight_decay=0.05, parameters=ps),
        lambda ps: paddle.optimizer.Adam(0.01, weight_decay=0.05,
                                         parameters=ps),
        {'weight': 'l1'}),
    'adamw-l2': (lambda ps: topt.AdamW(0.01, parameters=ps),
                 lambda ps: paddle.optimizer.AdamW(0.01, parameters=ps),
                 {'weight': 'l2', 'bias': 'l2'}),
    'momentum-l2': (lambda ps: topt.Momentum(0.05, parameters=ps),
                    lambda ps: paddle.optimizer.Momentum(0.05,
                                                         parameters=ps),
                    {'weight': 'l2'}),
    'lamb-l1': (lambda ps: topt.Lamb(0.01, parameters=ps),
                lambda ps: paddle.optimizer.Lamb(0.01, parameters=ps),
                {'bias': 'l1'}),
}


@pytest.mark.parametrize('case', list(REG_CASES))
def test_per_parameter_regularizers_in_eager_step(case):
    """A parameter's own regularizer replaces the optimizer's decay in
    eager step() (optimizer.py:219-227): 3 steps on the same gradients
    against the reference's Linear with `param.regularizer` set."""
    tmk, jmk, regs = REG_CASES[case]
    paddle.seed(4)
    jlin = jnn.Linear(6, 5)
    tlin = tnn.Linear(6, 5)
    with torch.no_grad():
        tlin.weight.copy_(_tt(np.asarray(jlin.weight.data)))
        tlin.bias.copy_(_tt(np.asarray(jlin.bias.data)))
    make = {'l1': (treg.L1Decay(0.02), jreg.L1Decay(0.02)),
            'l2': (treg.L2Decay(0.03), jreg.L2Decay(0.03))}
    for name, kind in regs.items():
        getattr(tlin, name).regularizer = make[kind][0]
        getattr(jlin, name).regularizer = make[kind][1]
    topt_, jopt_ = tmk(list(tlin.parameters())), jmk(jlin.parameters())
    rng = np.random.RandomState(7)
    for _ in range(STEPS):
        for name in ('weight', 'bias'):
            g = rng.randn(*getattr(tlin, name).shape).astype(np.float32)
            getattr(tlin, name).grad = _tt(g)
            getattr(jlin, name).grad = Tensor(jnp.asarray(g))
        topt_.step()
        jopt_.step()
    for name in ('weight', 'bias'):
        np.testing.assert_allclose(_np(getattr(tlin, name)),
                                   np.asarray(getattr(jlin, name).data),
                                   err_msg=name, **FP32)


def test_regularizers_as_weight_decay():
    """An L2Decay is its coefficient; L1Decay is refused, where the
    reference takes it as an L2 coefficient (optimizer.py:45-49)."""
    assert topt.SGD(0.1, weight_decay=treg.L2Decay(0.25))._weight_decay \
        == 0.25
    assert topt.AdamW(0.1, weight_decay=treg.L2Decay(0.25))._coeff == 0.25
    assert paddle.optimizer.SGD(0.1, weight_decay=jreg.L1Decay(0.25),
                                parameters=[])._weight_decay == 0.25
    for make in (lambda: topt.SGD(0.1, weight_decay=treg.L1Decay(0.25)),
                 lambda: topt.AdamW(0.1, weight_decay=treg.L1Decay(0.25))):
        with pytest.raises(NotImplementedError, match='L1Decay'):
            make()
    with pytest.raises(TypeError, match='weight_decay'):
        topt.SGD(0.1, weight_decay='0.1')
    x = np.array([-2.0, 0.0, 3.0], np.float32)
    assert _np(treg.L1Decay(0.5)(_tt(x))).tolist() == \
        np.asarray(jreg.L1Decay(0.5)(jnp.asarray(x))).tolist()
    assert _np(treg.L2Decay(0.5)(_tt(x))).tolist() == \
        np.asarray(jreg.L2Decay(0.5)(jnp.asarray(x))).tolist()
    assert repr(treg.L1Decay(0.5)) == repr(jreg.L1Decay(0.5))


# ---------------------------------------------------------------------------
# softmax_with_cross_entropy
# ---------------------------------------------------------------------------
def _xent_both(logits, label, **kw):
    """(loss, d loss·w / d logits[, softmax]) from both packages."""
    w = np.random.RandomState(9).randn(*logits.shape).astype(np.float32)
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jout = jF.softmax_with_cross_entropy(jx, paddle.to_tensor(label), **kw)
    jloss = jout[0] if isinstance(jout, tuple) else jout
    (jloss * paddle.to_tensor(w[tuple(slice(0, s) for s in
                                       jloss.shape)])).sum().backward()
    tx = _tt(logits).requires_grad_(True)
    tout = tF.softmax_with_cross_entropy(tx, _tt(label), **kw)
    tloss = tout[0] if isinstance(tout, tuple) else tout
    (tloss * _tt(w[tuple(slice(0, s) for s in tloss.shape)])).sum() \
        .backward()
    return jout, tout, np.asarray(jx.grad.numpy()), _np(tx.grad)


XENT = {
    'soft-last': dict(shape=(4, 7), soft=True, axis=-1),
    'soft-axis1': dict(shape=(3, 6, 5), soft=True, axis=1),
    'hard-axis1': dict(shape=(3, 6, 5), soft=False, axis=1),
    'hard-axis0-kept': dict(shape=(6, 4), soft=False, axis=0, kept=True),
    'hard-axis1-ignore': dict(shape=(2, 9, 3), soft=False, axis=1,
                              ignore=True),
}


@pytest.mark.parametrize('return_softmax', [False, True])
@pytest.mark.parametrize('case', list(XENT))
def test_softmax_with_cross_entropy_variants(case, return_softmax):
    c = XENT[case]
    rng = np.random.RandomState(11)
    logits = (3 * rng.randn(*c['shape'])).astype(np.float32)
    axis = c['axis'] % len(c['shape'])
    if c['soft']:
        e = np.exp(rng.randn(*c['shape']))
        label = (e / e.sum(axis, keepdims=True)).astype(np.float32)
    else:
        lead = c['shape'][:axis] + c['shape'][axis + 1:]
        label = rng.randint(0, c['shape'][axis], lead).astype(np.int64)
        if c.get('ignore'):
            label.reshape(-1)[::4] = -100
        if c.get('kept'):
            label = np.expand_dims(label, axis)
    jout, tout, jg, tg = _xent_both(logits, label, soft_label=c['soft'],
                                    axis=c['axis'],
                                    return_softmax=return_softmax)
    if return_softmax:
        (jl, js), (tl, ts) = jout, tout
        np.testing.assert_allclose(_np(ts), np.asarray(js.numpy()), **FP32)
    else:
        jl, tl = jout, tout
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(_np(tl), np.asarray(jl.numpy()), **FP32)
    np.testing.assert_allclose(tg, jg, **FP32)
    if c.get('ignore'):
        flat = np.moveaxis(_np(tl), axis, -1).reshape(-1)
        assert (flat[::4] == 0).all()


def test_softmax_with_cross_entropy_refuses_a_mismatched_label():
    with pytest.raises(ValueError, match='label shape'):
        tF.softmax_with_cross_entropy(torch.zeros(3, 4, 5),
                                      torch.zeros(3, 5, dtype=torch.long),
                                      axis=2)
    with pytest.raises(ValueError, match='soft label'):
        tF.softmax_with_cross_entropy(torch.zeros(3, 4), torch.zeros(3, 1),
                                      soft_label=True)


# ---------------------------------------------------------------------------
# the on-device LR schedule
# ---------------------------------------------------------------------------
def _schedules(m):
    """The schedules device_lr.py traces, built from module `m` (the
    JAX package's lr or the port's)."""
    return {
        'noam': lambda: m.NoamDecay(64, 4, learning_rate=0.5),
        'cosine': lambda: m.CosineAnnealingDecay(0.1, T_max=7,
                                                 eta_min=0.01),
        'poly': lambda: m.PolynomialDecay(0.1, decay_steps=5,
                                          end_lr=0.001, power=2.0),
        'poly_cycle': lambda: m.PolynomialDecay(0.1, decay_steps=4,
                                                end_lr=0.001, power=1.5,
                                                cycle=True),
        'inverse_time': lambda: m.InverseTimeDecay(0.1, gamma=0.3),
        'exponential': lambda: m.ExponentialDecay(0.1, gamma=0.8),
        'natural_exp': lambda: m.NaturalExpDecay(0.1, gamma=0.2),
        'step': lambda: m.StepDecay(0.1, step_size=3, gamma=0.5),
        'multistep': lambda: m.MultiStepDecay(0.1, milestones=[2, 5, 6],
                                              gamma=0.3),
        'warmup_cosine': lambda: m.LinearWarmup(
            m.CosineAnnealingDecay(0.2, T_max=8), warmup_steps=3,
            start_lr=0.0, end_lr=0.2),
        'warmup_constant': lambda: m.LinearWarmup(
            0.05, warmup_steps=4, start_lr=0.01, end_lr=0.05),
    }


@pytest.mark.parametrize('name', list(_schedules(tlr)))
def test_device_lr_matches_the_reference_schedule(name):
    tfn = tdlr.device_lr_fn(_schedules(tlr)[name]())
    jfn = jdlr.device_lr_fn(_schedules(jlr)[name]())
    host = _schedules(tlr)[name]()
    for s in range(12):
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = float(jfn(jnp.asarray(s, jnp.int32)))
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=f'{name} step {s}')
        np.testing.assert_allclose(float(got), host.get_lr(), rtol=1e-5,
                                   atol=1e-9, err_msg=f'{name} host {s}')
        host.step()


def test_device_lr_keeps_the_host_feed_for_host_state():
    class Mine(tlr.CosineAnnealingDecay):
        def get_lr(self):
            return 0.5

    for sched in (tlr.LambdaDecay(0.1, lambda e: 0.9 ** e),
                  tlr.ReduceOnPlateau(0.1), Mine(0.1, T_max=4),
                  tlr.LinearWarmup(tlr.LambdaDecay(0.1, lambda e: 1.0), 2,
                                   0.0, 0.1)):
        assert tdlr.device_lr_fn(sched) is None
    assert float(tdlr.device_lr_fn(0.25)(torch.tensor(3))) == 0.25


def test_resolve_device_lr(monkeypatch):
    monkeypatch.delenv('PTPU_DEVICE_LR', raising=False)
    assert tdlr.resolve_device_lr() is False
    monkeypatch.setenv('PTPU_DEVICE_LR', 'true')
    assert tdlr.resolve_device_lr() is True
    assert tdlr.resolve_device_lr(False) is False


def _tiny_gpt_step(device_lr, sched):
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=2, max_seq_len=64, hidden_dropout=0.0,
                         attn_dropout=0.0)
    m = tgpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    return tjit.TrainStep(
        m, lambda mm, i, lab: tgpt.GPTPretrainingCriterion()(mm(i), lab),
        topt.AdamW(sched, weight_decay=0.01), device='cpu',
        device_lr=device_lr), m


@pytest.mark.parametrize('buckets', [None, False])
def test_train_step_device_lr_follows_the_schedule(buckets):
    """TrainStep(device_lr=True): the lr comes from the step counter on
    the device, the counter starting at the scheduler's epoch; 3 steps
    land where the host feed lands (the lr differs by fp32 rounding)."""
    ids = np.random.RandomState(0).randint(0, 128, (2, 16)).astype('int32')
    labels = np.roll(ids, -1, 1)
    runs = []
    for flag in (True, False):
        sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=6),
                                 2, 0.0, 1e-3)
        step, m = _tiny_gpt_step(flag, sched)
        if not buckets:
            step = tjit.TrainStep(step.model, step.loss_fn, step.optimizer,
                                  use_buckets=False, device='cpu',
                                  device_lr=flag)
        fed = []
        for _ in range(3):
            step(ids, labels)
            fed.append(float(step._lr))
            sched.step()
        assert (step._lr_feed.fn is not None) == flag
        if flag:
            assert int(step._lr_feed.counter) == 3
        runs.append((fed, [p.detach().clone() for p in m.parameters()]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(_np(a), _np(b), **FP32)


def test_engine_device_lr_matches_the_reference_engine():
    """SpmdPipelineEngine(device_lr=True) on a warm-up schedule: 3
    train_batch calls against the JAX engine's, at the fp32 bars."""
    from test_torch_pipeline import (A, _arrays, _batch, _flat, _jax_triple,
                                     _port_triple)
    from paddle_tpu_torch.models import pipeline_params_as_stacked
    je, jb, jh = _jax_triple()
    te, tb, th = _port_triple(_arrays(je, jb, jh))
    jsched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(1e-2, T_max=5), 2,
                              0.0, 1e-2)
    tsched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-2, T_max=5), 2,
                              0.0, 1e-2)
    jeng = jsp.SpmdPipelineEngine(
        je, jb, jh, paddle.optimizer.SGD(jsched, parameters=[]),
        accumulate_steps=A, use_remat=False, device_lr=True)
    teng = tsp.SpmdPipelineEngine(te, tb, th, topt.SGD(tsched),
                                  accumulate_steps=A, use_remat=False,
                                  device_lr=True, device='cpu')
    ids, labels = _batch(64)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jeng.train_batch((Tensor(ids), Tensor(labels)))))
        tl.append(float(teng.train_batch((ids, labels))))
        jsched.step()
        tsched.step()
    jp = _flat(jeng._params)
    jeng.shutdown()
    tp = _flat(pipeline_params_as_stacked(te, tb, th))
    np.testing.assert_allclose(tl, jl, **FP32)
    for n in tp:
        np.testing.assert_allclose(tp[n], np.asarray(jp[n], np.float32),
                                   err_msg=n, **FP32)
    assert int(teng._lr_feed.counter) == STEPS
