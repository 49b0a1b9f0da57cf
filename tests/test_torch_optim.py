"""paddle_tpu_torch's bucketed optimizer, clipping and LR schedules vs
the JAX package.

The same numpy inputs (seeded) go through the port and through the
JAX package:
- `grad_stats_plain` (and the CPU route of `grad_stats`) against the
  Pallas `_stats_kernel` in interpret mode (`FO.grad_stats_pallas`) and
  the jnp route of `core.bucketing.grad_stats`;
- `fused_shard_update_plain` and the in-place CPU route of
  `fused_shard_update` against the Pallas `_update_kernel` in interpret
  mode (`FO.fused_shard_update`) and the jnp op chain of
  `core.bucketing.shard_update` (FLAGS_fused_optimizer off), as
  tests/test_fused_primitives.py:145-204 does;
- `BucketLayout`, the checkpoint conversion, `flat_functional_apply`
  under each clip, the per-parameter `functional_apply` with clipping,
  and every schedule of `optimizer/lr.py`;
- every `_pallas_fusible` rule (SGD, Momentum, Adam, AdamW, Adagrad with
  its initial accumulator, RMSProp plain and centered with momentum,
  Adamax with its beta power over three steps, Adadelta and
  DecayedAdagrad): the fused update above, the bucket state and its
  checkpoint form, the eager `step()` against the reference's, and three
  steps of a tiny GPT through `jit.TrainStep` on both routes against
  `paddle_tpu.jit.TrainStep` (fp32 losses and params at rtol 2e-4 / atol
  2e-5, the bars of tests/test_torch_train.py).

Tolerances: fp32 update outputs at rtol 2e-6 / atol 5e-7 (the reference
test's bar: the same op order, fp32 rounding); bf16 outputs within one
bf16 ulp of the reference's value (the port rounds the same fp32 result
once, so the two may differ only where an fp32 ulp crosses a bf16
rounding boundary); sums of squares at rtol 1e-5 (fp32 summation
order over 7777 terms: blockwise, pairwise or sequential); schedules at
rtol 1e-12 (both are the same float64 host arithmetic).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import bucketing as JB
from paddle_tpu.core import flags
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.ops.pallas import fused_optimizer as JFO
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import bucketing as TB
from paddle_tpu_torch.ops.kernels import fused_optimizer as TFO
from paddle_tpu_torch.optimizer import lr as tlr
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-6, atol=5e-7)
L = 1000


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    flags.set_flags({'FLAGS_fused_optimizer': None})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _close(got, want, bf16, msg=''):
    got, want = _np(got), _np(want)
    if not bf16:
        np.testing.assert_allclose(got, want, err_msg=msg, **FP32)
        return
    bad = np.abs(got - want) > _bf16_ulp(want)
    assert not bad.any(), (msg, got[bad][:5], want[bad][:5])


# ---------------------------------------------------------------------------
# grad_stats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_grad_stats_matches_pallas_body_and_jnp_route(dtype):
    x = np.random.RandomState(0).randn(7777).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = _t(np.asarray(jx, np.float32), getattr(torch, dtype))
    s, c = TFO.grad_stats_plain(tx)
    assert s.dtype == c.dtype == torch.float32 and s.dim() == c.dim() == 0
    ps, pc = JFO.grad_stats_pallas(jx)
    flags.set_flags({'FLAGS_fused_optimizer': False})
    rs, rc = JB.grad_stats(jx)
    for want in (ps, rs):
        np.testing.assert_allclose(float(s), float(want), rtol=1e-5)
    assert float(c) == float(pc) == float(rc) == 0.0
    s2, c2 = TB.grad_stats(tx)                 # the CPU route: plain
    assert float(s2) == float(s) and float(c2) == 0.0


def test_grad_stats_nonfinite_poisons_the_sum_and_counts():
    x = np.random.RandomState(1).randn(7777).astype(np.float32)
    x[7], x[5000] = np.inf, np.nan
    s, c = TFO.grad_stats(_t(x))
    ps, pc = JFO.grad_stats_pallas(jnp.asarray(x))
    assert not np.isfinite(float(s)) and not np.isfinite(float(ps))
    assert float(c) == float(pc) == 2.0


# ---------------------------------------------------------------------------
# the fused shard update
# ---------------------------------------------------------------------------
RULES = {
    'sgd': (lambda: paddle.optimizer.SGD(learning_rate=0.1, parameters=[]),
            lambda **kw: topt.SGD(learning_rate=0.1, **kw)),
    'momentum_wd': (
        lambda: paddle.optimizer.Momentum(learning_rate=0.05,
                                          weight_decay=1e-4, parameters=[]),
        lambda **kw: topt.Momentum(learning_rate=0.05, weight_decay=1e-4,
                                   **kw)),
    'momentum_nesterov': (
        lambda: paddle.optimizer.Momentum(learning_rate=0.05,
                                          use_nesterov=True, parameters=[]),
        lambda **kw: topt.Momentum(learning_rate=0.05, use_nesterov=True,
                                   **kw)),
    'adam_bf16_moments': (
        lambda: paddle.optimizer.Adam(learning_rate=0.01, parameters=[],
                                      moment_dtype='bfloat16'),
        lambda **kw: topt.Adam(learning_rate=0.01, moment_dtype='bfloat16',
                               **kw)),
    'adamw': (
        lambda: paddle.optimizer.AdamW(learning_rate=0.01, weight_decay=0.01,
                                       parameters=[]),
        lambda **kw: topt.AdamW(learning_rate=0.01, weight_decay=0.01,
                                **kw)),
    'adagrad_init': (
        lambda: paddle.optimizer.Adagrad(0.1, parameters=[],
                                         initial_accumulator_value=0.1),
        lambda **kw: topt.Adagrad(0.1, initial_accumulator_value=0.1, **kw)),
    'rmsprop_momentum': (
        lambda: paddle.optimizer.RMSProp(0.01, momentum=0.9, parameters=[]),
        lambda **kw: topt.RMSProp(0.01, momentum=0.9, **kw)),
    'rmsprop_centered': (
        lambda: paddle.optimizer.RMSProp(0.01, momentum=0.9, centered=True,
                                         weight_decay=1e-4, parameters=[]),
        lambda **kw: topt.RMSProp(0.01, momentum=0.9, centered=True,
                                  weight_decay=1e-4, **kw)),
    'adamax': (
        lambda: paddle.optimizer.Adamax(learning_rate=0.01, parameters=[]),
        lambda **kw: topt.Adamax(learning_rate=0.01, **kw)),
    'adadelta': (
        lambda: paddle.optimizer.Adadelta(learning_rate=0.5, parameters=[]),
        lambda **kw: topt.Adadelta(learning_rate=0.5, **kw)),
    'decayed_adagrad': (
        lambda: paddle.optimizer.DecayedAdagrad(0.05, weight_decay=1e-4,
                                                parameters=[]),
        lambda **kw: topt.DecayedAdagrad(0.05, weight_decay=1e-4, **kw)),
}
NEW_RULES = ['adagrad_init', 'rmsprop_momentum', 'rmsprop_centered',
             'adamax', 'adadelta', 'decayed_adagrad']
# (param dtype, master in the state)
STORAGE = [('float32', False), ('float32', True), ('bfloat16', True),
           ('bfloat16', False)]


def _update_case(name, dtype, master, seed=0, nan=False):
    jmk, tmk = RULES[name]
    jopt, topt_ = jmk(), tmk()
    jopt._multi_precision = topt_._multi_precision = master
    assert JFO.fusible(jopt) and TFO.fusible(topt_)
    rng = np.random.RandomState(seed)
    jdt = jnp.dtype(dtype)
    p = jnp.asarray(rng.randn(L), jnp.float32).astype(jdt)
    g = jnp.asarray(rng.randn(L), jnp.float32).astype(jdt)
    if nan:
        g = jnp.full((L,), jnp.nan, jdt)
    jst = {k: jnp.asarray(v) for k, v in jopt.init_state(
        Tensor(jnp.zeros((L,), jnp.float32))).items()}
    # a few steps' worth of state, so the moments are not zero
    for k in jst:
        if k == 'mean_grad':
            # |mean_grad| <= sqrt(mean_square) / 2: centered RMSProp's
            # ms - mg^2 stays >= 3/4 ms, away from the cancellation where
            # an FMA that XLA contracts would decide the last bits
            jst[k] = jnp.asarray(np.sign(rng.randn(L)) * rng.rand(L) * 0.5
                                 * np.sqrt(np.asarray(jst['mean_square'])),
                                 jnp.float32)
        elif jst[k].ndim:
            jst[k] = jnp.asarray(np.abs(rng.randn(L)) * 0.1,
                                 jnp.float32).astype(jst[k].dtype)
        else:
            jst[k] = jnp.asarray(0.9 ** 3 if k == 'beta1_pow'
                                 else 0.999 ** 3, jnp.float32)
    if master:
        jst['master'] = jnp.asarray(p, jnp.float32) + jnp.asarray(
            rng.randn(L) * 1e-3, jnp.float32)
    tdt = getattr(torch, dtype)
    tst = {k: _t(np.asarray(v, np.float32), _tdtype(v))
           for k, v in jst.items()}
    return jopt, topt_, p, g, jst, _t(np.asarray(p, np.float32), tdt), \
        _t(np.asarray(g, np.float32), tdt), tst


def _tdtype(jarr):
    return torch.bfloat16 if jarr.dtype == jnp.bfloat16 else torch.float32


@pytest.mark.parametrize('storage', STORAGE,
                         ids=[f'{d}-{"master" if m else "nomaster"}'
                              for d, m in STORAGE])
@pytest.mark.parametrize('name', list(RULES))
def test_fused_shard_update_matches_pallas_body_and_jnp_chain(name, storage):
    dtype, master = storage
    bf16 = dtype == 'bfloat16'
    jopt, opt, p, g, jst, tp, tg, tst = _update_case(name, dtype, master)
    lr, pref = 0.01, 0.7
    jlr_, jpref = jnp.asarray(lr, jnp.float32), jnp.asarray(pref, jnp.float32)
    tlr_, tpref = torch.tensor(lr), torch.tensor(pref)
    g32 = g.astype(jnp.float32)
    for fi in (None, False):
        jfi = None if fi is None else jnp.asarray(fi)
        tfi = None if fi is None else torch.tensor(fi)
        flags.set_flags({'FLAGS_fused_optimizer': False})
        ref_p, ref_s = JB.shard_update(jopt, p, g32, dict(jst), jlr_,
                                       prefactor=jpref, found_inf=jfi)
        pal_p, pal_s = JFO.fused_shard_update(jopt, p, g32, dict(jst), jlr_,
                                              prefactor=jpref, found_inf=jfi)
        plain_p, plain_s = TFO.fused_shard_update_plain(
            opt, tp, tg, dict(tst), tlr_, prefactor=tpref, found_inf=tfi)
        assert plain_p.dtype == tp.dtype
        assert set(plain_s) == set(ref_s) == set(pal_s)
        # the CPU route of the wrapper: in place, the same values
        ip, ist = tp.clone(), {k: v.clone() for k, v in tst.items()}
        got_p, got_s = TFO.fused_shard_update(opt, ip, tg, ist, tlr_,
                                              prefactor=tpref,
                                              found_inf=tfi)
        assert got_p is ip and torch.equal(ip, plain_p)
        for k, v in plain_s.items():
            assert torch.equal(got_s[k], v), k
            assert got_s[k].dtype == v.dtype, k
            if k in ist and v.dim():
                assert got_s[k] is ist[k], k          # updated in place
        for want_p, want_s in ((ref_p, ref_s), (pal_p, pal_s)):
            _close(plain_p, want_p, bf16, f'{name} param')
            for k in want_s:
                low = bf16 or str(want_s[k].dtype) == 'bfloat16'
                if k == 'master':
                    low = False
                _close(plain_s[k], want_s[k], low, f'{name} state {k}')
                assert str(plain_s[k].dtype).split('.')[-1] == \
                    str(want_s[k].dtype), k


@pytest.mark.parametrize('storage', STORAGE,
                         ids=[f'{d}-{"master" if m else "nomaster"}'
                              for d, m in STORAGE])
@pytest.mark.parametrize('name', ['sgd', 'momentum_nesterov', 'adamw',
                                  'rmsprop_centered', 'adamax'])
def test_found_inf_on_nan_gradients_is_an_exact_noop(name, storage):
    dtype, master = storage
    jopt, opt, p, g, jst, tp, tg, tst = _update_case(name, dtype, master,
                                                     seed=1, nan=True)
    lr, pref = torch.tensor(0.01), torch.tensor(1.0)
    new_p, ns = TFO.fused_shard_update_plain(opt, tp, tg, dict(tst), lr,
                                             prefactor=pref,
                                             found_inf=torch.tensor(True))
    assert torch.equal(new_p, tp)
    for k, v in tst.items():
        assert torch.equal(ns[k], v), k
    # the in-place route leaves every input's bits alone
    ip, ist = tp.clone(), {k: v.clone() for k, v in tst.items()}
    TFO.fused_shard_update(opt, ip, tg, ist, lr, prefactor=pref,
                           found_inf=torch.tensor(True))
    assert torch.equal(ip, tp)
    for k, v in tst.items():
        assert torch.equal(ist[k], v), k
    # the Pallas body agrees
    pal_p, _ = JFO.fused_shard_update(
        jopt, p, g.astype(jnp.float32), dict(jst),
        jnp.asarray(0.01, jnp.float32), prefactor=jnp.asarray(1.0),
        found_inf=jnp.asarray(True))
    np.testing.assert_array_equal(np.asarray(pal_p, np.float32), _np(tp))


def test_fusible_tags():
    for mk in (topt.SGD, topt.Momentum, topt.Adam, topt.AdamW,
               lambda: topt.Adagrad(0.1), lambda: topt.RMSProp(0.1),
               topt.Adamax, topt.Adadelta, lambda: topt.DecayedAdagrad(0.1)):
        assert TFO.fusible(mk()) and TB.elementwise(mk())
    assert not TFO.fusible(topt.Optimizer())
    with pytest.raises(NotImplementedError, match='fusible'):
        TFO.fused_shard_update(topt.Optimizer(), torch.zeros(4),
                               torch.zeros(4), {}, torch.tensor(0.1))


@pytest.mark.parametrize('name', NEW_RULES)
def test_new_rules_keep_a_master_whatever_multi_precision_says(name):
    """The reference's five newer classes take no `multi_precision`: one
    passed lands in **kwargs and a bf16 param still gets an fp32 master.
    The port's classes do the same."""
    jmk, tmk = RULES[name]
    jcls, tcls = type(jmk()), type(tmk())
    jopt = jcls(0.1, parameters=[], multi_precision=False)
    opt = tcls(0.1, multi_precision=False)
    assert jopt._multi_precision is True and opt._multi_precision is True
    p = torch.full((4,), 0.5, dtype=torch.bfloat16)
    _new, st = opt.functional_apply({'w': p}, {'w': torch.ones_like(p)}, {},
                                    torch.tensor(0.1))
    assert st['w']['master'].dtype == torch.float32


def test_adamax_beta_power_over_three_steps():
    """Adamax's beta1_pow rides through the scalar block: three chained
    steps of the in-place CPU route against the jnp chain and the Pallas
    body, each step's power and param."""
    jopt, opt, p, g, jst, tp, tg, tst = _update_case('adamax', 'float32',
                                                     False, seed=2)
    jst['beta1_pow'] = jnp.asarray(1.0, jnp.float32)
    tst['beta1_pow'] = torch.tensor(1.0)
    lr = 0.01
    flags.set_flags({'FLAGS_fused_optimizer': False})
    ref = (p, dict(jst))
    pal = (p, dict(jst))
    for step in range(3):
        ref = JB.shard_update(jopt, ref[0], g, ref[1],
                              jnp.asarray(lr, jnp.float32))
        pal = JFO.fused_shard_update(jopt, pal[0], g, pal[1],
                                     jnp.asarray(lr, jnp.float32))
        _p, tst = TFO.fused_shard_update(opt, tp, tg, tst, torch.tensor(lr))
        want = np.float32(1.0)
        for _ in range(step + 1):
            want = np.float32(want * np.float32(0.9))
        assert tst['beta1_pow'].dim() == 0
        for w in (ref, pal):
            assert float(tst['beta1_pow']) == float(w[1]['beta1_pow']) \
                == float(want)
            _close(tp, w[0], False, f'step {step} param')
            for k in ('moment', 'inf_norm'):
                _close(tst[k], w[1][k], False, f'step {step} {k}')


def _opt_pair(name):
    jmk, tmk = RULES[name]
    return jmk(), tmk()


@pytest.mark.parametrize('name', NEW_RULES)
def test_bucket_state_and_checkpoint_of_the_new_rules(name):
    """init_bucket_state (Adagrad's fill over the padding too, Adamax's
    scalar) and the checkpoint conversion equal the reference's."""
    jopt, opt = _opt_pair(name)
    jl = JB.BucketLayout.build(SHAPES, bucket_bytes=1024, pad_to=8)
    tl = TB.BucketLayout.build(SHAPES, bucket_bytes=1024, pad_to=8)
    rng = np.random.RandomState(7)
    jst, tst = [], []
    for jb, tb in zip(jl.buckets, tl.buckets):
        flat32 = rng.randn(jb.size).astype(np.float32)
        js = JB.init_bucket_state(jopt, jb, flat32)
        ts = TB.init_bucket_state(opt, tb, torch.from_numpy(flat32))
        assert set(ts) == set(js)
        for k in js:
            assert str(ts[k].dtype).split('.')[-1] == str(js[k].dtype), k
            assert tuple(ts[k].shape) == js[k].shape, k
            np.testing.assert_array_equal(_np(ts[k]), js[k], err_msg=k)
            if js[k].ndim and k != 'master':     # a trained state
                js[k] = rng.randn(jb.size).astype(np.float32)
                ts[k] = torch.from_numpy(js[k].copy())
        jst.append(js)
        tst.append(ts)
    jn, tn = JB.flat_states_to_named(jl, jst), TB.flat_states_to_named(tl,
                                                                       tst)
    assert set(jn) == set(tn)
    for n in jn:
        assert set(jn[n]) == set(tn[n])
        for k in jn[n]:
            np.testing.assert_array_equal(_np(tn[n][k]), jn[n][k])
    back = TB.flat_states_to_named(tl, TB.named_states_to_flat(tl, tn, tst))
    for n in tn:
        for k in tn[n]:
            assert torch.equal(back[n][k], tn[n][k]), (n, k)


@pytest.mark.parametrize('name', NEW_RULES)
def test_eager_step_matches_the_reference(name):
    """Three eager `step()` calls on two fp32 params with a global-norm
    clip against the reference's eager step."""
    jmk, tmk = RULES[name]
    rng = np.random.RandomState(8)
    vals = [rng.randn(6, 4).astype(np.float32),
            rng.randn(5).astype(np.float32)]
    jps = [Tensor(jnp.asarray(v)) for v in vals]
    tps = [torch.from_numpy(v.copy()).requires_grad_() for v in vals]
    for t in jps:
        t.stop_gradient = False
    jopt, opt = jmk(), tmk()
    jopt._parameter_list = jps
    jopt._grad_clip = jnn.ClipGradByGlobalNorm(1.0)
    opt._parameter_list = tps
    opt._grad_clip = tnn.ClipGradByGlobalNorm(1.0)
    for _ in range(3):
        for jp_, tp_ in zip(jps, tps):
            gv = rng.randn(*tp_.shape).astype(np.float32)
            jp_.grad = Tensor(jnp.asarray(gv))
            tp_.grad = torch.from_numpy(gv)
        jopt.step()
        opt.step()
    for jp_, tp_ in zip(jps, tps):
        np.testing.assert_allclose(_np(tp_), np.asarray(jp_.data),
                                   rtol=2e-4, atol=2e-5)
    opt.clear_grad()
    assert all(t.grad is None for t in tps)
    with pytest.raises(ValueError, match='parameter list'):
        tmk().step()


# ---------------------------------------------------------------------------
# three TrainStep steps per rule on both routes
# ---------------------------------------------------------------------------
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
               max_seq_len=64, hidden_dropout=0.0, attn_dropout=0.0)
# a learning rate under which each rule lowers the loss in three steps
TRAIN_LR = {'adagrad_init': 1e-2, 'rmsprop_momentum': 1e-3,
            'rmsprop_centered': 1e-3, 'adamax': 2e-3, 'adadelta': 1.0,
            'decayed_adagrad': 1e-3}


def _gpt_loss(crit):
    return lambda model, ids, labels: crit()(model(ids), labels)


@pytest.mark.parametrize('use_buckets', [None, False],
                         ids=['bucketed', 'per_param'])
@pytest.mark.parametrize('name', NEW_RULES)
def test_train_step_with_rule_matches_jax(name, use_buckets):
    from paddle_tpu import jit as jjit
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch import jit as tjit
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.models import load_jax_params
    paddle.seed(21)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT_CFG))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**GPT_CFG))
    load_jax_params(tm, {n: np.asarray(p.data)
                         for n, p in jm.named_parameters()})
    jopt, opt = _opt_pair(name)
    jopt.set_lr(TRAIN_LR[name])
    opt.set_lr(TRAIN_LR[name])
    kw = {} if use_buckets is None else dict(use_buckets=False)
    jstep = jjit.TrainStep(jm, _gpt_loss(jgpt.GPTPretrainingCriterion), jopt,
                           **kw)
    tstep = tjit.TrainStep(tm, _gpt_loss(tgpt.GPTPretrainingCriterion), opt,
                           device='cpu', **kw)
    assert tstep.use_buckets == (use_buckets is None) == jstep._use_buckets
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 128, (2, 32)).astype(np.int32)
    labels = np.roll(ids, -1, 1)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(labels)).numpy()))
        tl.append(float(tstep(ids, labels)))
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=2e-4, atol=2e-5)
    jp = {n: np.asarray(a, np.float32) for n, a in jstep._params.items()}
    if name != 'adamax':
        for n, p_ in tm.named_parameters():
            np.testing.assert_allclose(_np(p_), jp[n], rtol=2e-4, atol=2e-5,
                                       err_msg=n)
        return
    # Adamax divides each gradient by its own running magnitude: an
    # element whose gradient is rounding noise moves by up to lr a step in
    # a direction the noise picks (test_torch_train.py's Adam bars)
    close = total = 0
    for n, p_ in tm.named_parameters():
        np.testing.assert_allclose(_np(p_), jp[n], rtol=0,
                                   atol=2 * TRAIN_LR[name] * 3, err_msg=n)
        close += int((np.abs(_np(p_) - jp[n]) <= 1e-5).sum())
        total += p_.numel()
    assert close / total >= 0.999


# ---------------------------------------------------------------------------
# the layout and the checkpoint contract
# ---------------------------------------------------------------------------
SHAPES = {'emb': ((50, 8), 'float32'), 'w1': ((8, 16), 'float32'),
          'b1': ((16,), 'float32'), 'ln': ((8,), 'bfloat16'),
          'big': ((300,), 'float32'), 'w2': ((16, 3), 'bfloat16'),
          's': ((), 'float32'), 'b2': ((3,), 'float32')}


def _group(name, shape, dtype):
    return 'embed' if name == 'emb' else 'rest'


@pytest.mark.parametrize('group_fn', [None, _group], ids=['flat', 'grouped'])
@pytest.mark.parametrize('pad_to', [1, 8])
def test_layout_describe_equals_the_reference(pad_to, group_fn):
    # a 1 KiB cap: 'big' (1200 bytes) is larger than the cap
    jl = JB.BucketLayout.build(SHAPES, bucket_bytes=1024, pad_to=pad_to,
                               group_fn=group_fn)
    tl = TB.BucketLayout.build(SHAPES, bucket_bytes=1024, pad_to=pad_to,
                               group_fn=group_fn)
    assert tl.describe() == jl.describe()
    assert tl.names() == jl.names()
    assert tl.total_elements() == jl.total_elements()
    assert tl.total_padded() == jl.total_padded()
    assert tl.nbytes() == jl.nbytes()
    assert any(len(b.slots) == 1 and b.slots[0].name == 'big'
               for b in tl.buckets)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {n: np.asarray(rng.randn(*s), np.float32) for n, (s, _d) in
            SHAPES.items()}


def test_flatten_unflatten_round_trip():
    tl = TB.BucketLayout.build(SHAPES, bucket_bytes=1024, pad_to=8)
    tree = {n: _t(a, getattr(torch, SHAPES[n][1]))
            for n, a in _tree(0).items()}
    flats = tl.flatten(tree)
    jl = JB.BucketLayout.build(SHAPES, bucket_bytes=1024, pad_to=8)
    jflats = jl.flatten({n: jnp.asarray(_np(a), SHAPES[n][1])
                         for n, a in tree.items()})
    for f, jf in zip(flats, jflats):
        assert f.dtype == getattr(torch, str(jf.dtype))
        np.testing.assert_array_equal(_np(f), np.asarray(jf, np.float32))
    back = tl.unflatten(flats)
    for n, a in tree.items():
        assert back[n].shape == a.shape and torch.equal(back[n], a)
        # views: writing the bucket moves the param
        flats[tl.slots[n].bucket][tl.slots[n].offset] += 1
        assert not torch.equal(back[n], a)


def test_flat_states_to_named_and_back_equal_the_reference():
    jl = JB.BucketLayout.build(SHAPES, bucket_bytes=1024, pad_to=8)
    tl = TB.BucketLayout.build(SHAPES, bucket_bytes=1024, pad_to=8)
    jopt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=[])
    opt = topt.AdamW(learning_rate=0.01)
    rng = np.random.RandomState(3)
    jst, tst = [], []
    for jb, tb in zip(jl.buckets, tl.buckets):
        flat32 = rng.randn(jb.size).astype(np.float32)
        s = JB.init_bucket_state(jopt, jb, flat32)
        s['moment1'] = rng.randn(jb.size).astype(np.float32)
        s['beta1_pow'] = np.asarray(0.729, np.float32)
        jst.append(s)
        t = TB.init_bucket_state(opt, tb, torch.from_numpy(flat32))
        assert set(t) == set(s)
        t['moment1'] = torch.from_numpy(s['moment1'].copy())
        t['beta1_pow'] = torch.tensor(0.729)
        tst.append(t)
    jn = JB.flat_states_to_named(jl, jst)
    tn = TB.flat_states_to_named(tl, tst)
    assert set(jn) == set(tn)
    for n in jn:
        assert set(jn[n]) == set(tn[n])
        for k in jn[n]:
            assert tuple(tn[n][k].shape) == jn[n][k].shape, (n, k)
            np.testing.assert_array_equal(_np(tn[n][k]),
                                          np.asarray(jn[n][k], np.float32))
    # back to flat over a zero template: every slot comes back, the
    # padding keeps the template's zeros
    back = TB.named_states_to_flat(tl, tn, [
        {k: torch.zeros_like(v) for k, v in t.items()} for t in tst])
    again = TB.flat_states_to_named(tl, back)
    for n in tn:
        for k in tn[n]:
            assert torch.equal(again[n][k], tn[n][k]), (n, k)
    for b, flat in zip(tl.buckets, back):
        assert not flat['moment1'][b.used:].any()


# ---------------------------------------------------------------------------
# flat_functional_apply and functional_apply under each clip
# ---------------------------------------------------------------------------
CLIPS = {
    'global_norm': (lambda: jnn.ClipGradByGlobalNorm(1.0),
                    lambda: tnn.ClipGradByGlobalNorm(1.0)),
    'norm': (lambda: jnn.ClipGradByNorm(0.5), lambda: tnn.ClipGradByNorm(0.5)),
    'value': (lambda: jnn.ClipGradByValue(0.3),
              lambda: tnn.ClipGradByValue(0.3)),
}
MODEL = {'a.w': ((6, 10), 'float32'), 'a.b': ((10,), 'float32'),
         'c.w': ((10, 4), 'bfloat16'), 'c.b': ((4,), 'bfloat16'),
         'd.w': ((33,), 'float32')}


def _model_case(seed):
    rng = np.random.RandomState(seed)
    params, grads = {}, {}
    for n, (s, d) in MODEL.items():
        params[n] = jnp.asarray(rng.randn(*s), jnp.float32).astype(d)
        grads[n] = jnp.asarray(rng.randn(*s), jnp.float32).astype(d)
    return params, grads


def _tt(a):
    return _t(np.asarray(a, np.float32),
              torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize('clip', list(CLIPS))
def test_flat_functional_apply_matches_the_reference(clip):
    jclip, tclip = CLIPS[clip]
    kw = dict(learning_rate=0.01, weight_decay=0.01, multi_precision=False,
              moment_dtype='bfloat16')
    jopt = paddle.optimizer.AdamW(parameters=[], grad_clip=jclip(), **kw)
    opt = topt.AdamW(grad_clip=tclip(), **kw)
    params, grads = _model_case(4)
    # a 200-byte cap: several buckets of each dtype
    jl = JB.BucketLayout.build({n: (a.shape, a.dtype)
                                for n, a in params.items()},
                               bucket_bytes=200, pad_to=8)
    tl = TB.BucketLayout.build({n: (tuple(a.shape), str(a.dtype))
                                for n, a in params.items()},
                               bucket_bytes=200, pad_to=8)
    assert tl.describe() == jl.describe()
    jst = [{k: jnp.asarray(v) for k, v in JB.init_bucket_state(
        jopt, b, np.asarray(f, np.float32)).items()}
        for b, f in zip(jl.buckets, jl.flatten(params, cast=jnp.float32))]
    flags.set_flags({'FLAGS_fused_optimizer': False})
    lr = jnp.asarray(0.01, jnp.float32)
    new_params, new_states = JB.flat_functional_apply(
        jopt, jl, params, grads, jst, lr)
    tparams = {n: _tt(a) for n, a in params.items()}
    tgrads = {n: _tt(a) for n, a in grads.items()}
    flat_p, flat_g = tl.flatten(tparams), tl.flatten(tgrads)
    tst = [TB.init_bucket_state(opt, b, f.float())
           for b, f in zip(tl.buckets, flat_p)]
    tst, factor = TB.flat_functional_apply(opt, tl, flat_p, flat_g, tst,
                                           torch.tensor(0.01))
    assert (factor is not None) == (clip == 'global_norm')
    got = tl.unflatten(flat_p)
    for n in params:
        assert got[n].dtype == tparams[n].dtype
        _close(got[n], new_params[n], params[n].dtype == jnp.bfloat16, n)
    jn = JB.flat_states_to_named(jl, [{k: np.asarray(v) for k, v in s.items()}
                                      for s in new_states])
    tn = TB.flat_states_to_named(tl, tst)
    for n in jn:
        for k in jn[n]:
            _close(tn[n][k], jn[n][k], jn[n][k].dtype != np.float32,
                   f'{n} {k}')


@pytest.mark.parametrize('clip', list(CLIPS))
def test_per_parameter_functional_apply_clips_as_the_reference(clip):
    jclip, tclip = CLIPS[clip]
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[],
                                grad_clip=jclip(), multi_precision=False)
    opt = topt.SGD(learning_rate=0.1, grad_clip=tclip(),
                   multi_precision=False)
    params, grads = _model_case(5)
    lr = 0.1
    jp, _ = jopt.functional_apply(params, grads, {n: {} for n in params},
                                  jnp.asarray(lr, jnp.float32))
    tp, _ = opt.functional_apply({n: _tt(a) for n, a in params.items()},
                                 {n: _tt(a) for n, a in grads.items()},
                                 {n: {} for n in params}, torch.tensor(lr))
    for n in params:
        assert tp[n].dtype == _tt(params[n]).dtype
        _close(tp[n], jp[n], params[n].dtype == jnp.bfloat16, n)


def test_global_clip_scales_a_bf16_gradient_in_bf16():
    """:117-118 casts the global factor to the gradient's dtype before
    the multiply: the clipped bf16 gradient is bf16(g * bf16(factor))."""
    g = {'w': torch.tensor([3.0, 4.0], dtype=torch.bfloat16)}
    opt = topt.SGD(learning_rate=1.0, grad_clip=tnn.ClipGradByGlobalNorm(
        0.7), multi_precision=False)
    clipped = opt._clip(g)['w']
    factor = torch.tensor(0.7) / torch.tensor(5.0)
    assert clipped.dtype == torch.bfloat16
    assert torch.equal(clipped, g['w'] * factor.to(torch.bfloat16))
    jopt = paddle.optimizer.SGD(learning_rate=1.0, parameters=[],
                                multi_precision=False,
                                grad_clip=jnn.ClipGradByGlobalNorm(0.7))
    jp, _ = jopt.functional_apply(
        {'w': jnp.zeros(2, jnp.bfloat16)},
        {'w': jnp.asarray([3.0, 4.0], jnp.bfloat16)}, {'w': {}},
        jnp.asarray(1.0, jnp.float32))
    np.testing.assert_array_equal(_np(-clipped), np.asarray(jp['w'],
                                                           np.float32))


def test_eager_clip_calls_match_the_reference():
    rng = np.random.RandomState(6)
    gs = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    for name, (jmk, tmk) in CLIPS.items():
        jout = jmk()([(None, Tensor(jnp.asarray(g))) for g in gs])
        tout = tmk()([(None, torch.from_numpy(g)) for g in gs])
        for (_p, jg), (_q, tg) in zip(jout, tout):
            np.testing.assert_allclose(_np(tg), np.asarray(jg.data),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------
SCHEDULES = {
    'noam': lambda m: m.NoamDecay(d_model=64, warmup_steps=10),
    'piecewise': lambda m: m.PiecewiseDecay([5, 20], [0.1, 0.05, 0.01]),
    'natural_exp': lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    'inverse_time': lambda m: m.InverseTimeDecay(0.1, gamma=0.1),
    'polynomial': lambda m: m.PolynomialDecay(0.1, decay_steps=30,
                                              end_lr=0.001, power=2.0),
    'polynomial_cycle': lambda m: m.PolynomialDecay(0.1, decay_steps=7,
                                                    cycle=True),
    'warmup_cosine': lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(2e-4, T_max=50), warmup_steps=5,
        start_lr=0.0, end_lr=2e-4),
    'warmup_const': lambda m: m.LinearWarmup(0.1, warmup_steps=4,
                                             start_lr=0.01, end_lr=0.1),
    'exponential': lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    'multistep': lambda m: m.MultiStepDecay(0.1, milestones=[10, 25]),
    'step': lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    'lambda': lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    'multiplicative': lambda m: m.MultiplicativeDecay(0.1, lambda e: 0.97),
    'cosine': lambda m: m.CosineAnnealingDecay(0.1, T_max=20, eta_min=0.001),
    'one_cycle': lambda m: m.OneCycleLR(0.1, total_steps=50),
    'cyclic': lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                   mode='triangular2'),
}


@pytest.mark.parametrize('name', list(SCHEDULES))
def test_schedule_matches_the_reference_over_60_steps(name):
    js, ts = SCHEDULES[name](jlr), SCHEDULES[name](tlr)
    jv, tv = [], []
    for _ in range(60):
        jv.append(js())
        tv.append(ts())
        js.step()
        ts.step()
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)
    assert ts.state_dict() == js.state_dict()


def test_reduce_on_plateau_matches_the_reference():
    js = jlr.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    ts = tlr.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    for m in [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9]:
        js.step(m)
        ts.step(torch.tensor(m))
        assert math.isclose(ts(), js(), rel_tol=1e-12)


def test_optimizer_reads_a_schedule():
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(2e-4, T_max=10), 2,
                             0.0, 2e-4)
    opt = topt.AdamW(learning_rate=sched)
    seen = []
    for _ in range(4):
        seen.append(opt.get_lr())
        sched.step()
    assert seen[:3] == [0.0, 1e-4, 2e-4] and seen[3] < 2e-4
    with pytest.raises(RuntimeError, match='LRScheduler'):
        opt.set_lr(0.1)
