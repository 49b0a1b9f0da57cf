"""paddle_tpu_torch.amp against `paddle_tpu.amp`: auto_cast op by op and
on a GPT, GradScaler's API and eager step, decorate, and the pipeline
engine's loss-scaling path against the JAX engine's.

Tolerances:
- auto_cast: each op's output dtype equal to the reference's; values of
  a cast op within one bf16 rounding (rtol 2^-7) of the reference's.
- a 2-layer GPT (vocab 128, hidden 64, dropout 0, bridged weights)
  under O1 and O2: the loss within rtol 2^-7 (it is a bf16 mean, one
  bf16 rounding apart at most), each parameter's gradient within a
  relative L2 error of 2e-2 of the reference's (the cast products
  round their bf16 outputs at the two frameworks' own summation
  orders: measured below 5e-3).
- the eager scaler step and the engine: the fp32 bars, rtol 2e-4 /
  atol 2e-5; AdamW with bf16 params at `_check_bf16_update`'s bars
  (tests/test_torch_train.py). A loss scale of 2^10 leaves the port's
  steps bit-equal to its unscaled ones (a power of two scales every
  gradient exactly, and the unscale rounds it back exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.fleet.meta_parallel import spmd_pipeline as jsp
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import math as jM
from paddle_tpu.ops import nn_ops as jF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    spmd_pipeline as tsp)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import (load_jax_params,
                                     pipeline_params_as_stacked)
from paddle_tpu_torch.ops import nn_ops as tF
from test_torch_pipeline import (A, _arrays, _batch, _flat, _jax_states,
                                 _jax_triple, _optimizers, _port_triple)
from test_torch_train import _check_bf16_update
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2.0 ** -7, atol=0)
STEPS = 3


def _tt(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _dt(x):
    """A dtype's name, for either package."""
    if isinstance(x, torch.dtype):
        return str(x).replace('torch.', '')
    return jnp.dtype(x).name


# (reference op, port op) on one or two tensors
OPS = {
    'matmul': (lambda a, b: jM.matmul(a, b), lambda a, b: a @ b),
    'matmul_fn': (lambda a, b: jM.matmul(a, b),
                  lambda a, b: torch.matmul(a, b)),
    'add': (lambda a, b: a + b, lambda a, b: a + b),
    'add_scalar': (lambda a, b: a + 2.0, lambda a, b: a + 2.0),
    'sub': (lambda a, b: jM.subtract(a, b), lambda a, b: a - b),
    'mul': (lambda a, b: a * b, lambda a, b: torch.mul(a, b)),
    'div': (lambda a, b: a / b, lambda a, b: a / b),
    'maximum': (lambda a, b: jM.maximum(a, b),
                lambda a, b: torch.maximum(a, b)),
    'pow': (lambda a, b: a ** 2.0, lambda a, b: a ** 2.0),
    'exp': (lambda a, b: jM.exp(a), lambda a, b: torch.exp(a)),
    'log': (lambda a, b: jM.log(jM.abs(a)),
            lambda a, b: torch.log(torch.abs(a))),
    'square': (lambda a, b: jM.square(a), lambda a, b: a.square()),
    'tanh': (lambda a, b: jM.tanh(a), lambda a, b: torch.tanh(a)),
    'sigmoid': (lambda a, b: jM.sigmoid(a), lambda a, b: torch.sigmoid(a)),
    'neg': (lambda a, b: -a, lambda a, b: -a),
    'clip': (lambda a, b: jM.clip(a, -0.5, 0.5),
             lambda a, b: torch.clamp(a, -0.5, 0.5)),
    # run_op in the reference: never cast
    'linear': (lambda a, b: jF.linear(a, b), lambda a, b: tF.linear(a, b)),
    'layer_norm': (lambda a, b: jF.layer_norm(a, [a.shape[-1]]),
                   lambda a, b: tF.layer_norm(a, [a.shape[-1]])),
    'reduce_mean': (lambda a, b: jM.mean(a), lambda a, b: a.mean()),
    'softmax_with_cross_entropy': (
        lambda a, b: jF.softmax_with_cross_entropy(
            a, jM.clip(jM.abs(b), 0.0, 1.0), soft_label=True),
        lambda a, b: tF.softmax_with_cross_entropy(
            a, torch.clamp(torch.abs(b), 0.0, 1.0), soft_label=True)),
}
# the input dtypes: (a, b)
INPUTS = {'fp32': ('float32', 'float32'), 'bf16': ('bfloat16', 'bfloat16'),
          'mixed': ('bfloat16', 'float32')}
SETTINGS = {
    'O1': dict(level='O1'), 'O2': dict(level='O2'),
    'O1-white-add': dict(level='O1', custom_white_list={'elementwise_add'}),
    'O2-black-matmul': dict(level='O2', custom_black_list={'matmul_v2',
                                                           'tanh'}),
    'O1-fp16': dict(level='O1', dtype='float16'),
    'off': dict(enable=False, level='O2'),
}


def _operands(kind, square=False):
    rng = np.random.RandomState(3)
    a = rng.randn(4, 4).astype(np.float32)
    b = (rng.randn(4, 4) + 3).astype(np.float32)
    da, db = INPUTS[kind]
    return ((paddle.to_tensor(a).astype(da), paddle.to_tensor(b).astype(db)),
            (_tt(a).to(getattr(torch, da)), _tt(b).to(getattr(torch, db))))


@pytest.mark.parametrize('setting', list(SETTINGS))
@pytest.mark.parametrize('inputs', list(INPUTS))
def test_auto_cast_op_by_op(setting, inputs):
    """Each op's output dtype under auto_cast equals the reference's: the
    white-listed product cast down, the black-listed ops up to fp32, the
    rest following their inputs (O1) or cast down (O2), the ops the
    reference runs through run_op never cast; values within one bf16
    rounding where the dtypes are low."""
    kw = SETTINGS[setting]
    (ja, jb), (ta, tb) = _operands(inputs)
    for name, (jop, top) in OPS.items():
        if inputs == 'mixed' and (name in ('linear', 'layer_norm') or (
                setting == 'off' and name.startswith('matmul'))):
            continue        # torch's products take one dtype, jnp promotes
        with jamp.auto_cast(**kw):
            jout = jop(ja, jb)
        with tamp.auto_cast(**kw):
            tout = top(ta, tb)
        assert _dt(tout.dtype) == _dt(jout.data.dtype), (name, setting)
        np.testing.assert_allclose(_np(tout), np.asarray(
            jout.data.astype(jnp.float32)), rtol=2.0 ** -6, atol=1e-6,
            err_msg=name)


def test_auto_cast_restores_the_state_and_nests():
    st = tamp.amp_state()
    assert not st.enabled
    a = torch.ones(2, 2)
    with tamp.auto_cast(level='O2'):
        assert (a + a).dtype == torch.bfloat16
        with tamp.auto_cast(enable=False):
            assert (a + a).dtype == torch.float32
        with tamp.auto_cast(level='O1', custom_black_list={'matmul_v2'}):
            assert (a @ a).dtype == torch.float32
        assert (a @ a).dtype == torch.bfloat16
    assert not st.enabled and (a @ a).dtype == torch.float32
    assert tamp.amp_guard is tamp.auto_cast
    assert tamp.WHITE_LIST == jamp.WHITE_LIST
    assert tamp.BLACK_LIST == jamp.BLACK_LIST
    with pytest.raises(ValueError, match='dtype'):
        with tamp.auto_cast(dtype='int8'):
            pass


def _gpt_pair(seed=21):
    cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
               max_seq_len=64, hidden_dropout=0.0, attn_dropout=0.0,
               use_flash_attention=True)
    paddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
    load_jax_params(tm, {n: np.asarray(p.data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize('level', ['O1', 'O2'])
def test_gpt_under_auto_cast_matches_the_reference(level):
    jm, tm = _gpt_pair()
    ids = np.random.RandomState(5).randint(0, 128, (2, 32)).astype('int32')
    labels = np.roll(ids, -1, 1)
    with jamp.auto_cast(level=level):
        jlogits = jm(paddle.to_tensor(ids))
        jloss = jgpt.GPTPretrainingCriterion()(jlogits,
                                               paddle.to_tensor(labels))
    jloss.backward()
    with tamp.auto_cast(level=level):
        tlogits = tm(_tt(ids))
        tloss = tgpt.GPTPretrainingCriterion()(tlogits, _tt(labels))
    tloss.backward()
    # the tied head's product is white-listed: bf16 logits and loss
    assert _dt(tlogits.dtype) == _dt(jlogits.data.dtype) == 'bfloat16'
    assert _dt(tloss.dtype) == _dt(jloss.data.dtype)
    np.testing.assert_allclose(float(tloss.float()), float(
        jloss.data.astype(jnp.float32)), **BF16)
    jgrads = {n: np.asarray(p.grad.data, np.float32)
              for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32
        assert _rel_l2(_np(p.grad), jgrads[n]) < 2e-2, n


def test_decorate():
    jm, tm = _gpt_pair()
    assert tamp.decorate(tm, level='O1') is tm
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    opt = topt.AdamW(parameters=tm.parameters())
    out_m, out_o = tamp.decorate(tm, opt, level='O2')
    assert out_m is tm and out_o is opt
    jamp.decorate(jm, level='O2')
    for (n, p), (_, q) in zip(tm.named_parameters(), jm.named_parameters()):
        assert _dt(p.dtype) == _dt(q.data.dtype) == 'bfloat16', n
    assert tamp.decorate(None) is None
    with pytest.raises(ValueError, match='level'):
        tamp.decorate(tm, level='O3')


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------
def test_grad_scaler_schedule_and_state_match_the_reference():
    kw = dict(init_loss_scaling=2.0 ** 10, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    found = [False, False, False, True, True, False, True, False, False,
             False, True, True, True, True]
    for f in found:
        js.update_from_found(f)
        ts.update_from_found(f)
        assert ts.state_dict() == js.state_dict()
    sd = ts.state_dict()
    assert sd['incr_count'] == sd['good_steps'] and 'decr_count' in sd
    for s in (js, ts):
        assert s.is_enable() and s.is_use_dynamic_loss_scaling()
        s.set_init_loss_scaling(64.0)
        assert s.get_init_loss_scaling() == 64.0
    # incr_count / decr_count win over the aliases; 'enable' is not
    # restored
    sd = dict(sd, incr_count=2, good_steps=9, decr_count=1, enable=False)
    js.set_state_dict(sd)
    ts.load_state_dict(sd)
    assert ts.state_dict() == js.state_dict() and ts.is_enable()
    old = tamp.GradScaler()
    old.set_state_dict({'scale': 8.0, 'good_steps': 4, 'bad_steps': 1})
    assert (old._scale, old._good_steps, old._bad_steps) == (8.0, 4, 1)
    off = tamp.GradScaler(enable=False)
    x = torch.ones(2)
    assert off.scale(x) is x
    off.update_from_found(True)
    assert off._scale == 2.0 ** 15 and not off.is_enable()
    fixed = tamp.GradScaler(use_dynamic_loss_scaling=False)
    fixed.update_from_found(True)
    fixed.update_from_found(True)
    assert fixed._scale == 2.0 ** 15


def _linear_pair(seed=0):
    paddle.seed(seed)
    jl = jnn.Linear(5, 3)
    tl = tnn.Linear(5, 3)
    with torch.no_grad():
        tl.weight.copy_(_tt(np.asarray(jl.weight.data)))
        tl.bias.copy_(_tt(np.asarray(jl.bias.data)))
    return jl, tl


@pytest.mark.parametrize('bad', [None, 'inf', 'nan'])
def test_eager_scaler_step_matches_the_reference(bad):
    """scale(loss).backward(); scaler.step(opt) for 3 steps: unscale_,
    the found-inf skip and the dynamic schedule, against the
    reference's; a nonfinite input at step 1 skips that step."""
    jl, tl = _linear_pair()
    kw = dict(init_loss_scaling=2.0 ** 8, decr_every_n_nan_or_inf=1)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jopt = paddle.optimizer.Adam(0.01, parameters=jl.parameters())
    topt_ = topt.Adam(0.01, parameters=list(tl.parameters()))
    rng = np.random.RandomState(1)
    for step in range(STEPS):
        x = rng.randn(4, 5).astype(np.float32)
        if step == 1 and bad:
            x[0, 0] = float(bad)
        y = rng.randn(4, 3).astype(np.float32)
        jloss = ((jl(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2) \
            .mean()
        js.scale(jloss).backward()
        js.minimize(jopt, jloss)
        jopt.clear_grad()
        tloss = ((tl(_tt(x)) - _tt(y)) ** 2).mean()
        ts.scale(tloss).backward()
        ts.minimize(topt_, tloss)
        topt_.clear_grad()
        assert ts._found_inf == js._found_inf == (step == 1 and
                                                  bad is not None)
        assert ts.state_dict() == js.state_dict()
    for name in ('weight', 'bias'):
        np.testing.assert_allclose(_np(getattr(tl, name)), np.asarray(
            getattr(jl, name).data), err_msg=name, **FP32)


def test_unscale_rounds_each_gradient_back_to_its_dtype():
    p = torch.nn.Parameter(torch.zeros(3, dtype=torch.bfloat16))
    p.grad = torch.tensor([1.0, 5.0, 7.0], dtype=torch.bfloat16)
    s = tamp.GradScaler(init_loss_scaling=3.0)
    s.unscale_(topt.SGD(0.1, parameters=[p]))
    assert p.grad.dtype == torch.bfloat16 and not s._found_inf
    want = (torch.tensor([1.0, 5.0, 7.0]) * (1.0 / 3.0)).bfloat16()
    assert torch.equal(p.grad, want)
    s.unscale_(topt.SGD(0.1, parameters=[p]))      # once a step
    assert torch.equal(p.grad, want)


# ---------------------------------------------------------------------------
# the pipeline engine's loss-scaling path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('kind', ['sgd', 'adamw_bf16'])
def test_engine_scaled_steps_match_the_jax_engine(kind):
    """3 train_batch calls at scale=1024 on bridged weights: at the
    existing bars of test_engine_matches_jax_engine against the JAX
    engine, and bit-equal to the port's own unscaled steps."""
    bf16 = kind == 'adamw_bf16'
    accum = 'param'
    je, jb, jh = _jax_triple(bf16=bf16)
    arrays = _arrays(je, jb, jh)
    jopt, _ = _optimizers(kind)
    jeng = jsp.SpmdPipelineEngine(je, jb, jh, jopt, accumulate_steps=A,
                                  use_remat=True, schedule='1F1B',
                                  grad_accum_dtype=accum)
    ids, labels = _batch(64)
    runs = {}
    for scale in (1024.0, None):
        te, tb, th = _port_triple(arrays, torch.bfloat16 if bf16 else None)
        teng = tsp.SpmdPipelineEngine(te, tb, th, _optimizers(kind)[1],
                                      accumulate_steps=A, use_remat=True,
                                      schedule='1F1B',
                                      grad_accum_dtype=accum, device='cpu')
        losses = []
        for _ in range(STEPS):
            losses.append(float(teng.train_batch((ids, labels),
                                                  scale=scale)))
            if scale is not None:
                assert not bool(teng.last_found_inf)
        runs[scale] = (losses, _flat(pipeline_params_as_stacked(te, tb, th)),
                       teng.named_opt_states())
    tl, tp, tstates = runs[1024.0]
    ul, up, _ = runs[None]
    assert tl == ul
    for n in tp:
        assert np.array_equal(tp[n], up[n]), n
    jl = [float(jeng.train_batch((Tensor(ids), Tensor(labels)),
                                 scale=1024.0)) for _ in range(STEPS)]
    assert not bool(np.asarray(jeng.last_found_inf))
    jp = {k: np.asarray(v, np.float32)
          for k, v in _flat(jeng._params).items()}
    jstates = _jax_states(jeng)
    jeng.shutdown()
    if not bf16:
        np.testing.assert_allclose(tl, jl, **FP32)
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **FP32)
        return
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8)
    before = _flat({'embed': arrays['embed'], 'head': arrays['head'],
                    'blocks': {n: np.stack([b[n] for b in arrays['blocks']])
                               for n in arrays['blocks'][0]}})
    _check_bf16_update(jp, tp, before, jstates, tstates)


@pytest.mark.parametrize('kind', ['sgd', 'adamw_bf16'])
def test_engine_inf_scale_skips_the_update(kind):
    """Mirrors tests/test_pipeline_schedule.py:273-289: a scale of inf
    trips found_inf and every parameter and state stays bit-equal."""
    bf16 = kind == 'adamw_bf16'
    je, jb, jh = _jax_triple(bf16=bf16)
    te, tb, th = _port_triple(_arrays(je, jb, jh),
                              torch.bfloat16 if bf16 else None)
    eng = tsp.SpmdPipelineEngine(te, tb, th, _optimizers(kind)[1],
                                 accumulate_steps=A, device='cpu')
    ids, labels = _batch(64)
    eng.train_batch((ids, labels))
    before = [p.detach().clone() for _, p in eng._named]
    states = eng.named_opt_states()
    loss = eng.train_batch((ids, labels), scale=float('inf'))
    assert torch.isfinite(loss)
    assert eng.last_found_inf.dtype == torch.bool
    assert bool(eng.last_found_inf)
    for b, (n, p) in zip(before, eng._named):
        assert torch.equal(b, p), n
    after = eng.named_opt_states()
    for n in states:
        for k in states[n]:
            assert torch.equal(states[n][k], after[n][k]), (n, k)
    # the next unscaled step updates again, and reports no overflow
    eng.train_batch((ids, labels))
    assert not bool(eng.last_found_inf)
    assert not all(torch.equal(b, p) for b, (_, p) in zip(before,
                                                          eng._named))


class _Emb(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = tnn.Linear(4, 8)

    def forward(self, x):
        return self.lin(x)


class _Blk(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = tnn.Linear(8, 8)

    def forward(self, x):
        return torch.relu(self.lin(x)) + x


class _Head(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = tnn.Linear(8, 1)

    def forward(self, h, y):
        diff = self.lin(h) - y
        return (diff * diff).mean()


def _scaler_engines(window=None):
    """The reference's TestGradScalerDeferred engine
    (tests/test_async_step.py:446-556) in both packages, on the JAX
    one's weights."""
    from test_async_step import TestGradScalerDeferred as Ref
    ref = Ref()
    jeng = ref._engine(window=window)
    modules = [_Emb(), _Blk(), _Blk(), _Head()]
    layers = [jeng.embed, *jeng.blocks, jeng.head]
    for tm_, jm_ in zip(modules, layers):
        with torch.no_grad():
            tm_.lin.weight.copy_(_tt(np.asarray(jm_.lin.weight.data)))
            tm_.lin.bias.copy_(_tt(np.asarray(jm_.lin.bias.data)))
    teng = tsp.SpmdPipelineEngine(
        modules[0], modules[1:3], modules[3], topt.SGD(learning_rate=0.05),
        accumulate_steps=2, use_remat=False, dispatch_window=window,
        device='cpu')
    return ref, jeng, teng


def test_windowed_scaler_matches_the_per_step_path():
    """A NaN at step k: the windowed train_step(scaler=...) path skips
    exactly step k and ends with the per-step path's scaler state and
    parameters (bit-equal), and both match the reference's."""
    ref, jeng, teng = _scaler_engines()
    data = ref._data()
    kw = dict(init_loss_scaling=256.0, decr_every_n_nan_or_inf=2,
              incr_every_n_steps=1000)
    scaler_s = tamp.GradScaler(**kw)
    found_seq = []
    for x, y in data:
        teng.train_batch((x, y), scale=scaler_s._scale)
        f = bool(teng.last_found_inf)
        found_seq.append(f)
        scaler_s._found_inf = f
        scaler_s._update()
    want = [p.detach().clone() for _, p in teng._named]
    teng.shutdown()
    assert found_seq == [False, False, True, False, False]

    _, _, teng2 = _scaler_engines(window=2)
    scaler_a = tamp.GradScaler(**kw)
    rs = [teng2.train_step((x, y), scaler=scaler_a) for x, y in data]
    teng2.flush()
    assert [bool(r.found_inf) for r in rs] == found_seq
    assert (scaler_a._scale, scaler_a._good_steps, scaler_a._bad_steps) == \
        (scaler_s._scale, scaler_s._good_steps, scaler_s._bad_steps)
    for a, (_, b) in zip(want, teng2._named):
        assert torch.equal(a, b)

    # the reference's windowed path lands on the same scaler state and,
    # at the fp32 bars, the same parameters
    jscaler = jamp.GradScaler(**kw)
    jr = [jeng.train_step((x, y), scaler=jscaler) for x, y in data]
    jeng.flush()
    assert [bool(np.asarray(r.found_inf)) for r in jr] == found_seq
    assert (jscaler._scale, jscaler._good_steps, jscaler._bad_steps) == \
        (scaler_a._scale, scaler_a._good_steps, scaler_a._bad_steps)
    jp = ref._params_host(jeng)
    jeng.shutdown()
    for (n, p) in teng2._named:
        grp, rest = n.split('/', 1)
        if grp == 'blocks':
            i, name = rest.split('/', 1)
            want_p = jp[f'blocks/{name}'][int(i)]
        else:
            want_p = jp[f'{grp}/{rest}']
        np.testing.assert_allclose(_np(p), want_p, err_msg=n, **FP32)


def test_scaler_disabled_or_absent_leaves_the_step_unscaled():
    _, _, teng = _scaler_engines()
    x = np.random.RandomState(0).rand(4, 6, 4).astype('float32')
    y = np.random.RandomState(1).rand(4, 6, 1).astype('float32')
    off = tamp.GradScaler(enable=False)
    r = teng.train_step((x, y), scaler=off)
    teng.flush()
    assert r.done() and not bool(r.found_inf)
    assert off._good_steps == 0                  # disabled: no accounting


def test_the_update_paths_are_out_of_auto_casts_reach():
    """The reference's updates are jnp code its hook never sees: under
    O2 the port's functional_apply, eager step, bucketed update, lr feed
    and unscale_ give the same bits as outside auto_cast."""
    from paddle_tpu_torch.core import bucketing as tb
    from paddle_tpu_torch.optimizer import device_lr as tdlr
    from paddle_tpu_torch.optimizer import lr as tlr
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    rng = np.random.RandomState(0)
    params = {'w': rng.randn(4, 3).astype(np.float32),
              'b': rng.randn(3).astype(np.float32)}
    grads = {n: rng.randn(*a.shape).astype(np.float32)
             for n, a in params.items()}
    out = []
    for amp_on in (False, True):
        opt = topt.Adam(0.01, weight_decay=0.01,
                        grad_clip=ClipGradByGlobalNorm(0.5))
        chain = topt.Lamb(0.01)
        ps = {n: _tt(a) for n, a in params.items()}
        ps2 = {n: _tt(a) for n, a in params.items()}
        lin = tnn.Linear(3, 2)
        with torch.no_grad():
            lin.weight.fill_(0.5)
            lin.bias.fill_(0.25)
        lin.weight.grad = torch.full((3, 2), 8.0, dtype=torch.float32)
        lin.bias.grad = torch.full((2,), 3.0)
        eager = topt.SGD(0.1, parameters=list(lin.parameters()))
        feed = tdlr.LrFeed(topt.SGD(tlr.CosineAnnealingDecay(0.1, 5)),
                           True, 'cpu')
        flat_p = [torch.ones(8)]
        flat_g = [torch.full((8,), 0.5)]
        layout = tb.BucketLayout.build({'x': ((8,), torch.float32)})
        sst = [tb.init_bucket_state(topt.Momentum(0.1), layout.buckets[0],
                                    flat_p[0])]
        with tamp.auto_cast(enable=amp_on, level='O2'):
            new, st = opt.functional_apply(
                ps, {n: _tt(a) for n, a in grads.items()}, {},
                torch.tensor(0.01))
            new2, _ = chain.functional_apply(
                ps2, {n: _tt(a) for n, a in grads.items()}, {},
                torch.tensor(0.01))
            tamp.GradScaler(init_loss_scaling=4.0).step(eager)
            lr = feed.lr()
            tb.flat_functional_apply(topt.Momentum(0.1), layout, flat_p,
                                     flat_g, sst, torch.tensor(0.1))
        assert lr.dtype == torch.float32
        out.append([new['w'], new['b'], st['w']['moment1'], new2['w'],
                    lin.weight.detach().clone(), lin.bias.detach().clone(),
                    lr, flat_p[0].clone()])
    for a, b in zip(*out):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
