"""paddle_tpu_torch's TrainStep vs `paddle_tpu.jit.TrainStep`, and what
the training slices refuse.

A tiny GPT (vocab 128, hidden 64, 2 layers, 2 heads, dropout 0) is
bridged into the port; both packages then take 3 steps of
`TrainStep(use_buckets=False)` — the per-parameter `functional_apply`
route — on the same seeded batch, with GPTPretrainingCriterion as the
loss. Each step's loss and the final parameters are compared.

Tolerances:
- SGD, fp32: rtol 2e-4 / atol 2e-5 for losses and params (the fp32
  bars: summation order).
- AdamW and Adam, fp32: losses at the fp32 bars; params at atol
  2 * lr * steps. Adam divides each gradient by its own running
  magnitude, so an element whose gradient is rounding noise (a sum
  that nearly cancels) moves by up to lr a step in a direction the
  noise picks; 99.9 % of the elements must still agree to 1e-5.
- AdamW with bf16 params, multi_precision=False and bf16 moments (the
  bench's configuration): the two frameworks round bf16 at other
  points. Losses at rtol 2^-8 (one bf16 rounding of the mean); params
  at atol 2 * lr * steps plus one bf16 ulp of the largest param, a
  coarse bound only. The update itself is held by: the same state
  (keys and dtypes: bf16 moments, fp32 beta powers, no master) as
  JAX's; the parameter change of all params together within a
  relative L2 error of 5e-2 of JAX's change, and the moments within
  2e-2 (both about 0.04 and 0.009 here: elements whose gradient is
  rounding noise, e.g. the key part of the qkv bias, move by up to lr
  either way); and 85 % of the elements within one bf16 ulp of JAX's
  value (90 % here). A step without Adam's bias correction (3x larger
  steps) breaks all three; fp32 moments or a master weight break the
  state check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=64, hidden_dropout=0.0, attn_dropout=0.0,
            use_flash_attention=True)
STEPS = 3
LR = 1e-3
FP32 = dict(rtol=2e-4, atol=2e-5)


def _jax_loss(model, ids, labels):
    return jgpt.GPTPretrainingCriterion()(model(ids), labels)


def _torch_loss(model, ids, labels):
    return tgpt.GPTPretrainingCriterion()(model(ids), labels)


def _optimizers(kind, jparams):
    kw = dict(learning_rate=LR)
    if kind == 'sgd':
        return (paddle.optimizer.SGD(parameters=jparams, **kw),
                topt.SGD(**kw))
    if kind == 'adam':
        kw['weight_decay'] = 0.01            # decay into the gradient
        return (paddle.optimizer.Adam(parameters=jparams, **kw),
                topt.Adam(**kw))
    kw['weight_decay'] = 0.01
    if kind == 'adamw_bf16':
        kw.update(multi_precision=False, moment_dtype='bfloat16')
    return (paddle.optimizer.AdamW(parameters=jparams, **kw),
            topt.AdamW(**kw))


def _run_both(kind):
    paddle.seed(21)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    bf16 = kind == 'adamw_bf16'
    if bf16:
        for p in jm.parameters():
            p.data = p.data.astype(jnp.bfloat16)
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY),
                             dtype=torch.bfloat16 if bf16 else None)
    load_jax_params(tm, named)
    jopt, tstep_opt = _optimizers(kind, jm.parameters())
    jstep = jjit.TrainStep(jm, _jax_loss, jopt, use_buckets=False)
    tstep = tjit.TrainStep(tm, _torch_loss, tstep_opt, use_buckets=False,
                           device='cpu')
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 128, (2, 32)).astype(np.int32)
    labels = np.roll(ids, -1, 1)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(labels)).numpy()))
        tl.append(float(tstep(ids, labels)))
    jp = {n: np.asarray(a, np.float32) for n, a in jstep._params.items()}
    tp = {n: p.detach().float().numpy() for n, p in tm.named_parameters()}
    assert set(jp) == set(tp)
    return jl, tl, jp, tp, named, (jstep._opt_states, tstep._opt_states)


@pytest.mark.parametrize('kind', ['sgd', 'adam', 'adamw', 'adamw_bf16'])
def test_three_steps_match_jax_train_step(kind):
    jl, tl, jp, tp, before, states = _run_both(kind)
    assert tl[-1] < tl[0]
    if kind == 'sgd':
        np.testing.assert_allclose(tl, jl, **FP32)
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **FP32)
        return
    atol = 2 * LR * STEPS
    if kind == 'adamw_bf16':
        np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8)
        big = max(float(np.abs(a).max()) for a in jp.values())
        atol += big * 2.0 ** -8
        _check_bf16_update(jp, tp, before, *states)
    else:
        np.testing.assert_allclose(tl, jl, **FP32)
    close, total = 0, 0
    for n in tp:
        np.testing.assert_allclose(tp[n], jp[n], err_msg=n, rtol=0,
                                   atol=atol)
        close += int((np.abs(tp[n] - jp[n]) <= 1e-5).sum())
        total += tp[n].size
        # the port moved the elements the JAX step moved (a bf16 param
        # near 1 may not move at all: 1 - 3 lr rounds back to 1)
        moved = np.abs(jp[n] - before[n].astype(np.float32)) > 0
        if moved.any():
            assert (np.abs(tp[n] - before[n].astype(np.float32)) > 0)[
                moved].mean() > 0.9, n
    if kind != 'adamw_bf16':
        assert close / total >= 0.999


def _rel_l2(got, want):
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    return (num / sum(float((w ** 2).sum()) for w in want)) ** 0.5


def _check_bf16_update(jp, tp, before, jstates, tstates):
    """The bf16 AdamW step's update against JAX's (see the docstring)."""
    for n in tp:
        js, ts = jstates[n], tstates[n]
        assert set(ts) == set(js), n
        for key in js:
            assert str(ts[key].dtype).split('.')[-1] == \
                str(np.asarray(js[key]).dtype), (n, key)
    names = sorted(tp)
    start = [before[n].astype(np.float32) for n in names]
    assert _rel_l2([tp[n] - b for n, b in zip(names, start)],
                   [jp[n] - b for n, b in zip(names, start)]) <= 5e-2
    moments = [(np.asarray(jstates[n][m], np.float32),
                tstates[n][m].float().numpy())
               for n in names for m in ('moment1', 'moment2')]
    assert _rel_l2([t for _, t in moments], [j for j, _ in moments]) <= 2e-2
    within = total = 0
    for n in names:
        # one bf16 ulp at JAX's value: 2^(exponent - 7)
        mag = np.maximum(np.abs(jp[n]), np.finfo(np.float32).tiny)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        within += int((np.abs(tp[n] - jp[n]) <= ulp).sum())
        total += tp[n].size
    assert within / total >= 0.85


def test_adam_beta_powers_are_fp32_tensors():
    opt = topt.AdamW(learning_rate=LR, moment_dtype='bfloat16')
    st = opt.init_state(torch.zeros(3, 4))
    assert st['moment1'].dtype == torch.bfloat16
    assert st['beta1_pow'].dtype == torch.float32 and st['beta1_pow'].dim() == 0
    lr = torch.tensor(LR)
    new_p, st2 = opt.update(torch.ones(3, 4), torch.ones(3, 4), st, lr)
    assert st2['beta2_pow'].dtype == torch.float32
    # lr_t = lr * sqrt(1 - b2p) / (1 - b1p), decay applied to the param first
    b1p, b2p = torch.tensor(0.9), torch.tensor(0.999)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    m1, m2 = 0.1 * torch.ones(()), 0.001 * torch.ones(())
    want = 1.0 * (1.0 - lr * 0.01) - lr_t * m1 / (torch.sqrt(m2) + 1e-8)
    torch.testing.assert_close(new_p, want.expand(3, 4), rtol=1e-6, atol=0)


def test_bf16_params_without_master_round_each_step():
    opt = topt.SGD(learning_rate=1e-3, multi_precision=False)
    p = torch.ones(4, dtype=torch.bfloat16)
    before = p.clone()
    g = torch.full((4,), 0.1, dtype=torch.bfloat16)
    new, states = opt.functional_apply({'w': p}, {'w': g}, {'w': {}},
                                       torch.tensor(1e-3))
    assert new['w'].dtype == torch.bfloat16 and 'master' not in states['w']
    # 1 - 1e-4 rounds back to 1 in bf16: the update is lost, as in JAX
    # (the fused route updates p in place, so compare with a copy)
    assert torch.equal(new['w'], before)
    opt = topt.SGD(learning_rate=1e-3)
    new, states = opt.functional_apply({'w': p}, {'w': g}, {'w': {}},
                                       torch.tensor(1e-3))
    assert states['w']['master'].dtype == torch.float32
    assert float(states['w']['master'][0]) < 1.0


# ---------------------------------------------------------------------------
# the slice whole: the default (bucketed) route with hidden dropout
# ---------------------------------------------------------------------------
DROPOUT = dict(TINY, hidden_dropout=0.1)
BATCH = (2, 32)


class _ReplayMasks:
    """The same numpy keep masks on both sides, per mask shape in call
    order: the hidden masks [B, L, H] (the embedding's, then per layer the
    attention join's and the MLP join's) and the attention masks
    [B, nh, L, L] (one a layer). The jitted JAX step traces its forward
    once, so it replays the same masks every step; the port's draw
    cycles through them the same way."""

    def __init__(self, counts, seed=9):
        rng = np.random.RandomState(seed)
        self.masks = {shape: [rng.rand(*shape) < 0.9 for _ in range(n)]
                      for shape, n in counts.items()}
        self.j = dict.fromkeys(counts, 0)
        self.t = dict.fromkeys(counts, 0)

    def _next(self, seen, shape):
        shape = tuple(shape)
        masks = self.masks[shape]
        m = masks[seen[shape] % len(masks)]
        seen[shape] += 1
        return m

    def jax_bernoulli(self, key, p, shape):
        assert abs(p - 0.9) < 1e-12
        return jnp.asarray(self._next(self.j, shape))

    def torch_keep(self, shape, keep_prob, device):
        assert abs(keep_prob - 0.9) < 1e-12
        return torch.from_numpy(self._next(self.t, shape)).to(device)


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(2e-3, T_max=10),
                            warmup_steps=2, start_lr=0.0, end_lr=2e-3)


def _default_optimizers(kind, jparams):
    """(JAX optimizer, port optimizer, JAX schedule, port schedule)."""
    if kind == 'sgd':
        return (paddle.optimizer.SGD(learning_rate=LR, parameters=jparams),
                topt.SGD(learning_rate=LR), None, None)
    if kind == 'momentum':
        js, ts = _schedule(paddle.optimizer.lr), _schedule(tlr)
        kw = dict(momentum=0.9, use_nesterov=True, weight_decay=0.01)
        return (paddle.optimizer.Momentum(
            learning_rate=js, parameters=jparams,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **kw),
            topt.Momentum(learning_rate=ts,
                          grad_clip=tnn.ClipGradByGlobalNorm(1.0), **kw),
            js, ts)
    js, ts = _schedule(paddle.optimizer.lr), _schedule(tlr)
    kw = dict(weight_decay=0.01, multi_precision=False,
              moment_dtype='bfloat16')
    return (paddle.optimizer.AdamW(
        learning_rate=js, parameters=jparams,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **kw),
        topt.AdamW(learning_rate=ts, grad_clip=tnn.ClipGradByGlobalNorm(1.0),
                   **kw), js, ts)


def _run_default_both(kind, monkeypatch, cfg=DROPOUT, batch=BATCH):
    counts = {batch + (cfg['hidden_size'],): 1 + 2 * cfg['num_layers']}
    if cfg['attn_dropout']:
        counts[(batch[0], cfg['num_heads'], batch[1], batch[1])] = \
            cfg['num_layers']
    masks = _ReplayMasks(counts)
    monkeypatch.setattr(jax.random, 'bernoulli', masks.jax_bernoulli)
    monkeypatch.setattr(trng, 'keep_mask', masks.torch_keep)
    paddle.seed(21)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    bf16 = kind == 'adamw_bf16'
    if bf16:
        for p in jm.parameters():
            p.data = p.data.astype(jnp.bfloat16)
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg),
                             dtype=torch.bfloat16 if bf16 else None)
    load_jax_params(tm, named)
    jopt, opt, jsched, tsched = _default_optimizers(kind, jm.parameters())
    jstep = jjit.TrainStep(jm, _jax_loss, jopt)           # the defaults
    tstep = tjit.TrainStep(tm, _torch_loss, opt, device='cpu')
    assert jstep._use_buckets and tstep.use_buckets
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 128, batch).astype(np.int32)
    labels = np.roll(ids, -1, 1)
    jl, tl, fed = [], [], []
    for _ in range(STEPS):
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(labels)).numpy()))
        want_lr = opt.get_lr()
        tl.append(float(tstep(ids, labels)))
        fed.append((float(tstep._lr), float(np.float32(want_lr))))
        for sched in (jsched, tsched):
            if sched is not None:
                sched.step()
    for shape, n in counts.items():
        assert masks.t[shape] == STEPS * n, shape
        assert masks.j[shape] >= n, shape      # the JAX trace drew them all
    assert all(a == b for a, b in fed), fed
    # each param's .grad is a view of its gradient bucket
    for n, p in tm.named_parameters():
        slot = tstep.layout.slots[n]
        base = tstep._flat_grads[slot.bucket]
        assert p.grad.data_ptr() == base.data_ptr() + \
            slot.offset * base.element_size()
    jp = {n: np.asarray(a, np.float32) for n, a in jstep._params.items()}
    tp = {n: p.detach().float().numpy() for n, p in tm.named_parameters()}
    assert set(jp) == set(tp)
    return jl, tl, jp, tp, named, (_jax_named_states(jstep),
                                   tstep.named_opt_states())


def _jax_named_states(jstep):
    from paddle_tpu.core import bucketing as JB
    return {n: {k: np.asarray(v) for k, v in st.items()}
            for n, st in JB.flat_states_to_named(
                jstep._layout, [{k: np.asarray(v) for k, v in s.items()}
                                for s in jstep._opt_states]).items()}


@pytest.mark.parametrize('kind', ['sgd', 'momentum', 'adamw_bf16'])
def test_default_train_step_matches_jax_with_hidden_dropout(kind,
                                                            monkeypatch):
    """3 steps of the port's default TrainStep (bucketed) against
    `paddle_tpu.jit.TrainStep` with its defaults, hidden dropout 0.1 on
    replayed masks: SGD in fp32; Momentum (Nesterov, decay) in fp32 with
    global-norm clipping and warm-up into cosine; AdamW with bf16
    params and moments, no master, clipping and the schedule (the bars
    of the bf16 AdamW case above)."""
    jl, tl, jp, tp, before, states = _run_default_both(kind, monkeypatch)
    assert tl[-1] < tl[0]
    if kind != 'adamw_bf16':
        np.testing.assert_allclose(tl, jl, **FP32)
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **FP32)
        jst, tst = states
        for n in tst:
            assert set(tst[n]) == set(jst[n]), n
            for k in tst[n]:
                np.testing.assert_allclose(tst[n][k].float().numpy(),
                                           jst[n][k], err_msg=f'{n} {k}',
                                           **FP32)
        return
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8)
    _check_bf16_update(jp, tp, before, *states)


# GPTConfig's defaults: hidden and attention dropout 0.1; L = 512 takes the
# flash route (the dropout-fused BHLD flash), L = 32 the dense one
ATTN = dict(DROPOUT, attn_dropout=0.1, max_seq_len=512)
ROUTE_BATCH = {'flash': (2, 512), 'dense': BATCH}


@pytest.mark.parametrize('route,kind', [('flash', 'sgd'), ('dense', 'sgd'),
                                        ('dense', 'adamw_bf16')])
def test_default_train_step_matches_jax_with_attention_dropout(route, kind,
                                                               monkeypatch):
    """3 steps of the port's default TrainStep against
    `paddle_tpu.jit.TrainStep` with hidden and attention dropout 0.1 on
    replayed masks, on each attention route: fp32 SGD at the fp32 bars;
    AdamW with bf16 params and moments, clipping and the schedule at the
    bf16 AdamW bars above."""
    calls = []
    flash = tfa._flash_attn_dropout
    monkeypatch.setattr(tfa, '_flash_attn_dropout',
                        lambda *a: calls.append(1) or flash(*a))
    jl, tl, jp, tp, before, states = _run_default_both(
        kind, monkeypatch, cfg=ATTN, batch=ROUTE_BATCH[route])
    assert len(calls) == (STEPS * ATTN['num_layers'] if route == 'flash'
                          else 0)
    assert tl[-1] < tl[0]
    if kind == 'sgd':
        np.testing.assert_allclose(tl, jl, **FP32)
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **FP32)
        return
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8)
    _check_bf16_update(jp, tp, before, *states)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def tiny():
    return tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY),
                               generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize('kw', [dict(use_buckets=None),
                                dict(use_buckets=True),
                                dict(remat_policy='attn_mlp_boundaries')],
                         ids=['buckets-default', 'buckets', 'remat'])
def test_train_step_refuses_unported_routes(tiny, kw):
    """The bucketed route is ported (the default, as in the reference),
    and so is remat: the policy is taken and a step runs under it."""
    if 'remat_policy' in kw:
        step = tjit.TrainStep(tiny, _torch_loss, topt.SGD(), device='cpu',
                              **kw)
        assert step._remat_policy == 'attn_mlp_boundaries'
        ids = np.zeros((1, 8), np.int32)
        assert np.isfinite(float(step(ids, ids)))
        return
    step = tjit.TrainStep(tiny, _torch_loss, topt.SGD(), device='cpu', **kw)
    assert step.use_buckets and step.layout is not None


def test_optimizer_refusals():
    with pytest.raises(NotImplementedError, match='apply_decay_param_fun'):
        topt.AdamW(apply_decay_param_fun=lambda n: True)
    with pytest.raises(NotImplementedError, match='lr_ratio'):
        topt.AdamW(lr_ratio=lambda p: 1.0)


def test_optimizer_takes_a_schedule_and_a_clip():
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(2e-4, T_max=8), 2,
                             0.0, 2e-4)
    opt = topt.AdamW(learning_rate=sched,
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    assert opt.get_lr() == 0.0 and opt._grad_clip.clip_norm == 1.0
    with pytest.raises(TypeError, match='grad_clip'):
        topt.AdamW(grad_clip=object())
    with pytest.raises(TypeError, match='learning_rate'):
        topt.SGD(learning_rate=object())


def test_dropout_in_training_raises():
    """Hidden and attention dropout train, each drawing its masks from
    the bound generator (same seed, same output; eval is inert); with no
    generator bound a training forward raises, on both attention routes,
    and a rate outside (0, 1) raises."""
    ids = torch.zeros(1, 8, dtype=torch.long)
    for drop in (dict(hidden_dropout=0.1), dict(attn_dropout=0.1),
                 dict(attn_dropout=0.1, max_seq_len=512)):
        m = tgpt.GPTForCausalLM(tgpt.GPTConfig(**dict(TINY, **drop)))
        x = ids if drop.get('max_seq_len') is None else \
            torch.zeros(1, 512, dtype=torch.long)  # L = 512: the flash route
        with pytest.raises(RuntimeError, match='bound generator'):
            m(x)
        with trng.rng_guard(torch.Generator().manual_seed(0)):
            a = m(x)
        with trng.rng_guard(torch.Generator().manual_seed(0)):
            b = m(x)
        with trng.rng_guard(torch.Generator().manual_seed(1)):
            c = m(x)
        assert torch.equal(a, b) and not torch.equal(a, c), drop
        m.eval()
        assert not torch.equal(m(x), a), drop    # eval: dropout is inert
    qkv = torch.zeros(1, 16, 2 * 3 * 32)
    with pytest.raises(RuntimeError, match='bound generator'):
        tfa.causal_attention(qkv, 2, 32, dropout=0.1)
    with pytest.raises(ValueError, match='rate'):
        tfa.causal_attention(qkv, 2, 32, dropout=1.0)


def test_train_step_without_device_needs_the_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tjit.TrainStep(tiny, _torch_loss, topt.SGD())


def test_paged_attention_refuses_a_gradient():
    q = torch.zeros(1, 1, 8, requires_grad=True)
    pages = torch.zeros(2, 4, 8)
    meta = (torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match='no backward'):
        tpa.ragged_paged_attention(q, pages, pages, *meta, num_heads=1,
                                   head_dim=8)
    with torch.no_grad():
        out = tpa.ragged_paged_attention(q, pages, pages, *meta,
                                         num_heads=1, head_dim=8)
    assert out.shape == q.shape
