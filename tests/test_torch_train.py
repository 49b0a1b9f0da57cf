"""paddle_tpu_torch's TrainStep vs `paddle_tpu.jit.TrainStep`, and what
the training slice refuses.

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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

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
    g = torch.full((4,), 0.1, dtype=torch.bfloat16)
    new, states = opt.functional_apply({'w': p}, {'w': g}, {'w': {}},
                                       torch.tensor(1e-3))
    assert new['w'].dtype == torch.bfloat16 and 'master' not in states['w']
    # 1 - 1e-4 rounds back to 1 in bf16: the update is lost, as in JAX
    assert torch.equal(new['w'], p)
    opt = topt.SGD(learning_rate=1e-3)
    new, states = opt.functional_apply({'w': p}, {'w': g}, {'w': {}},
                                       torch.tensor(1e-3))
    assert states['w']['master'].dtype == torch.float32
    assert float(states['w']['master'][0]) < 1.0


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
    with pytest.raises(NotImplementedError, match='slice 3'):
        tjit.TrainStep(tiny, _torch_loss, topt.SGD(), device='cpu', **kw)


def test_optimizer_refusals():
    with pytest.raises(NotImplementedError, match='grad_clip'):
        topt.AdamW(grad_clip=object())
    with pytest.raises(NotImplementedError, match='LRScheduler'):
        topt.SGD(learning_rate=object())
    with pytest.raises(NotImplementedError, match='apply_decay_param_fun'):
        topt.AdamW(apply_decay_param_fun=lambda n: True)


def test_dropout_in_training_raises():
    ids = torch.zeros(1, 8, dtype=torch.long)
    for kw in (dict(hidden_dropout=0.1), dict(attn_dropout=0.1)):
        m = tgpt.GPTForCausalLM(tgpt.GPTConfig(**dict(TINY, **kw)))
        with pytest.raises(NotImplementedError, match='dropout'):
            m(ids)
        m.eval()
        m(ids)                                   # eval: dropout is inert
    qkv = torch.zeros(1, 16, 2 * 3 * 32)
    with pytest.raises(NotImplementedError, match='slice 4'):
        tfa.causal_attention(qkv, 2, 32, dropout=0.1)


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
