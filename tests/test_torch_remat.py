"""paddle_tpu_torch's remat policies (distributed/fleet/utils/recompute.py)
in the pipeline engine and in TrainStep.

- Remat changes no value: in the port, 'none', 'full', 'dots' and
  'attn_mlp_boundaries' give bit-equal losses, gradients and updated
  parameters on the CPU, with hidden and attention dropout 0.1 (its masks
  drawn from the engine's or the step's generator; the recompute must
  replay them), on the dense (L = 64) and flash (L = 512) routes. These
  run on one CPU thread: over several, the plain flash route's batched
  products are not bit-equal from run to run even without remat (two
  'none' runs differ in the last bits), so equality would test the BLAS.
- TrainStep(remat_policy=p) against `paddle_tpu.jit.TrainStep(
  remat_policy=p)` for each p: 3 SGD steps of a tiny GPT (dropout 0) on
  bridged weights, losses and parameters at rtol 2e-4 / atol 2e-5.
- What each policy recomputes, counted on the CPU through the kernels'
  plain versions: the counts chip_smoke.py asserts on the card
  (`pipeline_launches`).
- Which projections the backward runs again under each policy
  ('attn_mlp_boundaries' keeps the tagged tensors and re-runs none).
- The six boundary tags count, the policy resolution and the eager
  `recompute`.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    spmd_pipeline as tsp)
from paddle_tpu_torch.distributed.fleet.utils import recompute as R
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.nn.layer import transformer as ttf
from paddle_tpu_torch.ops.kernels import fused_elementwise as tfe
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import fused_norm as tfln
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=512, hidden_dropout=0.1, attn_dropout=0.1,
           use_flash_attention=True)
ROUTE_L = {'dense': 64, 'flash': 512}
A, MB = 2, 2
FP32 = dict(rtol=2e-4, atol=2e-5)


def _batch(L, rows=A * MB, seed=0):
    ids = np.random.RandomState(seed).randint(
        0, CFG['vocab_size'], (rows, L)).astype('int32')
    return ids, np.roll(ids, -1, 1).astype('int32')


def _engine(policy, cfg=CFG, A=A):
    triple = tgpt.build_gpt_pipeline(
        tgpt.GPTConfig(**cfg), generator=torch.Generator().manual_seed(7))
    return tsp.SpmdPipelineEngine(*triple, topt.AdamW(learning_rate=1e-3),
                                  accumulate_steps=A, remat_policy=policy,
                                  grad_accum_dtype='param', device='cpu',
                                  seed=11)


def _engine_run(policy, route):
    eng = _engine(policy)
    ids, labels = _batch(ROUTE_L[route])
    losses = [eng.train_batch((ids, labels)) for _ in range(2)]
    grads = [p.grad.clone() for _, p in eng._named]
    params = [p.detach().clone() for _, p in eng._named]
    return losses, grads, params


@pytest.mark.parametrize('route', ['dense', 'flash'])
@pytest.mark.parametrize('policy', ['full', 'dots', 'attn_mlp_boundaries'])
def test_policies_bit_equal_in_engine(policy, route):
    want = _engine_run('none', route)
    got = _engine_run(policy, route)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_recompute_without_the_generator_replay_differs(monkeypatch):
    """The bit-equality above rests on the replay: a recompute that draws
    fresh masks gives other gradients, and moves the generator on, so the
    next micro-batch's forward draws other masks too (no error either
    way)."""
    want = _engine_run('none', 'dense')
    monkeypatch.setattr(R, '_replay', lambda gen, state: _bound(gen))
    got = _engine_run('full', 'dense')
    assert not torch.equal(got[0][0], want[0][0])
    assert not any(torch.equal(x, y) for x, y in zip(got[1], want[1]))


def _bound(gen):
    return trng.rng_guard(gen)


def _train_step_run(policy):
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG),
                                generator=torch.Generator().manual_seed(3))
    step = tjit.TrainStep(model, _torch_loss, topt.AdamW(learning_rate=1e-3),
                          remat_policy=policy, device='cpu', seed=5)
    ids, labels = _batch(64)
    losses = [step(ids, labels) for _ in range(2)]
    return losses, [p.grad.clone() for p in model.parameters()], \
        [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize('policy', ['full', 'dots', 'attn_mlp_boundaries'])
def test_policies_bit_equal_in_train_step(policy):
    want = _train_step_run('none')
    got = _train_step_run(policy)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _jax_loss(model, ids, labels):
    return jgpt.GPTPretrainingCriterion()(model(ids), labels)


def _torch_loss(model, ids, labels):
    return tgpt.GPTPretrainingCriterion()(model(ids), labels)


@pytest.mark.parametrize('policy', R.POLICY_NAMES)
def test_train_step_policy_matches_jax(policy):
    cfg = dict(CFG, hidden_dropout=0.0, attn_dropout=0.0, max_seq_len=64)
    paddle.seed(21)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
    load_jax_params(tm, {n: np.asarray(p.data)
                         for n, p in jm.named_parameters()})
    jstep = jjit.TrainStep(jm, _jax_loss,
                           paddle.optimizer.SGD(learning_rate=1e-2,
                                                parameters=jm.parameters()),
                           use_buckets=False, remat_policy=policy)
    tstep = tjit.TrainStep(tm, _torch_loss, topt.SGD(learning_rate=1e-2),
                           use_buckets=False, remat_policy=policy,
                           device='cpu')
    assert tstep._remat_policy == jstep._remat_policy == policy
    ids, labels = _batch(32, rows=2, seed=5)
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))
                .numpy()) for _ in range(3)]
    tl = [float(tstep(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, **FP32)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstep._params[n]),
                                   err_msg=n, **FP32)


# ---------------------------------------------------------------------------
# what a step recomputes
# ---------------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PLAIN = {'layer_norm': (tfln, 'layer_norm_fwd_plain'),
         'layer_norm_bwd': (tfln, 'layer_norm_bwd_plain'),
         'bias_gelu': (tfe, 'bias_gelu_plain'),
         'bias_gelu_bwd': (tfe, 'bias_gelu_bwd_plain'),
         'flash_fwd': (tfa, 'flash_attention_packed_plain'),
         'flash_bwd': (tfa, 'flash_attention_packed_bwd_plain')}


@pytest.mark.parametrize('policy', R.POLICY_NAMES)
def test_step_calls_match_the_launch_derivation(policy, monkeypatch):
    """Calls of each kernel's plain version in one train_batch (A = 2, 2
    layers, dropout 0, the flash route) equal chip_smoke.py's derivation
    of the card's launches, divided by its launches a call."""
    calls = dict.fromkeys(PLAIN, 0)
    for name, (mod, attr) in PLAIN.items():
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, attr, counted)
    cfg = dict(CFG, hidden_dropout=0.0, attn_dropout=0.0)
    eng = _engine(policy, cfg)
    eng.train_batch(_batch(512))
    want = _chip_smoke().pipeline_launches(A, cfg['num_layers'], policy)
    per_call = {'layer_norm_bwd': 2, 'bias_gelu_bwd': 2}
    for name in ('layer_norm', 'layer_norm_bwd', 'bias_gelu',
                 'bias_gelu_bwd', 'flash_fwd'):
        assert calls[name] == want[name] // per_call.get(name, 1), name
    assert calls['flash_bwd'] == want['flash_bwd_dq'] == \
        want['flash_bwd_dkv']


@pytest.mark.parametrize('policy', R.POLICY_NAMES)
def test_step_tags_match_the_derivation(policy):
    """The boundary tags one train_batch counts (A = 2, 2 layers) equal
    chip_smoke.py's `pipeline_tags`, which the card's run asserts."""
    eng = _engine(policy, dict(CFG, hidden_dropout=0.0, attn_dropout=0.0))
    before = R.boundary_counts()
    eng.train_batch(_batch(512))
    got = {k: n - before.get(k, 0) for k, n in R.boundary_counts().items()}
    assert got == _chip_smoke().pipeline_tags(A, CFG['num_layers'], policy)


# ---------------------------------------------------------------------------
# tags, resolution, eager recompute
# ---------------------------------------------------------------------------
def test_boundary_counts_rise_for_every_tag():
    before = R.boundary_counts()
    eng = _engine('attn_mlp_boundaries', dict(CFG, attn_dropout=0.0))
    eng.train_batch(_batch(64))
    after = R.boundary_counts()
    assert set(R.BOUNDARY_NAMES) <= set(after)
    for tag in R.BOUNDARY_NAMES:
        assert after[tag] > before.get(tag, 0), tag
    snap = R.snapshot()
    assert snap['policies']['pipeline'] == 'attn_mlp_boundaries'
    assert snap['boundary_total'] == sum(after.values())


def test_tags_are_identities_outside_a_boundaries_region():
    """A tag is an identity everywhere; `segment` is a plain call outside
    a boundaries region and a checkpoint inside one (its function runs
    again in the backward)."""
    t = torch.ones(3)
    assert R.tag_tensor(t, 'attn_qkv') is t
    with R._boundary_region():
        assert R.tag_tensor(t, 'attn_qkv') is t
    calls = []

    def f(a):
        calls.append(1)
        return torch.tanh(a) * 2.0          # tanh's backward needs its out

    x = torch.randn(3, requires_grad=True)
    R.segment(f, x).sum().backward()
    assert len(calls) == 1
    with R._boundary_region():
        y = R.segment(f, x)
    y.sum().backward()
    assert len(calls) == 3


class _ForwardProducts(TorchDispatchMode):
    """Counts contractions that take a parameter as it is stored: the
    forward's `x @ w` (the backward takes w transposed, or none)."""

    def __init__(self, params):
        super().__init__()
        self.params = {(p.data_ptr(), tuple(p.shape), p.stride())
                       for p in params}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            if any(isinstance(a, torch.Tensor) and (
                    a.data_ptr(), tuple(a.shape), a.stride()) in self.params
                   for a in args):
                self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('policy,again', [
    ('none', 0), ('full', 3), ('dots', 0), ('attn_mlp_boundaries', 0)])
def test_backward_reruns_the_projections_only_under_full(policy, again):
    """The four projections of a block in the backward's recompute: 'full'
    re-runs three (the checkpoint stops before fc2's product, which saves
    only its inputs), 'dots' keeps their outputs, and
    'attn_mlp_boundaries' keeps the tagged tensors and stops each
    stretch's recompute before its product, as XLA drops a saved value's
    producers. The head's product is outside the blocks."""
    eng = _engine(policy, dict(CFG, hidden_dropout=0.0, attn_dropout=0.0),
                  A=1)
    ids, labels = _batch(512, rows=MB)
    loss = eng._microbatch_loss(torch.from_numpy(ids).long(),
                                torch.from_numpy(labels).long())
    with _ForwardProducts([p for _, p in eng._named]) as mode:
        loss.backward()
    assert mode.count == again * CFG['num_layers']


def _bert_blocks(policy, normalize_before, dropout=0.0):
    """Two encoder layers (BERT's block) under `policy`, and a loss fn
    over them run inside the step's generator."""
    trng.seed(0)   # the layers' default draws
    blocks = [ttf.TransformerEncoderLayer(
        32, 2, 64, dropout=dropout, activation='gelu',
        normalize_before=normalize_before) for _ in range(2)]
    gen = torch.Generator().manual_seed(5)

    def loss_fn(x):
        for b in blocks:
            x = b(x)
        return (x.float() ** 2).mean()
    fn = R.apply_policy(loss_fn, policy, engine='bert_test')

    def run(x):
        with trng.rng_guard(gen):
            return fn(x)
    return blocks, run


@pytest.mark.parametrize('normalize_before', [False, True])
@pytest.mark.parametrize('policy,again', [
    ('none', 0), ('full', 6), ('dots', 0), ('attn_mlp_boundaries', 3)])
def test_bert_block_backward_reruns(policy, again, normalize_before):
    """A BERT block's backward under each policy: 'full' re-runs all six
    projections; 'attn_mlp_boundaries' cuts the block at its three tags
    into stretches that keep only their inputs, so it re-runs the
    attention stretch's q, k and v projections (the reference saves only
    the tagged tensors there) and stops every other stretch before its
    product; 'none' and 'dots' re-run none."""
    blocks, run = _bert_blocks(policy, normalize_before)
    loss = run(torch.randn(2, 8, 32))
    with _ForwardProducts([p for b in blocks for p in b.parameters()]) \
            as mode:
        loss.backward()
    assert mode.count == again * len(blocks)


def test_bert_block_segments_change_no_value():
    """The stretches replay the bound generator: with dropout 0.1 the
    gradients under 'attn_mlp_boundaries' are bit-equal to 'none'."""
    grads = {}
    for policy in ('none', 'attn_mlp_boundaries'):
        blocks, run = _bert_blocks(policy, False, dropout=0.1)
        for b in blocks:
            b.train()
        run(torch.randn(2, 8, 32, generator=torch.Generator()
                        .manual_seed(1))).backward()
        grads[policy] = [p.grad for b in blocks for p in b.parameters()]
    assert all(torch.equal(a, b) for a, b in
               zip(grads['none'], grads['attn_mlp_boundaries']))


def test_segments_without_the_generator_replay_differ(monkeypatch):
    """'attn_mlp_boundaries' replays the bound generator in each stretch:
    without the replay the attention and residual dropouts of the
    recompute draw fresh masks and the gradients differ."""
    want = _engine_run('none', 'dense')
    monkeypatch.setattr(R, '_replay', lambda gen, state: _bound(gen))
    got = _engine_run('attn_mlp_boundaries', 'dense')
    assert not any(torch.equal(x, y) for x, y in zip(got[1], want[1]))


def test_resolve_policy(monkeypatch):
    monkeypatch.delenv('PTPU_REMAT_POLICY', raising=False)
    assert R.resolve_policy() == 'none'
    assert R.resolve_policy(default=None) is None
    assert R.resolve_policy(True) == 'full'
    assert R.resolve_policy(False) == 'none'
    monkeypatch.setenv('PTPU_REMAT_POLICY', 'dots')
    assert R.resolve_policy() == 'dots'
    assert R.resolve_policy('full') == 'full'          # the kwarg wins
    monkeypatch.setenv('PTPU_REMAT_POLICY', 'most')
    with pytest.raises(ValueError, match='unknown remat policy'):
        R.resolve_policy()
    with pytest.raises(ValueError, match='unknown remat policy'):
        tjit.TrainStep(torch.nn.Linear(2, 2), None, topt.SGD(),
                       device='cpu')


def test_engine_policy_from_the_environment(monkeypatch):
    monkeypatch.setenv('PTPU_REMAT_POLICY', 'none')
    eng = _engine(None)
    assert not eng.use_remat and eng._block_fn == eng._block_apply
    monkeypatch.delenv('PTPU_REMAT_POLICY')
    eng = _engine(None)               # use_remat=True: 'full' at pp = 1
    assert eng.use_remat and R.snapshot()['policies']['pipeline'] == 'full'


def test_checkpoint_policy_names():
    assert R.checkpoint_policy('none') == (False, None)
    assert R.checkpoint_policy('full') == (True, None)
    assert R.checkpoint_policy('dots')[0]
    assert R.checkpoint_policy('attn_mlp_boundaries')[0]
    f = lambda x: x                                     # noqa: E731
    assert R.apply_policy(f, 'none') is f


def test_eager_recompute_replays_dropout():
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8)
    gen = torch.Generator().manual_seed(9)

    def f(a):
        h = torch.tanh(a @ w)
        return torch.nn.functional.linear(
            torch.where(trng.keep_mask(h.shape, 0.7, h.device), h, 0.0), w)

    grads = []
    for remat in (False, True):
        gen.manual_seed(9)
        w.grad = None
        with trng.rng_guard(gen):
            out = R.recompute(f, x) if remat else f(x)
        out.square().sum().backward()
        grads.append(w.grad.clone())
    assert torch.equal(*grads)
    with torch.no_grad():
        with trng.rng_guard(gen):
            assert R.recompute(f, x).grad_fn is None
