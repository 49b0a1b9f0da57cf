"""The port's numerics observatory (core/numerics.py) against the JAX
package's, on the CPU.

- `stats_vec` on fp32 and bf16 arrays with NaN, Inf, zeros and
  subnormals, made from a numpy seed: exact counts and the other stats
  at rtol 1e-6 against the reference's; `collect` fetches once.
- The eager guard (a TorchFunctionMode) names the same first op as the
  reference's, at once and deferred; a clean step costs one sync, a
  flush without ops none; the journal cap; `step_guard` resets on an
  exception; the optimizer step is the boundary.
- A copy of the reference's `test_amp_skip_step_resets_guard`
  (tests/test_numerics.py), and the scaler's `ptpu_amp_*` metrics.
- `process_jit_taps` on the same host taps gives the reference's stats,
  norm and report; the engines' taps: one host fetch a step, a planted
  NaN raises naming its parameter, a loss-scale overflow is skipped.
- `DivergenceSentinel`'s fingerprint and vote; the clip's pre-clip
  gauge; `snapshot()`'s keys.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core import numerics as jnum
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import monitor as tmon
from paddle_tpu_torch.core import numerics as tnum
from torch_threads import one_intra_op_thread  # noqa: F401

SUB32 = 1e-40        # an fp32 subnormal
SUB16 = 1e-39        # a bf16 subnormal


@pytest.fixture(autouse=True)
def _flags_reset(tmp_path, monkeypatch):
    monkeypatch.setenv('FLEET_LOG_DIR', str(tmp_path))
    yield
    tflags.set_flags({'FLAGS_check_nan_inf': False,
                      'FLAGS_check_nan_inf_deferred': False,
                      'FLAGS_check_nan_inf_max_journal': 4096,
                      'FLAGS_tensor_stats': False})
    paddle.set_flags({'FLAGS_check_nan_inf': False,
                      'FLAGS_check_nan_inf_deferred': False,
                      'FLAGS_tensor_stats': False})
    tnum.reset()
    jnum.reset()


def _count_fetches(monkeypatch):
    calls = []
    real = tnum._host_fetch
    monkeypatch.setattr(tnum, '_host_fetch',
                        lambda tree: calls.append(1) or real(tree))
    return calls


def _poisoned(seed, n=4096, sub=SUB32):
    rng = np.random.RandomState(seed)
    x = rng.normal(1.0, 0.5, n).astype(np.float32)
    idx = rng.permutation(n)
    x[idx[:7]] = np.nan
    x[idx[7:12]] = np.inf
    x[idx[12:14]] = -np.inf
    x[idx[14:40]] = 0.0
    x[idx[40:49]] = sub
    return x


# ---------------------------------------------------------------------------
# fused tensor statistics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('seed', [0, 1])
def test_stats_vec_equals_the_reference(dtype, seed):
    x = _poisoned(seed, sub=SUB32 if dtype == 'float32' else SUB16)
    # the reference's own path: its jitted reduction (tensor_stats)
    want = np.asarray(jnum._stats_jit()(jnp.asarray(x, getattr(jnp, dtype))),
                      np.float64)
    got = tnum.stats_vec(torch.from_numpy(x).to(getattr(torch, dtype))) \
        .double().numpy()
    assert np.array_equal(got[:4], want[:4]) and got[9] == want[9]
    assert got[:4].tolist() == [7, 7, 26, 9]
    np.testing.assert_allclose(got[4:9], want[4:9], rtol=1e-6)


def test_stats_vec_edge_cases_equal_the_reference():
    cases = [np.zeros(0, np.float32), np.zeros(5, np.float32),
             np.array([np.nan] * 3, np.float32),
             np.arange(-4, 5, dtype=np.int32)]
    for x in cases:
        want = np.asarray(jnum._stats_jit()(jnp.asarray(x)))
        got = tnum.stats_vec(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)


def test_collect_is_one_fetch(monkeypatch):
    calls = _count_fetches(monkeypatch)
    named = {f't{i}': torch.from_numpy(_poisoned(i, n=64))
             for i in range(5)}
    got = tnum.collect(named)
    assert len(calls) == 1
    for k, x in named.items():
        want = jnum.tensor_stats(jnp.asarray(x.numpy()))
        assert got[k].as_dict()['nan_count'] == want.nan_count
        assert got[k].shape == (64,) and got[k].dtype == 'float32'
    assert 'nan=' in repr(got['t0'])


# ---------------------------------------------------------------------------
# the eager guard
# ---------------------------------------------------------------------------
def _ref_first_op(deferred):
    paddle.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_deferred': deferred})
    try:
        x = paddle.to_tensor([0.25, 0.5])
        y = paddle.log(x - 1.0)
        z = paddle.exp(y * 2.0)
        z + 1.0
        jnum.flush(site='test', step=3)
    except jnum.NumericsError as e:
        return e.report
    finally:
        paddle.set_flags({'FLAGS_check_nan_inf': False,
                          'FLAGS_check_nan_inf_deferred': False})


def _port_first_op(deferred):
    tflags.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_deferred': deferred})
    try:
        with tnum.guard():
            x = torch.tensor([0.25, 0.5])
            y = torch.log(x - 1.0)
            z = torch.exp(y * 2.0)
            z + 1.0
        tnum.flush(site='test', step=3)
    except tnum.NumericsError as e:
        return e.report


@pytest.mark.parametrize('deferred', [False, True])
def test_guard_names_the_same_first_op(deferred):
    want, got = _ref_first_op(deferred), _port_first_op(deferred)
    assert got['op'] == want['op'] == 'log'
    assert got['mode'] == want['mode']
    assert got['output']['stats']['nan_count'] == \
        want['output']['stats']['nan_count'] == 2
    assert [i['stats']['nan_count'] for i in got['inputs']] == \
        [i['stats']['nan_count'] for i in want['inputs']]
    if deferred:
        assert got['step'] == want['step'] == 3
    assert 'first nonfinite op: log' in tnum.render_numerics_report(got)


def test_deferred_guard_costs(monkeypatch):
    tflags.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_deferred': True})
    calls = _count_fetches(monkeypatch)
    assert tnum.flush() is None and not calls     # no ops: no sync
    with tnum.guard():
        x = torch.tensor([1.0, 2.0])
        for _ in range(5):
            x = torch.log(x * x + 1.0)
    assert tnum.guard().pending_ops() > 0
    assert tnum.flush() is None and len(calls) == 1
    assert tnum.guard().pending_ops() == 0
    tflags.set_flags({'FLAGS_check_nan_inf': False})
    with tnum.guard():
        torch.log(torch.tensor([-1.0]))            # flag off: unobserved
    assert not tnum.guard().has_pending()


def test_journal_cap_and_zero_cap():
    tflags.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_deferred': True,
                      'FLAGS_check_nan_inf_max_journal': 8})
    with tnum.guard():
        y = torch.log(torch.tensor([-1.0]))
        for _ in range(12):
            y = y * 1.0
    assert tnum.guard().pending_ops() == 8
    with pytest.raises(tnum.NumericsError) as ei:
        tnum.flush()
    assert ei.value.report['journal_dropped'] > 0
    tflags.set_flags({'FLAGS_check_nan_inf_max_journal': 0})
    with tnum.guard():
        torch.log(torch.tensor([-1.0]))
    assert tnum.guard().pending_ops() == 0 and tnum.guard().has_pending()
    with pytest.raises(tnum.NumericsError) as ei:
        tnum.flush()
    assert ei.value.report['op'] is None
    assert 'journal window' in ei.value.report['message']


def test_step_guard_exception_resets_instead_of_leaking():
    tflags.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_deferred': True})
    with pytest.raises(ValueError):
        with tnum.step_guard(step=1):
            torch.log(torch.tensor([-1.0]))
            raise ValueError('body failed')
    assert tnum.guard().pending_ops() == 0
    with tnum.step_guard(step=2):
        torch.log(torch.tensor([2.0]))


def _linear(seed=0):
    """A 2x2 Linear with positive weights (a positive output sum, as the
    reference test's seed gives) and its SGD."""
    torch.manual_seed(seed)
    net = tnn.Linear(2, 2)
    with torch.no_grad():
        net.weight.uniform_(0.1, 1.0)
        net.bias.fill_(0.1)
    return net, topt.SGD(learning_rate=0.1, parameters=net.parameters())


def test_optimizer_step_is_the_boundary_and_guards_params():
    tflags.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_deferred': True})
    net, opt = _linear()
    w_before = net.weight.detach().clone()
    with tnum.guard():
        loss = torch.log(net(torch.ones(2, 2)).sum() - 1e9)
        loss.backward()
    with pytest.raises(tnum.NumericsError) as ei:
        opt.step()
    assert ei.value.report['site'] == 'optimizer.step'
    assert torch.equal(net.weight.detach(), w_before)


def test_amp_skip_step_resets_guard():
    """A GradScaler overflow skip is a survived nonfinite step: the
    deferred guard's flag and journal must not leak into (and crash) the
    next clean step (the reference's test of the same name, on the
    port)."""
    tflags.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_deferred': True})
    net, opt = _linear()
    x = torch.ones(2, 2)
    with tnum.guard():
        loss = torch.exp(net(x).sum() * 1e9)        # overflow -> inf
        loss.backward()
    scaler = tamp.GradScaler(init_loss_scaling=2.0,
                             decr_every_n_nan_or_inf=1)
    scaler.step(opt)                                # skipped, no raise
    assert scaler._found_inf
    assert tnum.guard().pending_ops() == 0          # state dropped
    opt.clear_grad()
    with tnum.guard():
        loss = (net(x) ** 2).mean()                 # clean step
        loss.backward()
    scaler.step(opt)                                # must NOT raise
    assert not scaler._found_inf


def test_scaler_not_wedged_by_numerics_raise_and_its_metrics():
    tflags.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_deferred': True})
    net, opt = _linear()
    with tnum.guard():
        torch.log(torch.tensor([-1.0]))
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    scaler = tamp.GradScaler(init_loss_scaling=4.0)
    steps = tmon.metrics().counter('ptpu_amp_steps_total').value()
    with pytest.raises(tnum.NumericsError):
        scaler.step(opt)
    assert not scaler._unscaled
    for p in net.parameters():
        p.grad = torch.full_like(p, 4.0)
    scaler.step(opt)
    assert not scaler._found_inf
    assert tmon.metrics().counter('ptpu_amp_steps_total').value() == \
        steps + 1
    assert tmon.metrics().get('ptpu_amp_loss_scale').value() == 4.0


# ---------------------------------------------------------------------------
# taps
# ---------------------------------------------------------------------------
def _host_taps(seed, nan=False):
    rng = np.random.RandomState(seed)
    g = {f'g{i}': rng.normal(0, 1, (8, 4)).astype(np.float32)
         for i in range(3)}
    p = {k: rng.normal(0, 1, v.shape).astype(np.float32)
         for k, v in g.items()}
    if nan:
        g['g1'][2, 3] = np.nan
    return g, p


@pytest.mark.parametrize('nan', [False, True])
def test_process_jit_taps_equals_the_reference(nan):
    g, p = _host_taps(4, nan)
    jt = {k: np.asarray(v) for k, v in jnum.jit_taps(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in p.items()}).items()
        if k == 'grad_norm_sq'}
    jt = {'grads': {k: np.asarray(jnum.stats_vec(jnp.asarray(v)))
                    for k, v in g.items()},
          'params': {k: np.asarray(jnum.stats_vec(jnp.asarray(v)))
                     for k, v in p.items()},
          'grad_norm_sq': jt['grad_norm_sq']}
    tt = tnum.jit_taps({k: torch.from_numpy(v) for k, v in g.items()},
                       {k: torch.from_numpy(v) for k, v in p.items()})
    outs = []
    for mod, taps in ((jnum, jt), (tnum, tt)):
        mod_flags = paddle.set_flags if mod is jnum else tflags.set_flags
        mod_flags({'FLAGS_check_nan_inf': True})
        try:
            outs.append(mod.process_jit_taps(taps, site='s', step=2))
        except mod.NumericsError as e:
            outs.append(e.report)
        finally:
            mod_flags({'FLAGS_check_nan_inf': False})
    want, got = outs
    if nan:
        assert got['first_bad'] == want['first_bad'] == 'g1'
        assert [t['name'] for t in got['tensors']] == \
            [t['name'] for t in want['tensors']]
        return
    assert got['grad_norm'] == pytest.approx(want['grad_norm'], rel=1e-6)
    for kind in ('grads', 'params'):
        for k in g:
            a, b = got[kind][k].as_dict(), want[kind][k].as_dict()
            for f in tnum.STAT_FIELDS:
                assert a[f] == pytest.approx(b[f], rel=1e-6, abs=1e-7), f


def _pipeline(scale=None):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline as tsp)
    from paddle_tpu_torch.models import gpt as tgpt
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=16, hidden_dropout=0.0,
                         attn_dropout=0.0)
    eng = tsp.SpmdPipelineEngine(
        *tgpt.build_gpt_pipeline(cfg, generator=torch.Generator()
                                 .manual_seed(0)),
        topt.AdamW(learning_rate=1e-3), accumulate_steps=2, device='cpu')
    ids = np.random.RandomState(0).randint(0, 64, (4, 16)).astype('int32')
    return eng, (ids, np.roll(ids, -1, 1))


def test_pipeline_taps_one_fetch_a_step_and_the_clip_norm(monkeypatch):
    tflags.set_flags({'FLAGS_tensor_stats': True})
    eng, batch = _pipeline()
    calls = _count_fetches(monkeypatch)
    eng.train_batch(batch)
    assert len(calls) == 1
    gn = tmon.metrics().get('ptpu_num_grad_norm_global').value()
    clip = tnn.ClipGradByGlobalNorm(1.0)
    want = float(clip.global_norm([(p, a) for a, (_, p)
                                   in zip(eng._acc, eng._named)]))
    assert gn == pytest.approx(want, rel=1e-5)
    assert eng.last_numerics['grad_norm'] == gn
    eng.shutdown()


def _poison(monkeypatch, eng, value):
    """Make the step's gradient of the engine's fourth parameter hold one
    `value`; returns that parameter's name."""
    name = eng._named[3][0]
    real = eng._grads

    def poisoned():
        for (n, _p), g in zip(eng._named, real()):
            if n == name:
                g = g.clone()
                g.view(-1)[0] = value
            yield g
    monkeypatch.setattr(eng, '_grads', poisoned)
    return name


def test_pipeline_taps_name_a_planted_nan(monkeypatch):
    tflags.set_flags({'FLAGS_check_nan_inf': True})
    eng, batch = _pipeline()
    name = _poison(monkeypatch, eng, float('nan'))
    with pytest.raises(tnum.NumericsError) as ei:
        eng.train_batch(batch)
    assert ei.value.report['first_bad'] == name
    assert name in str(ei.value)


def test_pipeline_taps_skip_a_loss_scale_overflow(monkeypatch):
    """A loss-scaled step whose gradient overflowed is skipped (its
    found-inf flag set) and its taps are not checked; the next clean
    step's are."""
    tflags.set_flags({'FLAGS_check_nan_inf': True})
    eng, batch = _pipeline()
    _poison(monkeypatch, eng, float('inf'))
    scaler = tamp.GradScaler(init_loss_scaling=8.0,
                             decr_every_n_nan_or_inf=1)
    skipped = tmon.metrics().counter(
        'ptpu_amp_skipped_steps_total').value()
    before = [p.detach().clone() for _, p in eng._named]
    eng.train_step(batch, scaler=scaler)
    eng.flush()                               # no NumericsError
    assert eng.last_numerics is None and scaler._scale == 4.0
    assert all(torch.equal(a, p.detach())
               for a, (_, p) in zip(before, eng._named))
    assert tmon.metrics().counter(
        'ptpu_amp_skipped_steps_total').value() == skipped + 1
    monkeypatch.undo()
    tflags.set_flags({'FLAGS_check_nan_inf': True})
    eng.train_step(batch, scaler=scaler)
    eng.flush()
    assert eng.last_numerics is not None


def test_trainstep_taps_publish_and_trip():
    from paddle_tpu_torch import jit as tjit
    tflags.set_flags({'FLAGS_tensor_stats': True})
    net = torch.nn.Linear(4, 1)
    step = tjit.TrainStep(net, lambda m, x: (m(x) ** 2).mean(),
                          topt.SGD(learning_rate=0.1), device='cpu')
    step(torch.ones(3, 4))
    assert set(step.last_numerics['grads']) == {'weight', 'bias'}
    led = step.flush()
    assert led is None or led['engine'] == 'jit'
    tflags.set_flags({'FLAGS_tensor_stats': False,
                      'FLAGS_check_nan_inf': True})
    step = tjit.TrainStep(net, lambda m, x: (m(x) ** 2).mean(),
                          topt.SGD(learning_rate=0.1), device='cpu')
    with pytest.raises(tnum.NumericsError):
        step(torch.full((3, 4), float('inf')))


# ---------------------------------------------------------------------------
# sentinel, clip, snapshot
# ---------------------------------------------------------------------------
def test_divergence_fingerprint_and_vote_equal_the_reference():
    rng = np.random.RandomState(9)
    params = {f'p{i}': rng.normal(0, 1, (16, 8)).astype(np.float32)
              for i in range(3)}
    from paddle_tpu.core.tensor import Tensor
    want = jnum.DivergenceSentinel().fingerprint(
        grad_norm=1.5, params={k: Tensor(v) for k, v in params.items()})
    got = tnum.DivergenceSentinel().fingerprint(
        grad_norm=1.5, params={k: torch.from_numpy(v)
                               for k, v in params.items()})
    np.testing.assert_allclose(got, want, rtol=1e-6)
    fps = [np.array([1.0, 2.0, 3.0])] * 2 + [np.array([1.0, 2.5, 3.0])] \
        + [np.array([np.nan, 2.0, 3.0])] * 2
    for fp_set in (fps, fps[:2], [fps[0], fps[2]]):
        assert tnum.DivergenceSentinel()._vote(fp_set) == \
            jnum.DivergenceSentinel()._vote(fp_set)
    assert tnum.DivergenceSentinel().check(1, grad_norm=1.0) is None


def test_global_norm_clip_publishes_the_preclip_norm():
    tflags.set_flags({'FLAGS_tensor_stats': True})
    net, _opt = _linear()
    pg = [(p, torch.ones_like(p)) for p in net.parameters()]
    tnn.ClipGradByGlobalNorm(1.0)(pg)
    assert tmon.metrics().get('ptpu_num_grad_norm_preclip').value(
        site='global_norm_clip') == pytest.approx(6 ** 0.5)
    # inside the eager step the boundary publishes; the clip is silent
    net, opt = _linear()
    opt._grad_clip = tnn.ClipGradByGlobalNorm(1.0)
    for p in net.parameters():
        p.grad = torch.full_like(p, 2.0)
    opt.step()
    assert tmon.metrics().get('ptpu_num_grad_norm_global').value() == \
        pytest.approx(2 * 6 ** 0.5)
    assert tmon.metrics().get('ptpu_num_grad_norm_preclip').value(
        site='global_norm_clip') == pytest.approx(6 ** 0.5)


def test_snapshot_has_the_reference_keys():
    assert set(tnum.snapshot()) == set(jnum.snapshot())
