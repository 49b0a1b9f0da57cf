"""The port's `hapi.Model` against `paddle_tpu.hapi.Model` on bridged
weights, the same MNIST batches (one `np.random.seed` shuffles both)
and the reference's small net (tests/test_e2e_train.py:58-73:
Flatten-Linear(784, 32)-ReLU-Linear(32, 10), Adam 1e-3,
CrossEntropyLoss, Accuracy), on the CPU.

- Eager `fit`: the per-step losses equal the reference's, and so do
  `evaluate`'s loss and accuracy and `predict`'s outputs; with
  `accumulate_grad_batches=2` too. The jit route (`jit.TrainStep`)
  equals the eager route and the reference's eager losses.
- Callbacks (`EarlyStopping`, `ReduceLROnPlateau`, `LRSchedulerCallback`,
  `ModelCheckpoint`) fire at the reference's epochs; `summary` counts
  equal the reference's.
- Save, then load into a fresh `Model`: on both routes the loaded model
  continues exactly as the saved one does. The checkpoint crosses the
  packages: the reference's `.pdparams` / `.pdopt` (its keys name its
  parameters from a process-wide counter) load into the port by
  position, and the port's `.pdparams` load into the reference.
- Reference faults the port does not copy (ROADMAP Queue 3): after a
  jit fit the reference's `.pdopt` holds no moments; the reference's
  `.pdopt` loaded into a fresh reference model keys its states by names
  the fresh parameters never look up; `accumulate_grad_batches > 1`
  with `jit=True` and `amp_configs` are refused.

Tolerances: the round's fp32 bars, rtol 2e-4 / atol 2e-5.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import hapi as jhapi
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.metric import Accuracy as JAccuracy
from paddle_tpu.vision.datasets import MNIST as JMNIST
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.io import TensorDataset as TTensorDataset
from paddle_tpu_torch.metric import Accuracy as TAccuracy
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.vision.datasets import MNIST as TMNIST
from test_torch_vision_models import numpy_draws
from torch_threads import one_intra_op_thread  # noqa: F401

FP32 = dict(rtol=2e-4, atol=2e-5)
STEPS = 5


def _nets():
    with numpy_draws(2):
        jnet = jnn.Sequential(jnn.Flatten(), jnn.Linear(784, 32), jnn.ReLU(),
                              jnn.Linear(32, 10))
    tnet = tnn.Sequential(tnn.Flatten(), tnn.Linear(784, 32), tnn.ReLU(),
                          tnn.Linear(32, 10))
    load_jax_params(tnet, _params(jnet))
    return jnet, tnet


def _params(net):
    return {n: np.asarray(p.data) if not isinstance(p, torch.Tensor)
            else p.detach().numpy() for n, p in net.named_parameters()}


def _jmodel(net, jit=False):
    m = jhapi.Model(net)
    m.prepare(jopt.Adam(learning_rate=1e-3, parameters=net.parameters()),
              jnn.CrossEntropyLoss(), JAccuracy(), jit=jit)
    return m


def _tmodel(net, jit=False):
    m = thapi.Model(net, device='cpu')
    m.prepare(topt.Adam(learning_rate=1e-3, parameters=net.parameters()),
              tnn.CrossEntropyLoss(), TAccuracy(), jit=jit)
    return m


def _recording(model):
    """Record each train_batch's loss."""
    losses = []
    inner = model.train_batch

    def train_batch(*a, **k):
        out = inner(*a, **k)
        losses.append((out[0] if isinstance(out, tuple) else out)[0][0])
        return out
    model.train_batch = train_batch
    return losses


def _fit(model, ds, steps=STEPS, seed=0, **kw):
    losses = _recording(model)
    np.random.seed(seed)
    model.fit(ds, epochs=1, batch_size=64, verbose=0, num_iters=steps, **kw)
    return losses


@pytest.fixture(scope='module')
def reference_run():
    jnet, tnet = _nets()
    jm = _jmodel(jnet)
    losses = _fit(jm, JMNIST(mode='train'))
    ev = jm.evaluate(JMNIST(mode='test'), batch_size=128, verbose=0)
    pred = jm.predict(JTensorDataset([JMNIST(mode='test').images[:96]
                                      .astype(np.float32)[:, None] / 255.0]),
                      batch_size=48, stack_outputs=True)
    return dict(tnet=tnet, losses=losses, eval=ev, pred=pred,
                params=_params(jnet), jnet=jnet, jm=jm)


def test_eager_fit_evaluate_predict_match_reference(reference_run):
    ref = reference_run
    tnet = tnn.Sequential(tnn.Flatten(), tnn.Linear(784, 32), tnn.ReLU(),
                          tnn.Linear(32, 10))
    _, start = _nets()
    tnet.load_state_dict(start.state_dict())
    tm = _tmodel(tnet)
    losses = _fit(tm, TMNIST(mode='train'))
    np.testing.assert_allclose(losses, ref['losses'], **FP32)
    ev = tm.evaluate(TMNIST(mode='test'), batch_size=128, verbose=0)
    assert set(ev) == set(ref['eval']) == {'loss', 'acc'}
    np.testing.assert_allclose(ev['loss'], ref['eval']['loss'], **FP32)
    assert ev['acc'] == pytest.approx(float(ref['eval']['acc']))
    pred = tm.predict(TTensorDataset([TMNIST(mode='test').images[:96]
                                      .astype(np.float32)[:, None] / 255.0]),
                      batch_size=48, stack_outputs=True)
    np.testing.assert_allclose(pred[0], ref['pred'][0], **FP32)
    for n, p in _params(tnet).items():
        np.testing.assert_allclose(p, ref['params'][n], rtol=2e-4,
                                   atol=2 * 1e-3 * STEPS, err_msg=n)


def test_jit_route_equals_eager_route(reference_run):
    runs = []
    for jit in (False, True):
        _, tnet = _nets()
        tm = _tmodel(tnet, jit=jit)
        runs.append((_fit(tm, TMNIST(mode='train')), _params(tnet), tm))
    (el, ep, _), (jl, jp, jm) = runs
    assert jm._train_step is not None and jm._train_step.use_buckets
    np.testing.assert_allclose(jl, el, **FP32)
    np.testing.assert_allclose(jl, reference_run['losses'], **FP32)
    for n in ep:
        np.testing.assert_allclose(jp[n], ep[n], **FP32)


def test_accumulated_gradients_match_reference():
    jnet, tnet = _nets()
    want = _fit(_jmodel(jnet), JMNIST(mode='train'), steps=4,
                accumulate_grad_batches=2)
    got = _fit(_tmodel(tnet), TMNIST(mode='train'), steps=4,
               accumulate_grad_batches=2)
    np.testing.assert_allclose(got, want, **FP32)
    for n, p in _params(tnet).items():
        np.testing.assert_allclose(p, _params(jnet)[n], **FP32)


def test_refusals():
    _, tnet = _nets()
    with pytest.raises(NotImplementedError, match='drops the'):
        _tmodel(tnet, jit=True).fit(TMNIST(mode='test'), batch_size=64,
                                    verbose=0, accumulate_grad_batches=2)
    with pytest.raises(NotImplementedError, match='amp_configs'):
        thapi.Model(tnet, device='cpu').prepare(amp_configs={'level': 'O1'})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            thapi.Model(tnet)


def _tiny(mod, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(32, 6).astype(np.float32)
    y = rng.randint(0, 3, (32, 1)).astype(np.int64)
    return mod.TensorDataset([x, y])


class _Epochs:
    """Epoch-end recorder: (epoch, lr) pairs."""

    def __init__(self, base):
        class Rec(base):
            def __init__(self):
                super().__init__()
                self.seen = []

            def on_epoch_end(self, epoch, logs=None):
                self.seen.append((epoch, round(self.model._optimizer
                                               .get_lr(), 9)))
        self.cb = Rec()


def _callback_run(pkg, nnm, optm, io, cbs, save_dir):
    with numpy_draws(3):
        net = nnm.Linear(6, 3)
    m = pkg.Model(net) if pkg is jhapi else pkg.Model(net, device='cpu')
    sched = optm.lr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    m.prepare(optm.SGD(learning_rate=sched, parameters=net.parameters())
              if 'sched' in cbs else
              optm.SGD(learning_rate=0.1, parameters=net.parameters()),
              nnm.CrossEntropyLoss())
    rec = _Epochs(pkg.Callback).cb
    save_dir.mkdir()
    made = []
    for name in cbs:
        if name == 'early':
            made.append(pkg.EarlyStopping(monitor='loss', patience=2,
                                          min_delta=10))
        elif name == 'plateau':
            made.append(pkg.ReduceLROnPlateau(monitor='loss', patience=1,
                                              factor=0.5, min_delta=10,
                                              cooldown=1, verbose=0))
        elif name == 'sched':
            made.append(pkg.LRSchedulerCallback(by_step=False,
                                                by_epoch=True))
        elif name == 'ckpt':
            made.append(pkg.ModelCheckpoint(save_freq=2,
                                            save_dir=str(save_dir)))
    np.random.seed(0)
    m.fit(_tiny(io), epochs=6, batch_size=16, verbose=0,
          callbacks=made + [rec])
    return rec.seen, sorted(os.listdir(save_dir))


@pytest.mark.parametrize('cbs', [('early',), ('plateau',), ('sched',),
                                 ('ckpt',)])
def test_callbacks_fire_at_reference_epochs(cbs, tmp_path):
    from paddle_tpu import io as jio
    from paddle_tpu_torch import io as tio
    want = _callback_run(jhapi, jnn, jopt, jio, cbs, tmp_path / 'ref')
    got = _callback_run(thapi, tnn, topt, tio, cbs, tmp_path / 'port')
    assert got == want
    assert len(want[0]) < 6 if cbs == ('early',) else len(want[0]) == 6


def test_summary_counts_match_reference(capsys):
    from paddle_tpu.hapi import summary as jsum
    with numpy_draws(4):
        jnet = jnn.Sequential(jnn.Linear(6, 5), jnn.LSTM(5, 4, num_layers=2,
                                                         direction='bidirect'))
    tnet = tnn.Sequential(tnn.Linear(6, 5), tnn.LSTM(
        5, 4, num_layers=2, direction='bidirect', device='cpu'))
    tnet[0].weight.requires_grad_(False)
    jnet[0].weight.stop_gradient = True
    assert thapi.summary(tnet) == jsum(jnet)
    assert tpaddle.summary(tnet)['trainable_params'] == \
        jsum(jnet)['trainable_params']


@pytest.mark.parametrize('jit', [False, True])
def test_save_load_resumes_with_equal_state(jit, tmp_path):
    _, tnet = _nets()
    tm = _tmodel(tnet, jit=jit)
    _fit(tm, TMNIST(mode='train'), steps=3)
    tm.save(str(tmp_path / 'ck'))
    keys = list(tpaddle.load(str(tmp_path / 'ck.pdopt')))
    assert keys[:4] == ['param_0.moment1', 'param_0.moment2',
                        'param_0.beta1_pow', 'param_0.beta2_pow']
    assert keys[-1] == '@step' and len(keys) == 4 * 4 + 1
    fresh = tnn.Sequential(tnn.Flatten(), tnn.Linear(784, 32), tnn.ReLU(),
                           tnn.Linear(32, 10))
    tm2 = _tmodel(fresh, jit=jit)
    tm2.load(str(tmp_path / 'ck'))
    ev = [m.evaluate(TMNIST(mode='test'), batch_size=256, verbose=0)['loss']
          for m in (tm, tm2)]
    assert ev[0] == ev[1]
    cont = [_fit(m, TMNIST(mode='train'), steps=2, seed=9) for m in (tm, tm2)]
    np.testing.assert_array_equal(cont[0], cont[1])
    for n, p in _params(tnet).items():
        np.testing.assert_array_equal(_params(fresh)[n], p)


def test_checkpoints_cross_the_packages(reference_run, tmp_path):
    ref = reference_run
    path = str(tmp_path / 'ref')
    ref['jm'].save(path)
    # the reference's files into the port, by position
    tm = _tmodel(tnn.Sequential(tnn.Flatten(), tnn.Linear(784, 32),
                                tnn.ReLU(), tnn.Linear(32, 10)))
    tm.load(path)
    for n, p in _params(tm.network).items():
        np.testing.assert_array_equal(p, ref['params'][n])
    jsd = jpaddle.load(path + '.pdopt')
    tsd = tm._optimizer.state_dict()
    assert tsd['@step'] == jsd['@step'] == STEPS
    jnames = list(dict.fromkeys(k.rsplit('.', 1)[0] for k in jsd
                                if k != '@step'))
    for i, jn in enumerate(jnames):
        for st in ('moment1', 'moment2', 'beta1_pow', 'beta2_pow'):
            np.testing.assert_array_equal(
                tsd[f'param_{i}.{st}'].numpy().reshape(-1),
                np.asarray(jsd[f'{jn}.{st}'].data).reshape(-1))
    # the port's parameters into the reference
    tm.save(str(tmp_path / 'port'))
    jnet, _ = _nets()
    jm = _jmodel(jnet)
    jm.load(str(tmp_path / 'port'))
    for n, p in _params(jnet).items():
        np.testing.assert_array_equal(p, ref['params'][n])
    # reference fault: its states land under the saved names, which its
    # fresh parameters never look up
    assert not ({p.name for p in jnet.parameters()} &
                {k.rsplit('.', 1)[0] for k in jm._optimizer._accumulators})


def test_frozen_parameter_checkpoints(tmp_path):
    """A frozen parameter keeps no states: the port's own file loads by
    name; the reference's, whose counter names match nothing here,
    holds fewer parameters than the model and is refused, not matched
    by position."""
    jnet, tnet = _nets()
    jnet[1].weight.stop_gradient = True
    jm = _jmodel(jnet)
    _fit(jm, JMNIST(mode='train'), steps=1)
    jm.save(str(tmp_path / 'ref'))
    jsd = jpaddle.load(str(tmp_path / 'ref.pdopt'))
    assert len({k.rsplit('.', 1)[0] for k in jsd if k != '@step'}) == 3
    tnet[1].weight.requires_grad_(False)
    tm = _tmodel(tnet)
    _fit(tm, TMNIST(mode='train'), steps=1)
    tm.save(str(tmp_path / 'port'))
    _, fresh = _nets()
    fresh[1].weight.requires_grad_(False)
    tm2 = _tmodel(fresh)
    tm2.load(str(tmp_path / 'port'))
    want = tm._optimizer.state_dict()
    got = tm2._optimizer.state_dict()
    assert list(got) == list(want) and 'param_0.moment1' not in got
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match='one for'):
        tm2._optimizer.set_state_dict(jsd)


def test_optimizer_states_refuse_a_name_out_of_place():
    """Equal counts, but a ParamAttr name of the file stands where this
    model has another parameter: refused rather than matched by
    position."""
    _, tnet = _nets()
    tnet[1].bias.param_name = 'fc_b'
    opt = topt.Adam(learning_rate=1e-3, parameters=tnet.parameters())
    ones = {n: np.ones(p.shape, np.float32)
            for n, p in tnet.named_parameters()}
    sd = {f'{k}.moment1': ones[n] for k, n in zip(
        ('param_7', 'fc_w', 'param_9', 'param_10'),
        ('1.weight', '1.bias', '3.weight', '3.bias'))}
    with pytest.raises(ValueError, match='one for'):
        opt.set_state_dict(sd)
    sd = {f'{k}.moment1': ones[n] for k, n in zip(
        ('param_7', 'fc_b', 'param_9', 'param_10'),
        ('1.weight', '1.bias', '3.weight', '3.bias'))}
    opt.set_state_dict(sd)
    assert sorted(opt.state_dict()) == ['@step', 'fc_b.moment1',
                                        'param_0.moment1', 'param_2.moment1',
                                        'param_3.moment1']


def test_reference_jit_checkpoint_holds_no_moments(tmp_path):
    jnet, _ = _nets()
    jm = _jmodel(jnet, jit=True)
    _fit(jm, JMNIST(mode='train'), steps=2)
    jm.save(str(tmp_path / 'ref'))
    assert set(jpaddle.load(str(tmp_path / 'ref.pdopt'))) == {'@step'}
    _, tnet = _nets()
    tm = _tmodel(tnet, jit=True)
    _fit(tm, TMNIST(mode='train'), steps=2)
    tm.save(str(tmp_path / 'port'))
    sd = tpaddle.load(str(tmp_path / 'port.pdopt'))
    assert sd['@step'] == 2 and float(sd['param_0.moment2'].abs().sum()) > 0


def test_top_level_names_resolve_lazily():
    from paddle_tpu_torch import autograd, distribution, framework, io, text
    assert tpaddle.Model is thapi.Model and tpaddle.summary is thapi.summary
    assert (tpaddle.save, tpaddle.load, tpaddle.grad) == \
        (framework.save, framework.load, framework.grad)
    assert (tpaddle.io, tpaddle.text, tpaddle.distribution,
            tpaddle.autograd, tpaddle.hapi) == (io, text, distribution,
                                                autograd, thapi)
    assert tnn.LSTM and tnn.BeamSearchDecoder and tnn.dynamic_decode
