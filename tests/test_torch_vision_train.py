"""The vision legs' engines on the CPU: paddle_tpu_torch's TrainStep and
HybridParallelTrainStep on models with batch norm, against
`paddle_tpu`'s on bridged weights and buffers and the same numpy
batches.

- LeNet, 3 steps of `TrainStep` on its default bucketed route with Adam
  at its defaults, as the `lenet_mnist` leg (`bench.py:333-360`) runs it,
  against `paddle_tpu.jit.TrainStep`: losses and parameters.
- A conv + batch norm + bottleneck net, 3 steps of
  `HybridParallelTrainStep` on a degree-1 ['dp'] mesh with Momentum(0.1,
  0.9), as the `resnet50_dp_bf16` leg runs ResNet-50, against the JAX
  engine: losses and parameters. The port's running statistics move every
  step, as PaddlePaddle's do and as both packages' `TrainStep` move them;
  they equal the JAX `TrainStep`'s on the same batches. The JAX engine
  binds the parameters only and restores every buffer on exit
  (`hybrid_engine.py:398-399`, `jit/__init__.py:36-58`), so its running
  statistics stay at (0, 1): a test records that, and the port does not
  copy it (ROADMAP Queue 3).
- Remat: the recompute re-runs the forward, and must leave the running
  statistics alone; under 'full' and 'dots' they, the losses and the
  parameters are bit-equal to 'none' (one CPU thread, so the products
  sum in one order every run).

Tolerances: the round's fp32 bars, rtol 2e-4 / atol 2e-5, except Adam's
parameters, held as tests/test_torch_train.py holds them: atol
2 * lr * steps, 99.9 % of the elements within 1e-5 (Adam divides a
gradient that is rounding noise by its own magnitude, so such an
element moves by up to lr a step either way).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import topology_runtime as jtr
from paddle_tpu.distributed.fleet.meta_parallel import hybrid_engine as jhe
from paddle_tpu.vision import models as jvm
from paddle_tpu.vision.models import resnet as jres
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import topology_runtime as ttr
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    hybrid_engine as the)
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.vision import models as tvm
from test_torch_multi_update import _count_lists
from test_torch_vision_models import _named, numpy_draws

FP32 = dict(rtol=2e-4, atol=2e-5)
STEPS = 3


def _jax_xent(m, x, y):
    return jnn.functional.cross_entropy(m(x), y)


def _torch_xent(m, x, y):
    return tnn.functional.cross_entropy(m(x), y)


def _batches(shape, classes, n=STEPS, seed=0):
    """The same random batch n times, as the bench legs feed it."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(*shape).astype(np.float32),
             rng.randint(0, classes, (shape[0],)).astype(np.int64))] * n


# ---------------------------------------------------------------------------
# LeNet on TrainStep (the lenet_mnist leg)
# ---------------------------------------------------------------------------
def test_lenet_trainstep_matches_jax(monkeypatch):
    seen = _count_lists(monkeypatch)
    with numpy_draws(1):
        jm = jvm.LeNet(10)
    tm = tvm.LeNet(10)
    load_jax_params(tm, *_named(jm))
    jstep = jjit.TrainStep(jm, _jax_xent, paddle.optimizer.Adam(
        parameters=jm.parameters()))
    tstep = tjit.TrainStep(tm, _torch_xent, topt.Adam(), device='cpu')
    assert tstep.use_buckets and len(tstep.layout.buckets) == 1
    jl, tl = [], []
    for img, lb in _batches((16, 1, 28, 28), 10):
        jl.append(float(jstep(Tensor(jnp.asarray(img)), Tensor(lb)).data))
        tl.append(float(tstep(torch.from_numpy(img), torch.from_numpy(lb))))
    assert seen == [1] * STEPS               # one update list a step
    np.testing.assert_allclose(tl, jl, **FP32)
    assert tl[-1] < tl[0]
    jstep.sync_model()
    jp = _named(jm)[0]
    lr = 1e-3
    for n, p in tm.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, jp[n], rtol=0, atol=2 * lr * STEPS,
                                   err_msg=n)
        assert (np.abs(got - jp[n]) <= 1e-5).mean() >= 0.999, n


# ---------------------------------------------------------------------------
# a conv + batch norm + bottleneck net on HybridParallelTrainStep
# ---------------------------------------------------------------------------
def _net(nn, models, **kw):
    """conv, batch norm, ReLU, a strided bottleneck block with its
    downsample, a basic block, the global pool and a linear: the same
    sublayer names on both sides."""
    class Net(nn.Layer if hasattr(nn, 'Layer') else torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 16, 3, padding=1, bias_attr=False, **kw)
            self.bn = nn.BatchNorm2D(16, **{k: v for k, v in kw.items()
                                            if k != 'generator'})
            self.relu = nn.ReLU()
            down = nn.Sequential(
                nn.Conv2D(16, 16, 1, stride=2, bias_attr=False, **kw),
                nn.BatchNorm2D(16, **{k: v for k, v in kw.items()
                                      if k != 'generator'}))
            self.block = models.BottleneckBlock(16, 4, stride=2,
                                                downsample=down, **kw)
            self.basic = models.BasicBlock(16, 16, **kw)
            self.pool = nn.AdaptiveAvgPool2D(1)
            self.fc = nn.Linear(16, 10, **kw)

        def forward(self, x):
            x = self.relu(self.bn(self.conv(x)))
            x = self.pool(self.basic(self.block(x)))
            return self.fc(x.reshape([x.shape[0], -1]))
    return Net()


def _net_pair(seed=2, dtype=None):
    with numpy_draws(seed):
        jm = _net(jnn, jres)
    tm = _net(tnn, tvm, dtype=dtype)
    load_jax_params(tm, *_named(jm))
    return jm, tm


NET_SHAPE = (8, 3, 16, 16)


def _momentum(params=None):
    if params is None:
        return topt.Momentum(learning_rate=0.1, momentum=0.9)
    return paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=params)


def test_hybrid_engine_matches_jax_and_moves_the_running_statistics(
        monkeypatch):
    seen = _count_lists(monkeypatch)
    jm, tm = _net_pair()
    initial = _named(jm)[1]
    jtr.build_mesh(['dp'], [1])
    ttr.build_mesh(['dp'], [1])
    jeng = jhe.HybridParallelTrainStep(jm, _jax_xent,
                                       _momentum(jm.parameters()))
    teng = the.HybridParallelTrainStep(tm, _torch_xent, _momentum(),
                                       device='cpu')
    jl, tl = [], []
    for img, lb in _batches(NET_SHAPE, 10):
        jl.append(float(jeng(Tensor(jnp.asarray(img)), Tensor(lb)).data))
        tl.append(float(teng(img, lb)))
    assert seen == [len(teng.params)] * STEPS
    np.testing.assert_allclose(tl, jl, **FP32)
    assert tl[-1] < tl[0]
    jp = {n: np.asarray(a) for n, a in jeng._params.items()}
    jeng.shutdown()
    for n, p in teng.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jp[n], err_msg=n,
                                   **FP32)
    # the reference engine drops the update: its buffers never move
    after_jax = _named(jm)[1]
    for n, v in after_jax.items():
        np.testing.assert_array_equal(v, initial[n], err_msg=n)
        assert (v == (0.0 if n.endswith('_mean') else 1.0)).all(), n

    # the port's move as the JAX TrainStep's do on the same batches
    jm2, _ = _net_pair()
    jstep = jjit.TrainStep(jm2, _jax_xent, _momentum(jm2.parameters()),
                           use_buckets=False)
    for img, lb in _batches(NET_SHAPE, 10):
        jstep(Tensor(jnp.asarray(img)), Tensor(lb))
    jb = {n: np.asarray(a) for n, a in jstep._buffers.items()}
    tb = dict(tm.named_buffers())
    assert set(tb) == set(jb)
    for n, b in tb.items():
        np.testing.assert_allclose(b.numpy(), jb[n], err_msg=n, **FP32)
        assert not np.array_equal(b.numpy(), initial[n]), n


def _train(engine, policy, batches=None, dtype=None, seed=3):
    """(losses, {param: array}, {buffer: array}) after STEPS steps of the
    net on `engine` under `policy`, on one CPU thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _jm, tm = _net_pair(seed, dtype=dtype)
        if engine == 'hybrid':
            ttr.build_mesh(['dp'], [1])
            eng = the.HybridParallelTrainStep(
                tm, _torch_xent, _momentum(), remat_policy=policy,
                device='cpu')
        else:
            eng = tjit.TrainStep(tm, _torch_xent, topt.Adam(),
                                 remat_policy=policy, device='cpu')
        dt = dtype or torch.float32
        losses = [float(eng(torch.from_numpy(img).to(dt),
                            torch.from_numpy(lb)))
                  for img, lb in batches or _batches(NET_SHAPE, 10)]
        return (losses,
                {n: p.detach().float().numpy().copy()
                 for n, p in tm.named_parameters()},
                {n: b.numpy().copy() for n, b in tm.named_buffers()})
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize('policy', ['full', 'dots'])
@pytest.mark.parametrize('engine', ['trainstep', 'hybrid'])
def test_remat_updates_running_statistics_once_a_step(engine, policy):
    ref = _train(engine, 'none')
    got = _train(engine, policy)
    assert got[0] == ref[0]
    for want, have in zip(ref[1:], got[1:]):
        assert set(want) == set(have)
        for n in want:
            np.testing.assert_array_equal(have[n], want[n], err_msg=n)


def test_bf16_hybrid_step_keeps_fp32_statistics_and_masters():
    """The ResNet leg's configuration on the net: bf16 parameters (every
    fp32 one cast), fp32 buffers, Momentum with fp32 masters."""
    losses, params, buffers = _train('hybrid', 'none', dtype=torch.bfloat16)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    _jm, tm = _net_pair(3, dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    for n, v in buffers.items():
        assert np.isfinite(v).all() and not np.array_equal(
            v, np.zeros_like(v) if n.endswith('_mean') else np.ones_like(v))
    ttr.build_mesh(['dp'], [1])
    eng = the.HybridParallelTrainStep(tm, _torch_xent, _momentum(),
                                      device='cpu')
    eng(torch.rand(NET_SHAPE).bfloat16(), torch.zeros(8, dtype=torch.long))
    states = eng.named_opt_states()
    assert all(st['master'].dtype == torch.float32 for st in states.values())


def test_bf16_running_statistics_match_an_fp32_update_of_the_same_batch():
    """One bf16 train-mode forward moves the fp32 buffers by the fp32
    statistics of the bf16 input, as the reference takes them."""
    _jm, tm = _net_pair(4, dtype=torch.bfloat16)
    x = torch.rand(NET_SHAPE).bfloat16()
    with torch.no_grad():
        tm(x)
    with torch.no_grad():
        var, mean = torch.var_mean(tm.conv(x).float(), dim=(0, 2, 3),
                                   correction=0)
    np.testing.assert_allclose(tm.bn._mean.numpy(), 0.1 * mean.numpy(),
                               **FP32)
    np.testing.assert_allclose(tm.bn._variance.numpy(),
                               0.9 + 0.1 * var.numpy(), **FP32)
