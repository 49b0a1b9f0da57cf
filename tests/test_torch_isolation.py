"""paddle_tpu_torch stands alone: it imports neither jax nor paddle_tpu,
and its entry points never drop to the CPU on their own."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / 'paddle_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'paddle_tpu')


def _port_files():
    return sorted(PORT.rglob('*.py')) + [REPO / 'chip_smoke.py']


def _forbidden(name):
    return any(name == f or name.startswith(f + '.') for f in FORBIDDEN)


def test_port_imports_with_jax_and_paddle_tpu_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'paddle_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, paddle_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         timeout=300)
    assert res.returncode == 0, res.stderr.decode()
    assert int(res.stdout.decode().split()[-1]) >= 15


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_names_jax_or_paddle_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ''):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', None)) in (
                    'import_module', '__import__'):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f'{path.name} imports {bad}'


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


@pytest.fixture(scope='module')
def tiny_model():
    return tgpt.GPTForCausalLM(tgpt.GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
        max_seq_len=64), generator=torch.Generator().manual_seed(0))


def test_engine_without_device_raises_without_cuda(no_cuda, tiny_model):
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ServingEngine(tiny_model, ServingConfig(page_size=8))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ServingEngine(tiny_model, ServingConfig(page_size=8), device='cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tiny_model.generate_batch([[1, 2, 3]], max_new_tokens=2)
    eng = ServingEngine(tiny_model, ServingConfig(page_size=8),
                        device='cpu')
    out = eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert len(out[0]) == 5


# the modules of the BERT leg, the transformer stack and the hybrid engine,
# which the blocked import above must reach
BERT_PATH_MODULES = ('paddle_tpu_torch.core.flags',
                    'paddle_tpu_torch.nn.layer.transformer',
                    'paddle_tpu_torch.models.bert',
                    'paddle_tpu_torch.distributed.topology_runtime',
                    'paddle_tpu_torch.distributed.fleet.meta_parallel.'
                    'hybrid_engine')
# the vision legs' layers, functional namespace, initializers and models
VISION_PATH_MODULES = ('paddle_tpu_torch.nn.layer.conv',
                       'paddle_tpu_torch.nn.layer.pooling',
                       'paddle_tpu_torch.nn.layer.norm',
                       'paddle_tpu_torch.nn.layer.activation',
                       'paddle_tpu_torch.nn.layer.container',
                       'paddle_tpu_torch.nn.functional',
                       'paddle_tpu_torch.nn.initializer',
                       'paddle_tpu_torch.vision.models',
                       'paddle_tpu_torch.vision.models.lenet',
                       'paddle_tpu_torch.vision.models.resnet',
                       'paddle_tpu_torch.vision.models.vgg',
                       'paddle_tpu_torch.vision.models.mobilenet')

# the parameter server's wire, tables, communicator and runtime
PS_PATH_MODULES = ('paddle_tpu_torch.core.native',
                   'paddle_tpu_torch.distributed.ps',
                   'paddle_tpu_torch.distributed.ps.service',
                   'paddle_tpu_torch.distributed.ps.communicator',
                   'paddle_tpu_torch.distributed.ps.ps_runtime')


# the CTR training path: the data feed's generators and datasets, the
# entry policies, the sparse embedding, the CTR models, metrics and ops
CTR_PATH_MODULES = ('paddle_tpu_torch.distributed',
                    'paddle_tpu_torch.distributed.entry_attr',
                    'paddle_tpu_torch.distributed.fleet',
                    'paddle_tpu_torch.distributed.fleet.data_generator',
                    'paddle_tpu_torch.distributed.fleet.data_generator.'
                    'data_generator',
                    'paddle_tpu_torch.distributed.fleet.dataset',
                    'paddle_tpu_torch.distributed.fleet.metrics',
                    'paddle_tpu_torch.distributed.ps.embedding',
                    'paddle_tpu_torch.models.deepfm',
                    'paddle_tpu_torch.models.wide_deep',
                    'paddle_tpu_torch.metric',
                    'paddle_tpu_torch.ops.recsys')
ALONE_MODULES = (BERT_PATH_MODULES + VISION_PATH_MODULES + PS_PATH_MODULES
                 + CTR_PATH_MODULES)

# One interpreter imports torch and numpy once, blocks jax, jaxlib and
# paddle_tpu, then forks a child a module: the child imports it alone and
# reports its exit code and traceback. A fresh interpreter a module spent
# most of its time importing torch again.
_IMPORT_ALONE = """
import json, os, sys, traceback
import numpy, torch
for m in ('jax', 'jaxlib', 'paddle_tpu'):
    sys.modules[m] = None
import importlib
out = {}
for mod in json.loads(sys.argv[1]):
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        rc, msg = 0, ''
        try:
            importlib.import_module(mod)
        except BaseException:
            rc, msg = 1, traceback.format_exc()
        os.write(w, msg.encode())
        os._exit(rc)
    os.close(w)
    with os.fdopen(r, 'rb') as f:
        msg = f.read().decode()
    _, status = os.waitpid(pid, 0)
    out[mod] = {'rc': os.waitstatus_to_exitcode(status), 'traceback': msg}
print(json.dumps(out))
"""


@pytest.fixture(scope='module')
def imported_alone():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run(
        [sys.executable, '-c', _IMPORT_ALONE, json.dumps(ALONE_MODULES)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        timeout=300)
    assert res.returncode == 0, res.stderr.decode()
    return json.loads(res.stdout.decode().splitlines()[-1])


@pytest.mark.parametrize('module', ALONE_MODULES)
def test_new_module_imports_alone_with_jax_blocked(module, imported_alone):
    got = imported_alone[module]
    assert got['rc'] == 0, got['traceback']
    path = REPO / (module.replace('.', '/') + '.py')
    package = REPO / module.replace('.', '/') / '__init__.py'
    assert path in _port_files() or package in _port_files()


def test_hybrid_engine_and_generate_need_the_card_unless_asked(no_cuda,
                                                              tiny_model):
    from paddle_tpu_torch.distributed import topology_runtime as ttr
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        hybrid_engine as the)
    from paddle_tpu_torch.optimizer import SGD

    ttr.build_mesh(['dp', 'sharding'], [1, 1])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        the.HybridParallelTrainStep(tiny_model, lambda m, x: m(x).sum(),
                                    SGD())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tiny_model.generate(np.zeros((1, 2), np.int64), max_new_tokens=1)
    eng = the.HybridParallelTrainStep(tiny_model, lambda m, x: m(x).sum(),
                                      SGD(), device='cpu')
    assert eng.device.type == 'cpu'


def test_vision_legs_need_the_card_unless_asked(no_cuda):
    from paddle_tpu_torch import jit as tjit
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import topology_runtime as ttr
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        hybrid_engine as the)
    from paddle_tpu_torch.vision.models import LeNet, resnet18

    def loss(m, x, y):
        return m(x).sum()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tjit.TrainStep(LeNet(), loss, topt.Adam())
    ttr.build_mesh(['dp'], [1])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        the.HybridParallelTrainStep(resnet18(num_classes=10), loss,
                                    topt.Momentum(0.1))
    step = tjit.TrainStep(LeNet(), loss, topt.Adam(), device='cpu')
    assert step.device.type == 'cpu'
    assert all(b.device.type == 'cpu' for b in step.model.buffers())


def test_seeded_init_is_reproducible_and_follows_paddle_init():
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=64)
    a = tgpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(5))
    b = tgpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(5))
    for (n, p), (_n, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    p = {n: t.detach() for n, t in a.named_parameters()}
    assert float(p['gpt.layers.0.ln1.weight'].min()) == 1.0
    assert not p['gpt.layers.0.mlp.fc1.bias'].any()
    std = float(p['gpt.embeddings.word_embeddings.weight'].std())
    assert 0.015 < std < 0.025                     # Normal(0, 0.02)
    out_std = float(p['gpt.layers.0.attn.out_proj.weight'].std())
    assert out_std < 0.02 / np.sqrt(4) * 1.3       # 0.02 / sqrt(2 * L)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(REPO / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout.decode()


def test_worker_entry_module_holds_no_jax_or_paddle_tpu(tmp_path):
    """A fresh interpreter that imports the worker replica's entry module
    and runs what a worker runs (its model and engine, a warm-up, the
    control server, the watchdog's report and exit record) holds no
    module of jax or paddle_tpu."""
    code = (
        "import json, sys\n"
        "from paddle_tpu_torch.serving.cluster import replica as r\n"
        "from paddle_tpu_torch.serving import ServingConfig\n"
        "m = r.worker_model(dict(vocab_size=64, hidden_size=32,\n"
        "    num_layers=1, num_heads=2, max_seq_len=64), 0, device='cpu')\n"
        "e = r.build_engine(m, ServingConfig(page_size=8,\n"
        "    disaggregate=True), device='cpu')\n"
        "e.generate([[1, 2, 3]], max_new_tokens=2, top_k=0)\n"
        f"w = r.ReplicaWorker(e, 'w0', report_dir={str(tmp_path)!r})\n"
        "w._fire_watchdog('test')\n"
        "rec = w.exit_record()\n"
        "w.stop()\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'jaxlib',\n"
        "    'paddle_tpu') or n.startswith(('jax.', 'jaxlib.',\n"
        "    'paddle_tpu.')))\n"
        "print(json.dumps(dict(bad=bad, device=rec['device'])))\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         timeout=300)
    assert res.returncode == 0, res.stderr.decode()
    out = json.loads(res.stdout.decode().splitlines()[-1])
    assert out == {'bad': [], 'device': 'cpu'}
    assert (tmp_path / 'replica_hang.w0.json').exists()


@pytest.mark.parametrize('case', ['no_compiler', 'compiler_fails',
                                  'build_dir_unwritable'])
def test_native_loader_raises_when_the_build_fails(monkeypatch, tmp_path,
                                                   case):
    """The port's table loader raises where the reference's
    `load_native()` returns None; the real build is left alone (a fresh
    build directory, and the loaded library's cache put back after)."""
    from paddle_tpu_torch.core import native
    build_dir = tmp_path / 'build'
    if case == 'build_dir_unwritable':
        (tmp_path / 'file').write_text('')
        build_dir = tmp_path / 'file' / 'build'      # under a regular file
    monkeypatch.setenv('PADDLE_TPU_TORCH_BUILD_DIR', str(build_dir))
    monkeypatch.setenv('CXX', {'no_compiler': str(tmp_path / 'no-g++'),
                               'compiler_fails': 'false'}.get(case, 'g++'))
    monkeypatch.setattr(native, '_LIB', None)
    with pytest.raises((RuntimeError, OSError)) as err:
        native.load_native()
    if case != 'build_dir_unwritable':
        assert 'native build failed' in str(err.value)
    with pytest.raises((RuntimeError, OSError)):
        native.NativeSparseTable(4)
    assert native._LIB is None
    if build_dir.is_dir():
        assert not list(build_dir.rglob('*.so'))
