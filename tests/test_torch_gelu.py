"""The port's plain GELU on the first call in a process.

`paddle_tpu_torch.ops.kernels.fused_elementwise.gelu_f32` and
`gelu_grad_f32` are the CPU route of the bias+GELU forward and backward
(and of `nn_ops.gelu`). torch's fp32 tanh, erf, erfc and exp on the CPU
can err by up to ~1e-4 relative on one intra-op thread's share of the
elements on the FIRST such call in a process, so each form runs here as
the first tensor work of fresh Python processes with 8 intra-op threads,
on [300, 2048] fp32 inputs from seed 22 (the bias+GELU backward tests'
inputs), and is held against the float64 formula (numpy and scipy) at
the fp32 bar, rtol 2e-4 / atol 2e-5. The race strikes a fraction of
fresh processes, so each form gets PROCESSES of them.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import special

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(rtol=2e-4, atol=2e-5)
PROCESSES = 3
THREADS = 8
C = math.sqrt(2.0 / math.pi)

# the child: its first tensor work is the form under test
CHILD = r'''
import sys
import numpy as np
import torch
torch.set_num_threads({threads})
from paddle_tpu_torch.ops.kernels import fused_elementwise as fe
u = torch.from_numpy(np.load(sys.argv[1]))
fn = fe.gelu_grad_f32 if {grad} else fe.gelu_f32
np.save(sys.argv[2], fn(u, {approximate}).numpy())
'''


def _inputs():
    rng = np.random.RandomState(22)
    x = (2 * rng.randn(300, 2048)).astype(np.float32)
    b = rng.randn(2048).astype(np.float32)
    return x + b


def _float64(u, grad, approximate):
    u = u.astype(np.float64)
    if approximate:
        t = np.tanh(C * (u + 0.044715 * u ** 3))
        if grad:
            return 0.5 * (1 + t) + 0.5 * u * (1 - t * t) * C * \
                (1 + 3 * 0.044715 * u ** 2)
        return u * 0.5 * (1 + t)
    cdf = 0.5 * special.erfc(-u / math.sqrt(2.0))
    if grad:
        return cdf + u * np.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return u * cdf


@pytest.mark.parametrize('approximate', [True, False], ids=['tanh', 'erf'])
@pytest.mark.parametrize('grad', [False, True], ids=['gelu', 'gelu_grad'])
def test_plain_gelu_is_right_on_the_first_call_in_a_process(
        tmp_path, grad, approximate):
    u = _inputs()
    np.save(tmp_path / 'u.npy', u)
    want = _float64(u, grad, approximate)
    code = CHILD.format(threads=THREADS, grad=grad, approximate=approximate)
    env = dict(os.environ, PYTHONPATH=REPO)
    for i in range(PROCESSES):
        out = tmp_path / f'out{i}.npy'
        subprocess.run([sys.executable, '-c', code, str(tmp_path / 'u.npy'),
                        str(out)], env=env, check=True, timeout=300)
        np.testing.assert_allclose(np.load(out), want, **FP32,
                                   err_msg=f'fresh process {i}')
