"""Shared helpers of the op-surface tests (tests/test_torch_ops_*.py,
test_torch_losses.py, test_torch_conv_family.py): run a reference op of
`paddle_tpu` and the port's op of the same name on the same seeded numpy
inputs, forward and, where the op is differentiable, the VJP with a
seeded cotangent.

Values are compared as float64 (index outputs by value: the port's are
int64, the reference's int32 under JAX's 32-bit default). The bar is
the round's fp32 one, rtol 2e-4 / atol 2e-5, unless a case states its
own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor

FP32 = dict(rtol=2e-4, atol=2e-5)


def jax_value(out):
    """A reference result (a Tensor, a jax array, a tuple or list of
    them, or a Python value) as a list of numpy arrays."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in jax_value(o)]
    if isinstance(out, Tensor):
        out = out.data
    return [np.asarray(out)]


def torch_value(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in torch_value(o)]
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return [out.resolve_conj().numpy()]
    return [np.asarray(out)]


def assert_same(got, want, bar=FP32, what=''):
    got, want = torch_value(got), jax_value(want)
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f'{what} [{i}]')
        else:
            np.testing.assert_allclose(
                g.astype(np.complex128 if np.iscomplexobj(g) else
                         np.float64), w, err_msg=f'{what} [{i}]', **bar)


def _jax_args(arrays):
    return [Tensor(jnp.asarray(a)) if isinstance(a, np.ndarray) else a
            for a in arrays]


def _torch_args(arrays, grad=()):
    out = []
    for i, a in enumerate(arrays):
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(a.copy())
            if i in grad:
                t.requires_grad_(True)
            out.append(t)
        else:
            out.append(a)
    return out


def check_op(jfn, tfn, arrays, kw=None, diff=(), bar=FP32, what='',
             out_index=None):
    """Forward of jfn and tfn on `arrays` (numpy arrays, or other
    arguments passed as they are) with `kw`, and, for the argument
    indices in `diff`, the gradients of sum(out · cot) with a cotangent
    drawn from seed 7. `out_index` picks one output of a tuple for the
    VJP."""
    kw = kw or {}
    targs = _torch_args(arrays, diff)
    got = tfn(*targs, **kw)
    if not diff or out_index is not None:
        assert_same(got, jfn(*_jax_args(arrays), **kw), bar, what)
    if not diff:
        return

    def pick(o):
        return o[out_index] if out_index is not None else o

    def f(*xs):
        args = list(_jax_args(arrays))
        for i, x in zip(diff, xs):
            args[i] = Tensor(x)
        with no_grad():
            o = pick(jfn(*args, **kw))
        return o.data if isinstance(o, Tensor) else o
    # one jitted forward and backward (op by op, every primitive of the
    # reference compiles on its own)
    out, vjp = jax.vjp(jax.jit(f), *[jnp.asarray(arrays[i]) for i in diff])
    tout = pick(got)
    if out_index is None:
        assert_same(tout, out, bar, what)
    cot = np.asarray(np.random.RandomState(7).randn(*out.shape),
                     dtype=out.dtype)
    jgrads = vjp(jnp.asarray(cot))
    tout.backward(torch.from_numpy(cot))
    for i, jg in zip(diff, jgrads):
        tg = targs[i].grad
        assert tg is not None, (what, 'no grad', i)
        np.testing.assert_allclose(tg.numpy().astype(np.float64),
                                   np.asarray(jg), err_msg=f'{what} grad {i}',
                                   **bar)


def rand(rng, *shape, low=None, high=None):
    if low is not None:
        return rng.uniform(low, high, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)
