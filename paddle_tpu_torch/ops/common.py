"""Op-definition helpers — counterpart of `paddle_tpu/ops/common.py`.

`OP_REGISTRY` maps an op's reference name to its port function, as the
reference's does for its static executor; `register` adds one.

`as_tensor` boxes an operand as the reference's does (:24-30): a Python
int or float beside a tensor takes that tensor's dtype, so
`add(int32 tensor, 1.5)` adds the int32 1, and a bf16 tensor is scaled
by a scalar rounded to bf16 (torch would promote the first to float and
leave the second in fp32). Such a scalar stays a 0-dim CPU tensor, which
torch's elementwise ops take beside a tensor on any device. Other data
(lists, numpy arrays) becomes a tensor on the reference operand's
device.

`unary`, `binary` and `defop` build an op as the reference's do
(:41-80): inside `amp.auto_cast` the op's floating inputs are cast as
its reference name's lists say (`amp.run_hooked`). The port's other ops
stand for one `run_op` of the reference, which its hook never sees, and
are marked `@uncast`.

`convert_dtype` maps paddle's dtype names (`core/dtypes.py:33-56` there)
to torch dtypes.
"""
import numpy as np
import torch

from ..amp import run_hooked

OP_REGISTRY = {}


def register(name, fn):
    OP_REGISTRY[name] = fn
    return fn


def register_public(namespace, names):
    """Register a module's public ops under their paddle names (the
    reference registers only the ops its static executor looks up; the
    port's registry lists the whole surface, which chip_smoke.py's
    sweep runs)."""
    for n in names:
        OP_REGISTRY.setdefault(n, namespace[n])


_STR2DTYPE = {
    'bool': torch.bool, 'uint8': torch.uint8, 'int8': torch.int8,
    'int16': torch.int16, 'int32': torch.int32, 'int64': torch.int64,
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'float32': torch.float32, 'float64': torch.float64,
    'complex64': torch.complex64, 'complex128': torch.complex128,
}


def convert_dtype(dtype):
    """A paddle dtype spec (a name, a numpy dtype or a torch dtype) as a
    torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR2DTYPE:
            raise TypeError(f'Unsupported dtype string: {dtype!r}')
        return _STR2DTYPE[dtype]
    name = np.dtype(dtype).name
    if name not in _STR2DTYPE:
        raise TypeError(f'Unsupported dtype: {dtype!r}')
    return _STR2DTYPE[name]


def _is_scalar(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def as_tensor(x, ref=None):
    """`x` as a tensor: a tensor as it is; a Python int or float beside
    the tensor `ref` as a 0-dim CPU tensor of ref's dtype; anything else
    through torch.as_tensor, on ref's device when there is one."""
    if isinstance(x, torch.Tensor):
        return x
    if ref is not None and _is_scalar(x):
        return torch.tensor(x, dtype=ref.dtype)
    return torch.as_tensor(x, device=None if ref is None else ref.device)


def _promote(x, y):
    """Binary boxing (:58-67): a scalar follows the tensor operand."""
    if isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        return x, as_tensor(y, ref=x)
    if isinstance(y, torch.Tensor) and not isinstance(x, torch.Tensor):
        return as_tensor(x, ref=y), y
    return as_tensor(x), as_tensor(y)


def defop(name, fn):
    """An op over positional operands, each after the first boxed
    against the first."""
    def op(*args, **kwargs):
        kwargs.pop('name', None)
        tensors = []
        for a in args:
            tensors.append(as_tensor(a, ref=tensors[0] if tensors else None))
        return run_hooked(name, fn, tensors, kwargs)
    op.__name__ = name
    return register(name, op)


def unary(name, fn):
    def op(x, name=None, **kwargs):
        return run_hooked(name_, fn, [as_tensor(x)], kwargs)
    name_ = name
    op.__name__ = name
    return register(name, op)


def binary(name, fn):
    def op(x, y, name=None, **kwargs):
        return run_hooked(name_, fn, list(_promote(x, y)), kwargs)
    name_ = name
    op.__name__ = name
    return register(name, op)
