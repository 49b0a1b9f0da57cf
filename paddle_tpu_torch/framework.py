"""`paddle.save`, `paddle.load` and `paddle.grad` — counterpart of
`paddle_tpu/framework.py:89-181`.

`save` writes the reference's format: a pickle (protocol 4) of the
object with every tensor as a numpy array, so a `.pdparams` or `.pdopt`
written by either package loads in the other. A bf16 tensor is saved as
fp32 (exact; numpy has no bf16, and the whitelist below admits no
extension dtype); `set_state_dict` casts it back to the parameter's
dtype. `load` unpickles through the same whitelist as the reference
(numpy arrays and dtypes, `OrderedDict`), so a crafted checkpoint cannot
run code, and returns CPU torch tensors (numpy arrays with
`return_numpy=True`).

`grad` is `torch.autograd.grad` under the reference's contract: the
graph is retained unless `retain_graph=False`, an input the outputs do
not reach raises unless `allow_unused=True` (then its gradient is None),
and `create_graph=True` returns gradients that are themselves
differentiable (double and triple grad).
"""
import pickle

import numpy as np
import torch


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(obj, dict):
        return type(obj)((k, _to_saveable(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` with its tensors as numpy arrays (framework/io.py:550)."""
    with open(path, 'wb') as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


class _SafeUnpickler(pickle.Unpickler):
    """Resolves only the numpy and container globals a state dict needs."""

    _ALLOWED = {
        ('collections', 'OrderedDict'),
        ('numpy', 'ndarray'), ('numpy', 'dtype'),
        ('numpy.core.multiarray', '_reconstruct'),
        ('numpy._core.multiarray', '_reconstruct'),
        ('numpy.core.multiarray', 'scalar'),
        ('numpy._core.multiarray', 'scalar'),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"paddle.load: refusing to unpickle global {module}.{name} "
            "(only numpy arrays / containers are allowed in checkpoints)")


def load(path, **configs):
    """The object `save` wrote, its arrays as CPU tensors (or numpy
    arrays with `return_numpy=True`)."""
    with open(path, 'rb') as f:
        obj = _SafeUnpickler(f).load()
    if configs.get('return_numpy', False):
        return obj

    def back(o):
        if isinstance(o, np.ndarray):
            return torch.from_numpy(np.array(o))
        if isinstance(o, dict):
            return type(o)((k, back(v)) for k, v in o.items())
        if isinstance(o, (list, tuple)):
            return type(o)(back(v) for v in o)
        return o
    return back(obj)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """d(outputs)/d(inputs) as a list, leaving every `.grad` alone."""
    if no_grad_vars is not None:
        raise NotImplementedError(
            'paddle.grad(no_grad_vars=...) is not ported: the reference '
            'accepts it and ignores it')
    if isinstance(outputs, torch.Tensor):
        outputs = [outputs]
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    if isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    inputs = list(inputs)
    grads = torch.autograd.grad(
        list(outputs), inputs, grad_outputs=grad_outputs,
        retain_graph=True if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=True)
    for i, g in enumerate(grads):
        if g is None and not allow_unused:
            raise RuntimeError(
                f"paddle.grad: input {i} is unreachable from outputs "
                "(no grad path); pass allow_unused=True to get None "
                "instead")
    return list(grads)
