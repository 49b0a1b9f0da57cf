"""paddle.autograd — counterpart of `paddle_tpu/autograd/__init__.py`:
`PyLayer`, `backward`, and `grad` (`framework.grad`).

A `PyLayer` subclass writes paddle's static `forward(ctx, *args,
**kwargs)` and `backward(ctx, *grads)`, the latter returning one
gradient per tensor argument of `forward` (None for one that needs
none). `apply` runs it as a `torch.autograd.Function` made once a
class, so the backward is a node of torch's graph: it runs under
`torch.no_grad()` unless the caller's backward builds a graph
(`create_graph=True`). `ctx.save_for_backward(*tensors)` and
`ctx.saved_tensor()` are paddle's names for torch's saved tensors.
"""
import torch
from torch import enable_grad, no_grad  # noqa: F401

from ..framework import grad  # noqa: F401


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of `tensors` into the leaves' `.grad`."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    if isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors]
    torch.autograd.backward(list(tensors), grad_tensors,
                            retain_graph=retain_graph)


class PyLayerContext:
    """Paddle's context over torch's: what `save_for_backward` keeps,
    `saved_tensor()` returns; any other attribute is the user's."""

    def __init__(self, torch_ctx):
        self._ctx = torch_ctx

    def save_for_backward(self, *tensors):
        self._ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return list(self._ctx.saved_tensors)


def _function(cls):
    """The torch.autograd.Function that runs `cls`'s forward and backward."""
    fn = cls.__dict__.get('_torch_function')
    if fn is not None:
        return fn

    def forward(tctx, kwargs, *args):
        ctx = tctx.paddle_ctx = PyLayerContext(tctx)
        tctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        return cls.forward(ctx, *args, **kwargs)

    def backward(tctx, *grads):
        got = cls.backward(tctx.paddle_ctx, *grads)
        got = iter(got if isinstance(got, (tuple, list)) else (got,))
        return (None,) + tuple(next(got, None) if t else None
                               for t in tctx.is_tensor)

    fn = type(f'{cls.__name__}Function', (torch.autograd.Function,),
              {'forward': staticmethod(forward),
               'backward': staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    """Subclass with static `forward(ctx, *args, **kwargs)` and
    `backward(ctx, *grads)`; call `apply(*args, **kwargs)`."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function(cls).apply(kwargs, *args)


LegacyPyLayer = PyLayer
