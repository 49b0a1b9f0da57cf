"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu for NVIDIA
Hopper (H100), beside the JAX package it is ported from.

This package imports torch, numpy and the standard library only; it
never imports jax or any module of paddle_tpu. Its first slice serves a
GPT causal LM through continuous batching over a paged KV pool
(`serving.ServingEngine`, `models.GPTForCausalLM.generate_batch`), with
the attention, LayerNorm and bias+GELU on that path as hand-written
CUDA kernels for sm_90a (`csrc/`, built and bound by
`ops/kernels/_build.py`). Entry points run on the card unless the
caller passes device='cpu'.

Importing the package imports no torch: a generator script that a
dataset's pipe_command runs imports `distributed.fleet.data_generator`
only, once an input file. The op surface (`paddle.add`, `paddle.concat`,
`paddle.randn`, `paddle.to_tensor`, `paddle.seed`, `paddle.linalg`,
`paddle.fft`, `paddle.ParamAttr`, the dtype names, ...), what
`paddle_tpu/__init__.py:18-61` and `:118-121` re-export, and the
high-level names (`paddle.Model`, `summary`, `save`, `load`, `grad`, and
the modules `io`, `hapi`, `text`, `distribution`, `autograd`, ...,
`:66-123` there) resolve at their first use through the module
`__getattr__` (PEP 562).
"""
import importlib

__version__ = '0.1.0'

_MATH = (
    'add subtract multiply divide floor_divide remainder mod pow maximum '
    'minimum fmax fmin exp expm1 log log2 log10 log1p sqrt rsqrt square abs '
    'sign floor ceil round trunc reciprocal neg sin cos tan asin acos atan '
    'sinh cosh tanh asinh acosh atanh atan2 erf lgamma digamma scale clip '
    'increment stanh matmul bmm mm dot inner outer kron cross mv addmm sum '
    'mean max min prod amax amin nansum nanmean logsumexp all any std var '
    'median mode quantile cumsum cumprod argmax argmin argsort sort topk '
    'nonzero equal not_equal less_than less_equal greater_than '
    'greater_equal equal_all allclose isclose logical_and logical_or '
    'logical_xor logical_not bitwise_and bitwise_or bitwise_xor bitwise_not '
    'isnan isinf isfinite nan_to_num norm dist where multiplex trace diag '
    'diag_embed lerp frac rad2deg deg2rad gcd lcm count_nonzero heaviside '
    'histogram broadcast_shape clip_by_norm sigmoid bincount bucketize '
    'searchsorted take tensordot logcumsumexp renorm diff trapezoid vander '
    'angle conj polar crop')
_MANIP = (
    'cast reshape transpose moveaxis swapaxes squeeze unsqueeze flatten '
    'concat stack split chunk unstack unbind tile expand expand_as '
    'broadcast_to broadcast_tensors flip roll rot90 gather gather_nd '
    'take_along_axis put_along_axis scatter scatter_nd scatter_nd_add '
    'index_select index_sample masked_select slice strided_slice tril triu '
    'diagonal unique unique_consecutive one_hot shard_index meshgrid '
    'repeat_interleave as_complex as_real real imag numel shape masked_fill')
_CREATION = (
    'zeros ones full empty zeros_like ones_like full_like empty_like arange '
    'linspace logspace eye assign clone diagflat complex uniform rand randn '
    'normal standard_normal randint randint_like randperm bernoulli poisson '
    'multinomial gaussian to_tensor')
_LAZY = {'resolve_device': ('device', 'resolve_device'),
         'seed': ('core.rng', 'seed'),
         'get_rng_state': ('core.rng', 'get_rng_state'),
         'set_rng_state': ('core.rng', 'set_rng_state'),
         'einsum': ('ops.linalg', 'einsum'),
         'ParamAttr': ('nn.layer.common', 'ParamAttr'),
         'linalg': ('ops.linalg', None), 'fft': ('ops.fft', None),
         'Model': ('hapi', 'Model'), 'summary': ('hapi', 'summary'),
         'save': ('framework', 'save'), 'load': ('framework', 'load'),
         'grad': ('framework', 'grad')}
_LAZY.update((m, (m, None)) for m in (
    'io', 'hapi', 'text', 'distribution', 'autograd', 'framework', 'nn',
    'optimizer', 'metric', 'vision', 'jit', 'utils'))
for _mod, _names in (('ops.math', _MATH), ('ops.manip', _MANIP),
                     ('ops.creation', _CREATION)):
    _LAZY.update((n, (_mod, n)) for n in _names.split())
_DTYPES = ('bool uint8 int8 int16 int32 int64 float16 bfloat16 float32 '
           'float64 complex64 complex128').split()
del _mod, _names


def __getattr__(name):
    if name in _DTYPES:
        import torch
        return getattr(torch, name)
    if name not in _LAZY:
        raise AttributeError(
            f'module {__name__!r} has no attribute {name!r}')
    mod, attr = _LAZY[name]
    mod = importlib.import_module(f'{__name__}.{mod}')
    return mod if attr is None else getattr(mod, attr)
