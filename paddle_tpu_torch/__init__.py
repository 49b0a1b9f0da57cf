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
only, once an input file.
"""

__version__ = '0.1.0'


def __getattr__(name):
    if name == 'resolve_device':
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
