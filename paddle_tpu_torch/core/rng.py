"""The dropout RNG — counterpart of `paddle_tpu/core/rng.py`'s
`rng_guard` and `next_key`.

The reference threads one functional `jax.random` key through a step
(`rng_guard(key)` in `jit.TrainStep._step`) and every dropout folds the
next counter into it. The port keeps a stack of bound `torch.Generator`s
instead: `jit.TrainStep` owns one on its device, seeded from its `seed=`
argument, and binds it around its forward; a dropout op in training
draws its keep mask from the generator bound last. Nothing draws from
torch's default generator, and a dropout op in training with no
generator bound raises, so a mask never comes from an unseeded stream.

The two frameworks' streams cannot agree (threefry against Philox): the
tests replace `keep_mask` on both sides with the same numpy masks.
"""
import contextlib

import torch

_BOUND = []


@contextlib.contextmanager
def rng_guard(generator):
    """Bind `generator` for the dropout draws inside the block."""
    _BOUND.append(generator)
    try:
        yield generator
    finally:
        _BOUND.pop()


def bound_generator():
    """The generator bound last, or None when none is bound."""
    return _BOUND[-1] if _BOUND else None


def current_generator():
    """The generator bound last; raises when none is bound."""
    if not _BOUND:
        raise RuntimeError(
            'dropout in training needs a bound generator: jit.TrainStep '
            'binds its own (seed=...); elsewhere wrap the forward in '
            'paddle_tpu_torch.core.rng.rng_guard(torch.Generator(device))')
    return _BOUND[-1]


def keep_mask(shape, keep_prob, device):
    """A bool keep mask of `shape` on `device`: each element is kept
    with probability `keep_prob`, drawn from the bound generator as
    jax.random.bernoulli draws its mask. The draw writes the one-byte
    mask directly, so no fp32 uniforms of the mask's size (2 GiB for an
    attention mask at gpt_1p3b's training shape) are ever held."""
    return torch.empty(tuple(shape), dtype=torch.bool,
                       device=device).bernoulli_(keep_prob,
                                                 generator=current_generator())
