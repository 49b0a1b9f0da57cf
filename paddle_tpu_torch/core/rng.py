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

The random ops (`ops/creation.py`) and the initializers draw from the
package generator of their device (`generator(device)`), or from a
`generator=` the caller passes: one `torch.Generator` a device, seeded
0 until `seed(s)` seeds them all (and those made later) with s, as the
reference's `_GeneratorState(seed=0)` is (:49-67 there).
`get_rng_state()` is {device name: state} of the generators made so
far, which `set_rng_state` restores.
"""
import contextlib

import torch

_BOUND = []
_SEED = [0]
_GENERATORS = {}


def _key(device):
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return str(dev)


def generator(device):
    """The package generator of `device`, made (and seeded with the
    current seed) at its first use; None for the meta device, where a
    draw fills nothing (a model built there is loaded later)."""
    if torch.device(device).type == 'meta':
        return None
    key = _key(device)
    gen = _GENERATORS.get(key)
    if gen is None:
        gen = _GENERATORS[key] = torch.Generator(device=key)
        gen.manual_seed(_SEED[0])
    return gen


def seed(s):
    """Seed every package generator, and those made later, with `s`
    (parity: paddle.seed)."""
    _SEED[0] = int(s)
    for gen in _GENERATORS.values():
        gen.manual_seed(_SEED[0])


def get_rng_state():
    """{device name: generator state} of the package generators."""
    return {k: g.get_state() for k, g in _GENERATORS.items()}


def set_rng_state(state):
    """Restore the states `get_rng_state` returned."""
    for key, st in state.items():
        generator(key).set_state(st)


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
