"""Activation recompute and the named remat policies — counterpart of
`paddle_tpu/distributed/fleet/utils/recompute.py`.

The reference wraps a traced function in `jax.checkpoint` under a named
policy (`apply_policy`) and lets XLA rematerialise in the fused
backward. The port runs eagerly, so a policy is
`torch.utils.checkpoint.checkpoint(fn, use_reentrant=False)`: the
forward keeps what the policy saves and the backward re-runs `fn` for
the rest.

  * 'none'                — no checkpoint; autograd keeps every saved
                            tensor;
  * 'full'                — save nothing but the inputs; the backward
                            re-runs the whole function;
  * 'dots'                — save every contraction output (the aten
                            mm/addmm/bmm/baddbmm/mv/dot that
                            `torch.matmul` reaches), as `dots_saveable`
                            saves every dot_general output;
  * 'attn_mlp_boundaries' — keep only the tensors the models tag with
                            `tag_tensor` (BOUNDARY_NAMES), as
                            `save_only_these_names` does.

'dots' runs on `create_selective_checkpoint_contexts`, which decides per
dispatcher op. The port's CUDA kernels are `ctypes` launches inside
autograd Functions that the dispatcher does not see, so no policy saves
a kernel's output and the kernels run again in the backward; the
reference is the same, since no policy of the reference saves a
`pallas_call` output either.

'attn_mlp_boundaries' is built from checkpointed segments. A model cuts
its forward at the tags into stretches, each run through `segment`:
inside a boundaries region (`apply_policy`) a stretch is a checkpoint of
its own, which keeps its inputs (the tagged tensors before it) and in
the backward re-runs that stretch alone; elsewhere it is a plain call.
So the tagged tensors are kept and their producers are not run again,
as under XLA's remat: a stretch that ends in a projection stops its
recompute before the product (the checkpoint's early stop: the product
saves only its inputs). Code of the region outside any segment keeps
what autograd keeps.

Dropout draws its keep masks from the generator that `core.rng.rng_guard`
binds (the step's or the engine's), which `torch.utils.checkpoint`'s
`preserve_rng_state` does not restore. Every checkpoint here records the
bound generator's state when the forward runs and, around the
recompute, binds that generator again at that state, so the masks
replay and the gradients are those of the forward (the reference gets
the same from its folded keys).

A recompute re-runs the forward, which would update batch norm's
running statistics a second time; `in_recompute()` is true while any
checkpoint here re-runs its function, and `ops.nn_ops.batch_norm` leaves
them alone then, so they move once a step as under the reference's
functional remat.

Resolution (`resolve_policy`): the kwarg, then `PTPU_REMAT_POLICY`, then
the caller's default. Remat changes no value: loss and gradients are
bit-equal under every policy (tests/test_torch_remat.py).
"""
import collections
import contextlib
import functools
import os

import torch
from torch.utils import checkpoint as _ckpt

from ....core import rng as _rng

# the checkpoint_name tags the models emit at contraction boundaries
BOUNDARY_NAMES = ('attn_qkv', 'attn_ctx', 'attn_out',
                  'mlp_fc1', 'mlp_out', 'embed_out')

POLICY_NAMES = ('none', 'full', 'attn_mlp_boundaries', 'dots')

_aten = torch.ops.aten
_DOT_OPS = frozenset((_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default, _aten.baddbmm.default,
                      _aten.mv.default, _aten.dot.default))
_MUST_SAVE = _ckpt.CheckpointPolicy.MUST_SAVE
_RECOMPUTE = _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class _State:
    """Boundary regions entered: while one is, `segment` checkpoints.
    Recomputes running: the backward may run them on autograd's device
    thread, so the count is global, not per thread."""
    regions = 0
    recomputing = 0


def in_recompute():
    """True while a checkpoint's backward re-runs its function."""
    return _State.recomputing > 0


_BOUNDARIES = collections.Counter()
_POLICIES = {}


def _save_dots(ctx, func, *args, **kwargs):
    return _MUST_SAVE if func in _DOT_OPS else _RECOMPUTE


# checkpoint_policy's marker of the segmented policy
_SEGMENTS = 'segments'


def checkpoint_policy(name):
    """(remat_on, how) for a named policy: `how` is None (one
    checkpoint keeping its inputs), a selective policy function, or
    `_SEGMENTS`; raises ValueError on an unknown name."""
    if name in (None, 'none', False):
        return False, None
    if name in ('full', True):
        return True, None
    if name == 'attn_mlp_boundaries':
        return True, _SEGMENTS
    if name == 'dots':
        return True, _save_dots
    raise ValueError(
        f"unknown remat policy {name!r}; expected one of {POLICY_NAMES}")


def resolve_policy(policy=None, default='none'):
    """The policy NAME (validated): the kwarg, then the
    `PTPU_REMAT_POLICY` env var, then `default` (None when nothing was
    given and `default` is None). The reference's third step, the fleet
    strategy's `recompute_configs['policy']`, waits for the port's fleet
    base (ROADMAP Queue 1 item 7)."""
    if policy is None:
        policy = os.environ.get('PTPU_REMAT_POLICY') or None
    if policy is None:
        policy = default
    if policy is None:
        return None
    if policy is True:
        policy = 'full'
    if policy is False:
        policy = 'none'
    checkpoint_policy(policy)   # validate early, not at the first step
    return policy


@contextlib.contextmanager
def _replay(gen, state):
    """Bind `gen` at the forward's `state` for a recompute, then put it
    back where the backward found it."""
    later = gen.get_state()
    gen.set_state(state)
    try:
        with _rng.rng_guard(gen):
            yield
    finally:
        gen.set_state(later)


@contextlib.contextmanager
def _recomputing():
    """While it is entered, `in_recompute()` holds."""
    _State.recomputing += 1
    try:
        yield
    finally:
        _State.recomputing -= 1


@contextlib.contextmanager
def _boundary_region():
    _State.regions += 1
    try:
        yield
    finally:
        _State.regions -= 1


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _contexts(policy_fn, replay=True):
    """checkpoint's context_fn: (forward, recompute) contexts. Called
    when the forward starts, so the bound generator's state is the
    forward's; without `replay` the recompute draws where it stands."""
    gen = _rng.bound_generator() if replay else None
    replay = _both(_recomputing(), contextlib.nullcontext() if gen is None
                   else _replay(gen, gen.get_state()))
    if policy_fn is None:
        return contextlib.nullcontext(), replay
    f, r = _ckpt.create_selective_checkpoint_contexts(policy_fn)
    return f, _both(replay, r)


def apply_policy(fn, policy, engine=None):
    """`fn` under the named policy ('none' returns fn unchanged); records
    the policy under `engine` for `snapshot()`."""
    name = policy if isinstance(policy, str) else (
        'full' if policy else 'none')
    on, policy_fn = checkpoint_policy(name)
    if engine is not None:
        _POLICIES[engine] = name
    if not on:
        return fn
    if policy_fn is _SEGMENTS:
        @functools.wraps(fn)
        def segmented(*args, **kwargs):
            with _boundary_region():
                return fn(*args, **kwargs)
        return segmented

    @functools.wraps(fn)
    def remat(*args, **kwargs):
        return _ckpt.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(_contexts, policy_fn), **kwargs)
    return remat


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True):
    """Parity: paddle.distributed.fleet.utils.recompute (:105). Runs
    `function(*args)` keeping only its inputs; the backward re-runs it.
    With `preserve_rng_state` the recompute replays the bound dropout
    generator and torch's default generators. `use_reentrant` is taken
    for paddle's signature; the port always runs the non-reentrant
    checkpoint, which also gives gradients to parameters used inside."""
    if not torch.is_grad_enabled():
        return function(*args)
    return _ckpt.checkpoint(function, *args, use_reentrant=False,
                            preserve_rng_state=preserve_rng_state,
                            context_fn=functools.partial(
                                _contexts, None, preserve_rng_state))


def segment(fn, *args):
    """`fn(*args)`, one stretch of a forward between two boundary tags.
    Inside an 'attn_mlp_boundaries' region, with gradients on, it is a
    checkpoint of its own that keeps `args` and replays the bound dropout
    generator; elsewhere a plain call."""
    if not _State.regions or not torch.is_grad_enabled():
        return fn(*args)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=functools.partial(_contexts, None))


def tag_tensor(t, name):
    """The `checkpoint_name` tag: an identity that counts into
    `boundary_counts()` (every call, recompute included)."""
    _BOUNDARIES[name] += 1
    return t


tag = tag_tensor


def boundary_counts():
    """{tag name: calls}."""
    return dict(_BOUNDARIES)


def snapshot():
    """The `remat` record: the policy each engine applied last and the
    boundary-tag counts; None when nothing was recorded."""
    bounds = boundary_counts()
    if not _POLICIES and not bounds:
        return None
    return {'policies': dict(_POLICIES), 'boundaries': bounds,
            'boundary_total': int(sum(bounds.values()))}
