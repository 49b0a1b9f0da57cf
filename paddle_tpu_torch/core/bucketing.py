"""Flat optimizer buckets — counterpart of `paddle_tpu/core/bucketing.py`:
the layout (`Bucket`, `Slot`, `BucketLayout`, :249-342), the bucketed
update of the single-program step (`elementwise`:534,
`init_bucket_state`:542, `grad_stats`:565, `flat_functional_apply`:630,
which runs `shard_update`:581 on every bucket) and the checkpoint contract
(`flat_states_to_named`:684 and its inverse).

The layout is the reference's: an ordered {name: (shape, dtype)} is
packed greedily into dtype-homogeneous 1-D buckets, in insertion order,
closing a bucket when the byte cap would be exceeded (a parameter
larger than the cap gets a bucket of its own) and padding each to a
multiple of `pad_to`. The collectives, the int8 wire and the overlap
gauges (:348-530) wait for the multi-GPU port.

Two designs are PyTorch's own:

* **Parameters and gradients live in the buckets.** `jit.TrainStep`
  makes each parameter's `.data` a view into its flat parameter bucket
  and each `.grad` a view into a flat gradient bucket of the
  parameter's dtype, set before the first backward and zeroed bucket by
  bucket each step, never set to None. Autograd then accumulates into
  the views in place (AccumulateGrad adds into an existing `.grad`
  outside grad mode), as DDP's `gradient_as_bucket_view` does, so a
  step copies no parameter or gradient into or out of a bucket; the
  JAX step concatenates both every step (`flatten`:296, :652-664).
* **Gradients stay in the parameter's dtype.** The reference flattens
  them to fp32 (`cast=jnp.float32`, :652-653); the port's kernels read
  bf16 gradients and widen them in registers, and bf16 -> fp32 is
  exact, so the values are the same. `ClipGradByValue` clamps an fp32
  copy, as the reference clamps its fp32 buckets.

The update runs on the buckets IN PLACE (the fused kernels of
`ops/kernels/fused_optimizer.py` on the card, their plain versions on
the CPU), where the JAX step donates its buffers.
"""
import math

import torch

from ..amp import uncast
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                       ClipGradByValue, global_factor, norm_factor)
from ..ops.kernels import fused_optimizer as FO

DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024   # resolve_comm_config's default


class Slot:
    """One parameter's place in a bucket."""
    __slots__ = ('name', 'shape', 'dtype', 'bucket', 'offset', 'size')

    def __init__(self, name, shape, dtype, bucket, offset, size):
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.bucket = bucket
        self.offset = offset
        self.size = size

    def to_dict(self):
        return {'name': self.name, 'shape': list(self.shape),
                'dtype': _dtype_name(self.dtype), 'bucket': self.bucket,
                'offset': self.offset, 'size': self.size}


def _dtype_name(dtype):
    return str(dtype).split('.')[-1]


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch,
                                                               str(dtype))


class Bucket:
    __slots__ = ('index', 'dtype', 'group', 'slots', 'used', 'size')

    def __init__(self, index, dtype, group):
        self.index = index
        self.dtype = dtype
        self.group = group
        self.slots = []
        self.used = 0      # elements occupied by real parameters
        self.size = 0      # padded length (set at finalize)

    @property
    def pad(self):
        return self.size - self.used

    def nbytes(self, dtype=None):
        return self.size * (dtype or self.dtype).itemsize


class BucketLayout:
    """Stable param -> (bucket, offset) map over dtype-homogeneous,
    size-capped, padded 1-D buckets (bucketing.py:249)."""

    def __init__(self, buckets, slots, pad_to):
        self.buckets = buckets
        self.slots = slots
        self.pad_to = pad_to

    @classmethod
    def build(cls, named_shapes, bucket_bytes=DEFAULT_BUCKET_BYTES,
              pad_to=1, group_fn=None):
        """named_shapes: ordered {name: (shape, torch dtype)}."""
        pad_to = max(int(pad_to), 1)
        buckets, slots = [], {}
        open_by_key = {}
        for name, (shape, dtype) in named_shapes.items():
            dtype = _torch_dtype(dtype)
            group = group_fn(name, shape, dtype) if group_fn else None
            size = math.prod(shape)
            key = (group, str(dtype))
            b = open_by_key.get(key)
            if b is not None and \
                    (b.used + size) * dtype.itemsize > bucket_bytes \
                    and b.used > 0:
                b = None   # cap exceeded: close it
            if b is None:
                b = Bucket(len(buckets), dtype, group)
                buckets.append(b)
                open_by_key[key] = b
            slot = Slot(name, shape, dtype, b.index, b.used, size)
            b.slots.append(slot)
            slots[name] = slot
            b.used += size
        for b in buckets:
            b.size = int(math.ceil(b.used / pad_to) * pad_to)
        return cls(buckets, slots, pad_to)

    def flatten(self, tree, cast=None):
        """{name: tensor} -> [one 1-D padded tensor per bucket] (new
        tensors; the step itself keeps its params in the buckets)."""
        out = []
        for b in self.buckets:
            dt = cast or b.dtype
            flat = torch.zeros(b.size, dtype=dt,
                               device=tree[b.slots[0].name].device)
            for s in b.slots:
                flat[s.offset:s.offset + s.size] = \
                    tree[s.name].reshape(-1).to(dt)
            out.append(flat)
        return out

    def unflatten(self, flats, cast_slots=False):
        """[per-bucket 1-D tensors] -> {name: view of slot shape}."""
        tree = {}
        for b, flat in zip(self.buckets, flats):
            for s in b.slots:
                a = flat[s.offset:s.offset + s.size].view(s.shape)
                tree[s.name] = a.to(s.dtype) if cast_slots else a
        return tree

    def names(self):
        return list(self.slots)

    def total_elements(self):
        return sum(s.size for s in self.slots.values())

    def total_padded(self):
        return sum(b.size for b in self.buckets)

    def nbytes(self, dtype=None):
        return sum(b.nbytes(dtype) for b in self.buckets)

    def describe(self):
        """JSON-ready layout map, as the reference's."""
        return {
            'pad_to': self.pad_to,
            'buckets': [{'index': b.index, 'dtype': _dtype_name(b.dtype),
                         'group': b.group if b.group is None
                         else str(b.group),
                         'used': b.used, 'size': b.size,
                         'slots': [s.to_dict() for s in b.slots]}
                        for b in self.buckets],
        }


# ---------------------------------------------------------------------------
# the bucketed update
# ---------------------------------------------------------------------------
def elementwise(optimizer):
    """True when the optimizer's rule is strictly per element, so a flat
    bucket update equals the per-parameter one."""
    return bool(getattr(optimizer, '_elementwise', False))


def init_bucket_state(optimizer, bucket, param_flat32, force_master=False):
    """Flat optimizer state for one bucket, on `param_flat32`'s device:
    the optimizer's zero state over the padded length, plus the fp32
    'master' (a copy of `param_flat32`) for a low-precision bucket under
    multi_precision, or always with `force_master`."""
    st = optimizer.init_state(torch.zeros(bucket.size, dtype=torch.float32,
                                          device=param_flat32.device))
    if force_master or (bucket.dtype != torch.float32
                        and getattr(optimizer, '_multi_precision', True)):
        st['master'] = param_flat32.to(torch.float32, copy=True)
    return st


def grad_stats(flat):
    """(sum of squares, nonfinite count) of a flat gradient bucket, fp32
    0-dim tensors: the fused stats kernel on the card."""
    return FO.grad_stats(flat)


@uncast
def flat_functional_apply(optimizer, layout, flat_params, flat_grads,
                          flat_states, lr):
    """Whole-model bucketed update for `jit.TrainStep`
    (bucketing.py:630): the semantics of `Optimizer.functional_apply`,
    global grad clip, weight decay and the per-element rule, applied to
    the flat buckets in place. `flat_grads` hold each bucket's gradients
    in the bucket's dtype (the params' `.grad` views). Returns
    (new_flat_states, the global-clip factor or None)."""
    clip = optimizer._grad_clip
    grads = flat_grads
    if isinstance(clip, ClipGradByNorm):
        # per-PARAM norms: clip each slot's view in place, in its dtype
        for name, g in layout.unflatten(flat_grads).items():
            g.mul_(norm_factor(g, clip.clip_norm).to(g.dtype))
    elif isinstance(clip, ClipGradByValue):
        grads = [g.float().clamp_(clip.min, clip.max) for g in flat_grads]
    factor = None
    if isinstance(clip, ClipGradByGlobalNorm):
        # one stats pass per bucket feeds the factor, summed in bucket
        # order; the multiply folds into the update pass
        sq = None
        for g in grads:
            s = grad_stats(g)[0]
            sq = s if sq is None else sq + s
        factor = global_factor(torch.sqrt(sq), clip.clip_norm)
    if FO.fusible(optimizer):
        # every bucket in one launch of the update kernel
        out = FO.fused_shard_updates(optimizer, flat_params, grads,
                                     flat_states, lr, prefactor=factor)
    else:
        # an elementwise rule the kernel does not implement (Ftrl) runs its
        # op chain, as the reference keeps its XLA chain for
        # `_pallas_fusible = False`
        out = [FO.shard_update_chain(optimizer, p, g, st, lr,
                                     prefactor=factor)
               for p, g, st in zip(flat_params, grads, flat_states)]
    return [ns for _p, ns in out], factor


# ---------------------------------------------------------------------------
# flat <-> per-param optimizer state (checkpoint contract)
# ---------------------------------------------------------------------------
def flat_states_to_named(layout, flat_states):
    """[per-bucket {key: flat tensor}] -> {param: {key: CPU tensor}} in
    the per-parameter state schema: vector states slice per slot, scalar
    states (beta powers) replicate per param."""
    out = {}
    for b, st in zip(layout.buckets, flat_states):
        for s in b.slots:
            d = {}
            for k, v in st.items():
                v = v.detach().cpu()
                if v.dim() >= 1 and v.shape[0] == b.size:
                    d[k] = v[s.offset:s.offset + s.size].reshape(
                        s.shape).clone()
                else:
                    d[k] = v.clone()
            out[s.name] = d
    return out


def named_states_to_flat(layout, named_states, template):
    """Inverse of flat_states_to_named. `template`: [per-bucket
    {key: tensor}] giving each state's flat shape, dtype and device (and
    the values kept for params missing from `named_states`)."""
    out = []
    for b, tmpl in zip(layout.buckets, template):
        st = {k: v.detach().clone() for k, v in tmpl.items()}
        for s in b.slots:
            src = named_states.get(s.name)
            if not src:
                continue
            for k, v in src.items():
                if k not in st:
                    continue
                v = torch.as_tensor(v)
                if st[k].dim() >= 1 and st[k].shape[0] == b.size:
                    st[k][s.offset:s.offset + s.size] = \
                        v.reshape(-1).to(st[k].dtype)
                else:
                    st[k] = v.to(device=st[k].device,
                                 dtype=st[k].dtype).clone()
        out.append(st)
    return out
