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
multiple of `pad_to`, under the cap `resolve_comm_config` reads
(`PTPU_BUCKET_MB`, :76-98). The per-step comm model is the reference's
(:730-1044): the wire bytes of each bucket, the `ptpu_comm_*` and
`ptpu_comm_overlap_*` gauges and `comm_snapshot()`, with the modeled link
bandwidth the H100's NVLink; at dp = 1 the engines publish it with
`enabled` 0, so the step's exposed comm is modeled, not run. The
collectives and the int8 wire (:348-530) wait for the multi-GPU port.

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
import os

import torch

from ..amp import uncast
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                       ClipGradByValue, global_factor, norm_factor)
from ..ops.kernels import fused_optimizer as FO

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
    def build(cls, named_shapes, bucket_bytes=None,
              pad_to=1, group_fn=None):
        """named_shapes: ordered {name: (shape, torch dtype)};
        `bucket_bytes` None: resolve_comm_config's cap."""
        if bucket_bytes is None:
            bucket_bytes = resolve_comm_config()[1]
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


# ---------------------------------------------------------------------------
# communication knobs and the per-step comm model
# ---------------------------------------------------------------------------
DEFAULT_BUCKET_MB = 32.0
# per-block scale granularity for the int8 wire (elements; env
# PTPU_COMM_BLOCK)
DEFAULT_COMM_BLOCK = 256
# scales travel as fp32 beside the int8 payload
SCALE_ITEMSIZE = 4
# deferred-gather prefetch window: param groups in flight ahead of use
DEFAULT_PREFETCH_DEPTH = 2
# modeled per-card link bandwidth for the exposed/hidden comm model:
# NVLink 4 on the H100 SXM, 450 GB/s each direction (NVIDIA's data
# sheet, 900 GB/s total). A MODEL constant like the byte gauges, not a
# measurement.
MODELED_LINK_BYTES_PER_S = 4.5e11


def resolve_comm_config(comm_dtype=None, bucket_mb=None):
    """Gradient-communication knobs, resolved kwarg -> env -> default:
    (comm dtype or None, bucket cap in bytes). `PTPU_COMM_DTYPE` names
    the wire dtype, `PTPU_BUCKET_MB` the cap in MiB (default 32). The
    reference's third source, the fleet strategy, comes with the
    multi-card port."""
    if comm_dtype is None:
        comm_dtype = os.environ.get('PTPU_COMM_DTYPE') or None
    if comm_dtype is not None:
        comm_dtype = _torch_dtype(comm_dtype)
    if bucket_mb is None:
        bucket_mb = float(os.environ.get('PTPU_BUCKET_MB', 0) or 0) or None
    if bucket_mb is None:
        bucket_mb = DEFAULT_BUCKET_MB
    return comm_dtype, int(bucket_mb * 1024 * 1024)


def resolve_comm_block(block=None):
    """Block-scale granularity for the int8 wire, kwarg -> env ->
    default."""
    if block is None:
        block = int(os.environ.get('PTPU_COMM_BLOCK', 0) or 0) or None
    if block is None:
        block = DEFAULT_COMM_BLOCK
    return max(int(block), 1)


def resolve_overlap_config(overlap=None, prefetch=None, chunk=None):
    """Communication-overlap knobs, resolved kwarg -> env -> default:
    (overlap, prefetch depth, chunk elements) from `PTPU_COMM_OVERLAP`,
    `PTPU_COMM_PREFETCH` and `PTPU_COMM_CHUNK` (a present env var wins
    even when falsy)."""
    if overlap is None:
        v = os.environ.get('PTPU_COMM_OVERLAP')
        if v is not None and v != '':
            overlap = v.lower() in ('1', 'true', 'yes')
    if prefetch is None:
        v = os.environ.get('PTPU_COMM_PREFETCH')
        if v is not None and v != '':
            prefetch = int(v)
    if prefetch is None:
        prefetch = DEFAULT_PREFETCH_DEPTH
    if chunk is None:
        v = os.environ.get('PTPU_COMM_CHUNK')
        if v is not None and v != '':
            chunk = int(v)
    if chunk is None:
        chunk = 0
    return bool(overlap), max(int(prefetch), 1), max(int(chunk), 0)


def block_len(n, want):
    """Largest divisor of `n` that is <= `want`: the effective scale
    block for a flat array of length n."""
    b = min(int(want), int(n))
    while b > 1 and n % b:
        b -= 1
    return max(b, 1)


def _chunk_spans(shard_len, n_shards, chunk):
    """Split points of a chunked copy (bucketing.py:397 in the JAX
    package): `chunk` caps the whole copy's elements, so a piece spans
    chunk // n_shards along the shard dimension. A list of (start,
    width) spans over [0, shard_len), or None when chunking is off or
    the copy already fits one chunk."""
    if not chunk or n_shards < 1:
        return None
    w = max(int(chunk) // max(int(n_shards), 1), 1)
    if shard_len <= w:
        return None
    spans, s = [], 0
    while s < shard_len:
        spans.append((s, min(w, shard_len - s)))
        s += spans[-1][1]
    return spans


def _is_int8(comm_dtype):
    return comm_dtype is not None and _torch_dtype(comm_dtype) == torch.int8


def _bucket_wire(b, n_shards, comm_dtype=None, block=None):
    """Per-bucket wire-byte split, the ONE home of the byte
    convention (wire_bytes totals and the overlap seconds model both
    read it): reduce_scatter moves gradients in `comm_dtype`
    (param/bucket dtype when None); all_gather moves updated params
    in their storage dtype; int8 mode moves int8 + fp32 block scales
    on both legs."""
    int8 = _is_int8(comm_dtype)
    rs_item = 1 if int8 else _torch_dtype(comm_dtype or b.dtype).itemsize
    ag_item = 1 if int8 else b.dtype.itemsize
    scale_bytes = 0
    if int8:
        eb = block_len(max(b.size // max(n_shards, 1), 1),
                       resolve_comm_block(block))
        scale_bytes = (b.size // eb) * SCALE_ITEMSIZE
    return {'reduce_scatter': {'payload': b.used * rs_item,
                               'scale': scale_bytes,
                               'pad': b.pad * rs_item},
            'all_gather': {'payload': b.used * ag_item,
                           'scale': scale_bytes,
                           'pad': b.pad * ag_item}}


def wire_bytes(layout, n_shards, comm_dtype=None, block=None):
    """Real per-rank wire bytes per step for a bucket layout, split
    into parameter payload vs overhead:

      {'reduce_scatter'|'all_gather':
          {'payload': <real-parameter bytes on the wire>,
           'scale':   <block-scale sidecar bytes (int8 mode only)>,
           'pad':     <zero-padding bytes>,
           'total':   payload + scale + pad}}
    """
    out = {'reduce_scatter': {'payload': 0, 'scale': 0, 'pad': 0},
           'all_gather': {'payload': 0, 'scale': 0, 'pad': 0}}
    for b in layout.buckets:
        per = _bucket_wire(b, n_shards, comm_dtype, block)
        for op, parts in out.items():
            for k in parts:
                parts[k] += per[op][k]
    for op in out.values():
        op['total'] = op['payload'] + op['scale'] + op['pad']
    return out


def publish_comm_gauges(layout, engine, n_shards, comm_dtype=None,
                        enabled=True, block=None):
    """Publish the per-step communication model for a bucket layout.

    Byte convention (docs/performance.md): a ring allreduce moves
    2x the payload per rank (its reduce-scatter + all-gather
    decomposition); reduce_scatter and all_gather move 1x each. The
    baseline scheme is the per-parameter psum of fp32 gradients — the
    dtype the reduction math runs in, which is what the compressed mode
    preserves (EQuARX) — so `bucketed` vs `per_param_psum_fp32` is an
    equal-accuracy comparison. Wire bytes are REAL bytes: int8 mode
    counts the fp32 block-scale sidecars and the bucket zero-padding,
    reported separately from the parameter payload so the compression
    claim is auditable. Gauges are modeled at build time (every step
    runs the same collectives)."""
    from . import monitor as _m
    elems = layout.total_elements()
    padded = layout.total_padded()
    wires = wire_bytes(layout, n_shards, comm_dtype, block)
    rs_bytes = wires['reduce_scatter']['total']
    ag_bytes = wires['all_gather']['total']
    baseline = 2 * elems * 4    # per-param fp32 allreduce, 2x payload
    g = _m.gauge
    g('ptpu_comm_buckets', help='gradient buckets per step',
      labelnames=('engine',)).set(len(layout.buckets), engine=engine)
    g('ptpu_comm_bucket_pad_elements',
      help='zero-padding elements across buckets',
      labelnames=('engine',)).set(padded - elems, engine=engine)
    g('ptpu_comm_shards', help='weight-update shard count (dp degree)',
      labelnames=('engine',)).set(n_shards, engine=engine)
    g('ptpu_comm_bytes_per_step',
      help='modeled per-rank wire bytes per step, by collective '
           '(payload + block scales + padding)',
      labelnames=('engine', 'op')).set(rs_bytes, engine=engine,
                                       op='reduce_scatter')
    g('ptpu_comm_bytes_per_step',
      labelnames=('engine', 'op')).set(ag_bytes, engine=engine,
                                       op='all_gather')
    for op in ('reduce_scatter', 'all_gather'):
        g('ptpu_comm_payload_bytes_per_step',
          help='real-parameter bytes on the wire per rank per step '
               '(scales and padding excluded)',
          labelnames=('engine', 'op')).set(
              wires[op]['payload'], engine=engine, op=op)
        for kind in ('scale', 'pad'):
            g('ptpu_comm_overhead_bytes_per_step',
              help='non-payload wire bytes per rank per step: block '
                   'scales (int8 mode) and bucket zero-padding',
              labelnames=('engine', 'op', 'kind')).set(
                  wires[op][kind], engine=engine, op=op, kind=kind)
    # report the EFFECTIVE block (smallest across buckets), not the
    # requested one: block_len() shrinks to a divisor of the shard
    # length, and an honest gauge is what keeps the scale-overhead
    # numbers auditable (engine layouts pad to n_shards*8, so this
    # never collapses below 8)
    eff_block = 0
    if _is_int8(comm_dtype) and layout.buckets:
        want = resolve_comm_block(block)
        eff_block = min(
            block_len(max(b.size // max(n_shards, 1), 1), want)
            for b in layout.buckets)
    g('ptpu_comm_block_elements',
      help='int8 block-scale granularity in elements — smallest '
           'EFFECTIVE block across buckets (0 = not block-scaled)',
      labelnames=('engine',)).set(eff_block, engine=engine)
    g('ptpu_comm_modeled_bytes_per_step',
      help='modeled per-rank wire bytes per step, by scheme '
           '(allreduce counted 2x payload)',
      labelnames=('engine', 'scheme')).set(
          baseline, engine=engine, scheme='per_param_psum_fp32')
    g('ptpu_comm_modeled_bytes_per_step',
      labelnames=('engine', 'scheme')).set(
          rs_bytes + ag_bytes, engine=engine, scheme='bucketed')
    g('ptpu_comm_compressed_fraction',
      help='1 - reduce_scatter parameter payload / fp32 payload',
      labelnames=('engine',)).set(
          1.0 - wires['reduce_scatter']['payload'] / max(elems * 4, 1),
          engine=engine)
    g('ptpu_comm_enabled',
      help='1 when the bucketed rs/ag path is compiled into the step '
           '(0: modeled only — dp degree 1 or legacy path)',
      labelnames=('engine',)).set(1 if enabled else 0, engine=engine)
    _m.counter('ptpu_collective_calls_total',
               help='collective API invocations',
               labelnames=('op',)).inc(
                   2 * len(layout.buckets) if enabled else 0,
                   op='bucket_rs_ag')


def _bucket_wire_totals(b, n_shards, comm_dtype=None, block=None):
    """(reduce_scatter bytes, all_gather bytes) for ONE bucket —
    payload + block scales + padding, straight from _bucket_wire so
    the overlap seconds model can never drift from the byte gauges."""
    per = _bucket_wire(b, n_shards, comm_dtype, block)
    return (sum(per['reduce_scatter'].values()),
            sum(per['all_gather'].values()))


def overlap_seconds(layout, n_shards, comm_dtype=None, block=None,
                    enabled=True):
    """Build-time exposed/hidden comm model for a bucket layout:
    (total_s, exposed_s, hidden_s) at MODELED_LINK_BYTES_PER_S.

    With overlap compiled in, a group's reduce-scatter hides under the
    backward of the layers still to come, and its next-step all-gather
    hides under the forward of the groups before it — EXCEPT group 0
    (layer order): its grads complete last (backward ends at layer 0),
    so its reduce-scatter has no compute left to hide under, and its
    params are the first the forward needs, so its gather is on the
    critical path. Exposed = group 0's rs+ag; hidden = the rest. With
    overlap off (or a single group) every byte is exposed."""
    per = [_bucket_wire_totals(b, n_shards, comm_dtype, block)
           for b in layout.buckets]
    total = sum(rs + ag for rs, ag in per) / MODELED_LINK_BYTES_PER_S
    if not enabled or len(per) <= 1:
        return total, total, 0.0
    exposed = sum(per[0]) / MODELED_LINK_BYTES_PER_S
    return total, exposed, total - exposed


def publish_overlap_gauges(layout, engine, n_shards, comm_dtype=None,
                           enabled=True, prefetch=None, chunk=0,
                           block=None):
    """Publish the ptpu_comm_overlap_* gauges for a bucket layout and
    emit one profiler span per group (modeled bytes/seconds ride as
    span args; every step runs the same collectives, so the model is
    built once, like the byte gauges)."""
    from . import monitor as _m
    from .. import profiler as _prof
    prefetch = int(prefetch or DEFAULT_PREFETCH_DEPTH)
    groups = len(layout.buckets)
    total_s, exposed_s, hidden_s = overlap_seconds(
        layout, n_shards, comm_dtype, block, enabled=enabled)
    g = _m.gauge
    g('ptpu_comm_overlap_enabled',
      help='1 when the overlapped (layer-grouped, deferred-gather) '
           'comm schedule is compiled into the step',
      labelnames=('engine',)).set(1 if enabled else 0, engine=engine)
    g('ptpu_comm_overlap_groups',
      help='layer-grouped gradient buckets per step',
      labelnames=('engine',)).set(groups, engine=engine)
    g('ptpu_comm_overlap_groups_in_flight',
      help='param groups gathered ahead of first use (prefetch window '
           'actually achievable with this layout)',
      labelnames=('engine',)).set(
          min(prefetch, groups) if enabled else 0, engine=engine)
    g('ptpu_comm_overlap_prefetch_depth',
      help='deferred-gather prefetch depth knob',
      labelnames=('engine',)).set(prefetch, engine=engine)
    g('ptpu_comm_overlap_chunk_elements',
      help='PTPU_COMM_CHUNK collective decomposition cap '
           '(0 = unchunked)',
      labelnames=('engine',)).set(int(chunk or 0), engine=engine)
    g('ptpu_comm_overlap_total_comm_seconds',
      help='modeled per-step collective seconds at the modeled link '
           'bandwidth',
      labelnames=('engine',)).set(total_s, engine=engine)
    g('ptpu_comm_overlap_exposed_comm_seconds',
      help='modeled comm seconds NOT hidden under compute (group 0 '
           'rs+ag when overlapped; everything when not)',
      labelnames=('engine',)).set(exposed_s, engine=engine)
    g('ptpu_comm_overlap_hidden_comm_seconds',
      help='modeled comm seconds hidden under backward/forward '
           'compute',
      labelnames=('engine',)).set(hidden_s, engine=engine)
    for b in layout.buckets:
        rs_b, ag_b = _bucket_wire_totals(b, n_shards, comm_dtype, block)
        with _prof.RecordEvent(
                f'comm::group{b.index}', event_type='comm',
                engine=engine, group=str(b.group), bucket=b.index,
                rs_bytes=rs_b, ag_bytes=ag_b,
                modeled_seconds=round(
                    (rs_b + ag_b) / MODELED_LINK_BYTES_PER_S, 9),
                hidden=bool(enabled and groups > 1 and b.index != 0)):
            pass


def comm_snapshot():
    """JSON-ready view of every ptpu_comm_* gauge (for
    StepTelemetry.snapshot and a run's record)."""
    from . import monitor as _m
    reg = _m.metrics()
    out = {}
    for name in ('ptpu_comm_buckets', 'ptpu_comm_bucket_pad_elements',
                 'ptpu_comm_shards', 'ptpu_comm_bytes_per_step',
                 'ptpu_comm_payload_bytes_per_step',
                 'ptpu_comm_overhead_bytes_per_step',
                 'ptpu_comm_block_elements',
                 'ptpu_comm_modeled_bytes_per_step',
                 'ptpu_comm_compressed_fraction', 'ptpu_comm_enabled',
                 'ptpu_comm_overlap_enabled', 'ptpu_comm_overlap_groups',
                 'ptpu_comm_overlap_groups_in_flight',
                 'ptpu_comm_overlap_prefetch_depth',
                 'ptpu_comm_overlap_chunk_elements',
                 'ptpu_comm_overlap_total_comm_seconds',
                 'ptpu_comm_overlap_exposed_comm_seconds',
                 'ptpu_comm_overlap_hidden_comm_seconds'):
        m = reg.get(name)
        if m is None:
            continue
        series = {}
        for key, child in m._series().items():
            label = ','.join(f'{ln}={lv}' for ln, lv
                             in zip(m.labelnames, key))
            series[label or '()'] = child.value()
        out[name] = series
    # derived headline. This is a build-time MODEL either way;
    # comm_bytes_drop_enabled says whether the rs/ag path runs in the
    # step (dp>1) or the engine only modeled it (dp=1) — consumers must
    # not read a modeled-only drop as realized wire savings.
    modeled = out.get('ptpu_comm_modeled_bytes_per_step') or {}
    enabled = out.get('ptpu_comm_enabled') or {}
    payload = out.get('ptpu_comm_payload_bytes_per_step') or {}
    overhead = out.get('ptpu_comm_overhead_bytes_per_step') or {}
    for eng in {k.split(',')[0].split('=', 1)[1]
                for k in modeled if k.startswith('engine=')}:
        base = modeled.get(f'engine={eng},scheme=per_param_psum_fp32')
        new = modeled.get(f'engine={eng},scheme=bucketed')
        if base and new is not None:
            out.setdefault('comm_bytes_drop_vs_per_param_psum', {})[
                eng] = round(1.0 - new / base, 4)
            out.setdefault('comm_bytes_drop_enabled', {})[eng] = bool(
                enabled.get(f'engine={eng}'))
        # wire-byte audit: real-parameter payload vs scale / padding
        # overhead, and the payload-vs-payload compression factor
        pay = sum(v for k, v in payload.items()
                  if k.startswith(f'engine={eng},'))
        ov_scale = sum(v for k, v in overhead.items()
                       if k.startswith(f'engine={eng},')
                       and k.endswith('kind=scale'))
        ov_pad = sum(v for k, v in overhead.items()
                     if k.startswith(f'engine={eng},')
                     and k.endswith('kind=pad'))
        if pay:
            out.setdefault('comm_wire_breakdown', {})[eng] = {
                'payload_bytes': pay, 'scale_bytes': ov_scale,
                'pad_bytes': ov_pad,
                'total_bytes': pay + ov_scale + ov_pad}
            if base:
                out.setdefault(
                    'comm_payload_factor_vs_per_param_psum', {})[
                    eng] = round(base / pay, 4)
    # overlap headline: per-engine exposed vs hidden comm seconds and
    # the schedule's shape. A build-time MODEL like the byte gauges;
    # `enabled` says whether the overlapped schedule runs in the step.
    ov_en = out.get('ptpu_comm_overlap_enabled') or {}
    for key in ov_en:
        eng = key.split('=', 1)[1]

        def _ov(name, default=0):
            return (out.get(f'ptpu_comm_overlap_{name}') or {}).get(
                key, default)

        out.setdefault('comm_overlap', {})[eng] = {
            'enabled': bool(_ov('enabled')),
            'groups': int(_ov('groups')),
            'groups_in_flight': int(_ov('groups_in_flight')),
            'prefetch_depth': int(_ov('prefetch_depth')),
            'chunk_elements': int(_ov('chunk_elements')),
            'total_comm_seconds': round(_ov('total_comm_seconds'), 9),
            'exposed_comm_seconds': round(
                _ov('exposed_comm_seconds'), 9),
            'hidden_comm_seconds': round(_ov('hidden_comm_seconds'), 9),
        }
    return out
