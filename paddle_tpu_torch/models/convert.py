"""Weight bridge: fill a port module from the JAX package's parameters.

The port keeps paddle's parameter and buffer names and layouts, so the
bridge is a rename-free copy: `named_arrays` maps each name of the JAX
model's `named_parameters()` to its value as a numpy array (a test
builds it with `{n: np.asarray(p.data) for n, p in
jax_model.named_parameters()}`), and `named_buffers` each name of its
`named_buffers()` (batch norm's `_mean` and `_variance`). The recurrent
stacks and cells (`weight_ih_l0`, `bias_hh_l1_reverse`, ...), the text
models and any `hapi.Model` network built from the port's layers keep
the reference's names too, so they bridge the same way. The port never
imports the JAX package; callers hand it plain arrays.
"""
import os

import numpy as np
import torch


def load_jax_params(model, named_arrays, named_buffers=None):
    """Copy `named_arrays` ({name: np.ndarray}) into `model`'s parameters
    and, when given, `named_buffers` into its buffers, in place, cast to
    each tensor's own dtype and device (fp32 running statistics stay
    fp32 under bf16 parameters). Raises on any missing or extra name and
    on any shape mismatch, before copying anything. Returns the model."""
    targets = [(dict(model.named_parameters()), named_arrays)]
    if named_buffers is not None:
        targets.append((dict(model.named_buffers()), named_buffers))
    checked = [_check(tensors, named) for tensors, named in targets]
    with torch.no_grad():
        for (tensors, _), arrays in zip(targets, checked):
            for name, t in tensors.items():
                t.copy_(torch.from_numpy(np.array(arrays[name], order='C')))
    return model


def _check(tensors, named_arrays):
    """{name: host array} for `tensors` ({name: tensor}); raises on a
    missing or extra name or a shape mismatch."""
    missing = sorted(set(tensors) - set(named_arrays))
    extra = sorted(set(named_arrays) - set(tensors))
    if missing or extra:
        raise KeyError(f'load_jax_params: missing {missing}, extra {extra}')
    arrays = {}
    for name, t in tensors.items():
        a = np.asarray(named_arrays[name])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f'load_jax_params: {name} has shape '
                             f'{tuple(a.shape)}, the port expects '
                             f'{tuple(t.shape)}')
        if a.dtype.kind == 'V' or a.dtype.name == 'bfloat16':
            a = a.astype(np.float32)    # exact: bf16 widens to fp32
        arrays[name] = a
    return arrays


def load_jax_pipeline_params(embed, blocks, head, arrays):
    """Fill the pipeline triple (`build_gpt_pipeline`) in place from
    `arrays` = {'embed': {name: array}, 'blocks': ..., 'head': {name:
    array}}: the JAX layers' arrays, with 'blocks' a list of one {name:
    array} a block, or a JAX engine's `_params` trees, with 'blocks'
    {name: array stacked [L, ...]} whose row i is `blocks[i]` at pp = 1
    (spmd_pipeline.py:538-555). Every module is checked before any is
    copied. Returns (embed, blocks, head)."""
    per_block = arrays['blocks']
    if isinstance(per_block, dict):
        stacked = {n: np.asarray(a) for n, a in per_block.items()}
        rows = {a.shape[0] for a in stacked.values()}
        if rows != {len(blocks)}:
            raise ValueError(f'load_jax_pipeline_params: stacked rows '
                             f'{sorted(rows)} for {len(blocks)} blocks')
        per_block = [{n: a[i] for n, a in stacked.items()}
                     for i in range(len(blocks))]
    if len(per_block) != len(blocks):
        raise ValueError(f'load_jax_pipeline_params: {len(per_block)} '
                         f'blocks of arrays for {len(blocks)} blocks')
    pairs = [(embed, arrays['embed'])] + list(zip(blocks, per_block)) + \
        [(head, arrays['head'])]
    for module, named in pairs:
        _check(dict(module.named_parameters()), named)
    for module, named in pairs:
        load_jax_params(module, named)
    return embed, blocks, head


def pipeline_params_as_stacked(embed, blocks, head):
    """The inverse: {'embed': {name: fp32 array}, 'blocks': {name: fp32
    array stacked [L, ...]}, 'head': {...}}, the layout of a JAX
    engine's `_params`."""
    def host(module):
        return {n: p.detach().float().cpu().numpy()
                for n, p in module.named_parameters()}
    rows = [host(b) for b in blocks]
    return {'embed': host(embed),
            'blocks': {n: np.stack([r[n] for r in rows]) for n in rows[0]},
            'head': host(head)}


def bridge_ctr_params(port_model, jax_model, tmpdir):
    """Put a CTR model of the JAX package (DeepFM, WideDeep) into the
    port's counterpart: the dense parameters through `load_jax_params`
    (read off `jax_model.named_parameters()` as host arrays), and each
    host table through the table's own file — the JAX layer of the same
    name saves it under `tmpdir` and the port's layer loads it (one
    format: both compile csrc/sparse_table.cc). A geo table syncs before
    it saves. Returns the port model."""
    from ..distributed.ps.embedding import DistributedEmbedding
    load_jax_params(port_model, {n: np.asarray(p.data) for n, p in
                                 jax_model.named_parameters()})
    for name, layer in port_model.named_modules():
        if not isinstance(layer, DistributedEmbedding):
            continue
        theirs = jax_model
        for part in name.split('.'):
            theirs = getattr(theirs, part)
        path = os.path.join(str(tmpdir), f'{name}.table')
        theirs.save(path)
        layer.load(path)
    return port_model
