"""Weight bridge: fill a port module from the JAX package's parameters.

The port keeps paddle's parameter names and layouts, so the bridge is a
rename-free copy: `named_arrays` maps each name of the JAX model's
`named_parameters()` to its value as a numpy array (a test builds it
with `{n: np.asarray(p.data) for n, p in jax_model.named_parameters()}`).
The port never imports the JAX package; callers hand it plain arrays.
"""
import numpy as np
import torch


def load_jax_params(model, named_arrays):
    """Copy `named_arrays` ({name: np.ndarray}) into `model`'s parameters
    in place, cast to each parameter's dtype and device. Raises on any
    missing or extra name and on any shape mismatch, before copying
    anything. Returns the model."""
    params = dict(model.named_parameters())
    arrays = _check(model, named_arrays)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(arrays[name], order='C')))
    return model


def _check(model, named_arrays):
    """{name: host array} for `model`'s parameters; raises on a missing
    or extra name or a shape mismatch."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named_arrays))
    extra = sorted(set(named_arrays) - set(params))
    if missing or extra:
        raise KeyError(f'load_jax_params: missing {missing}, extra {extra}')
    arrays = {}
    for name, p in params.items():
        a = np.asarray(named_arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f'load_jax_params: {name} has shape '
                             f'{tuple(a.shape)}, the port expects '
                             f'{tuple(p.shape)}')
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
        _check(module, named)
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
