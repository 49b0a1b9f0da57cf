"""The global flags registry — the part of `paddle_tpu/core/flags.py` the
port reads: `set_flags`, `get_flags` and `flag` (:162-180) and the env
seeding of the flags it serves (:127-146).

Served: `FLAGS_use_flash_attention`, `FLAGS_flash_min_seq` and
`FLAGS_flash_packed_mha`, which choose between the reference's own
routes of `nn.MultiHeadAttention` (flash, packed or BHLD, against the
dense matmul + softmax); and the numerics observatory's
`FLAGS_check_nan_inf`, `FLAGS_check_nan_inf_deferred`,
`FLAGS_check_nan_inf_max_journal` and `FLAGS_tensor_stats`
(core/numerics.py: the eager guard and the engines' taps). None of them
chooses a kernel's plain version on a CUDA tensor: that is chosen by the
tensor's device alone.

A reference flag whose value would turn on a path the port does not
serve raises NotImplementedError naming what brings it (`_UNSERVED`);
at its default, or at the value that keeps that path off, it is
recorded. Any other name is recorded, as the reference records it.
"""
import os

_FLAGS = {
    'FLAGS_use_flash_attention': True,
    'FLAGS_flash_min_seq': 1024,
    'FLAGS_flash_packed_mha': True,
    # the numerics observatory (core/numerics.py)
    'FLAGS_check_nan_inf': False,
    'FLAGS_check_nan_inf_deferred': False,
    'FLAGS_check_nan_inf_max_journal': 4096,
    'FLAGS_tensor_stats': False,
    # unserved: recorded at their defaults (see _UNSERVED)
    'FLAGS_fused_optimizer': None,
    'FLAGS_fused_layer_norm': None,
    'FLAGS_fused_elementwise': None,
    'FLAGS_paged_attention_kernel': None,
}

_PLAIN = ("the port's routing is by tensor device alone: no flag sends a "
          'CUDA tensor to a plain version (ROADMAP, rules of the round)')
# flag -> (values accepted, what the others need)
_UNSERVED = {
    'FLAGS_fused_optimizer': ((None, True), _PLAIN),
    'FLAGS_fused_layer_norm': ((None, True), _PLAIN),
    'FLAGS_fused_elementwise': ((None, True), _PLAIN),
    'FLAGS_paged_attention_kernel': ((None, True), _PLAIN),
}


def _check(name, value):
    if name in _UNSERVED:
        ok, needs = _UNSERVED[name]
        if not any(value is v or (type(value) is type(v) and value == v)
                   for v in ok):
            raise NotImplementedError(
                f'{name}={value!r} is not ported yet ({needs})')


def _parse(current, text):
    truth = text.lower() in ('1', 'true', 'yes')
    if isinstance(current, bool):
        return truth
    if isinstance(current, int):
        return int(text)
    if current is None and text.lower() in ('1', 'true', 'yes', '0',
                                            'false', 'no'):
        return truth        # a tri-state flag: the env seeds a real bool
    return text


def _seed_from_env():
    """Each flag from its env var, as the reference seeds them; an
    unserved path switched on there is refused where it would run, not
    at import."""
    for k in list(_FLAGS):
        if k in os.environ:
            _FLAGS[k] = _parse(_FLAGS[k], os.environ[k])


_seed_from_env()


def set_flags(flags):
    """Parity: paddle.set_flags({'FLAGS_x': v}). Every value is checked
    before any is recorded."""
    for k, v in flags.items():
        _check(k, v)
    _FLAGS.update(flags)


def get_flags(keys):
    """Parity: paddle.get_flags — a name or a list of names -> dict."""
    if isinstance(keys, str):
        keys = [keys]
    return {k: _FLAGS.get(k) for k in keys}


def flag(name, default=None):
    return _FLAGS.get(name, default)
