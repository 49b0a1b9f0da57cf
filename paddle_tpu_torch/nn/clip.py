"""Gradient clipping — counterpart of `paddle_tpu/nn/clip.py:39-100`.

Reference parity: python/paddle/fluid/clip.py — ClipGradByValue,
ClipGradByNorm, ClipGradByGlobalNorm. An optimizer given one as its
`grad_clip` applies it inside `functional_apply` (the per-parameter
route, `optimizer/optimizer.py`) or `core.bucketing.flat_functional_apply`
(the bucketed route), as the reference's functional routes do. Their
`__call__` on a list of (param, grad) pairs is the eager form: a grad
of None, or a param whose `need_clip` is False, passes through.

Every norm is an fp32 sum of squares on the device. The eager global-
norm clip (`ClipGradByGlobalNorm.__call__`, and the optimizer's eager
`step()`) publishes the pre-clip norm as `ptpu_num_grad_norm_preclip`
and `ptpu_num_grad_norm_global` (`_publish_preclip_norm`, :13-38), the
one host read here, and only when `FLAGS_tensor_stats` or
`FLAGS_check_nan_inf` asks for it; inside `optimizer.step` under
`FLAGS_tensor_stats` the step's numerics boundary has already published
the norm from its own fetch, so the clip stays silent there.
"""
import torch


def _publish_preclip_norm(norm, site):
    """Publish the pre-clip global gradient norm (the reference's
    training-health signal) when stats are asked for: one host read."""
    from ..core.flags import flag
    if not (flag('FLAGS_tensor_stats') or flag('FLAGS_check_nan_inf')):
        return None
    if flag('FLAGS_tensor_stats'):
        from ..core import memory as _mem
        if _mem.accountant().current_phase() == 'optimizer.step':
            return None
    val = float(norm)       # the one host sync this publication costs
    from ..core import monitor as _m
    _m.gauge('ptpu_num_grad_norm_global',
             help='global (all-parameter) gradient l2 norm').set(val)
    _m.gauge('ptpu_num_grad_norm_preclip',
             help='pre-clip global gradient norm per clip site',
             labelnames=('site',)).set(val, site=site)
    return val


def _sum_sq(g):
    g32 = g.float()
    return (g32 * g32).sum()


def _scalar(value, like):
    """`value` as an fp32 0-dim tensor on `like`'s device (a Python
    float operand would take torch's reciprocal route for `c / t`)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


def _skip(p, g):
    return g is None or not getattr(p, 'need_clip', True)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g) if _skip(p, g) else (p, g.clamp(self.min, self.max))
                for p, g in params_grads]


def norm_factor(g, clip_norm):
    """min(clip_norm / max(||g||, 1e-12), 1) as an fp32 0-dim tensor."""
    n = torch.sqrt(_sum_sq(g))
    cn = _scalar(clip_norm, n)
    return torch.minimum(cn / torch.maximum(n, _scalar(1e-12, n)),
                         _scalar(1.0, n))


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        return [(p, g) if _skip(p, g)
                else (p, (g.float() * norm_factor(g, self.clip_norm))
                      .to(g.dtype))
                for p, g in params_grads]


def global_factor(global_norm, clip_norm):
    """clip_norm / max(global_norm, clip_norm) as an fp32 0-dim tensor,
    from the fp32 global norm over every gradient."""
    cn = _scalar(clip_norm, global_norm)
    return cn / torch.maximum(global_norm, cn)


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0, group_name='default_group'):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, params_grads):
        sums = [_sum_sq(g) for p, g in params_grads if not _skip(p, g)]
        if not sums:
            return torch.zeros((), dtype=torch.float32)
        sq = sums[0]
        for s in sums[1:]:
            sq = sq + s
        return torch.sqrt(sq)

    def __call__(self, params_grads):
        gn = self.global_norm(params_grads)
        _publish_preclip_norm(gn, 'global_norm_clip')
        factor = global_factor(gn, self.clip_norm)
        return [(p, g) if _skip(p, g)
                else (p, (g.float() * factor).to(g.dtype))
                for p, g in params_grads]
