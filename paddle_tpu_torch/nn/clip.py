"""Gradient clipping — counterpart of `paddle_tpu/nn/clip.py:39-100`.

Reference parity: python/paddle/fluid/clip.py — ClipGradByValue,
ClipGradByNorm, ClipGradByGlobalNorm. An optimizer given one as its
`grad_clip` applies it inside `functional_apply` (the per-parameter
route, `optimizer/optimizer.py`) or `core.bucketing.flat_functional_apply`
(the bucketed route), as the reference's functional routes do. Their
`__call__` on a list of (param, grad) pairs is the eager form: a grad
of None, or a param whose `need_clip` is False, passes through.

Every norm is an fp32 sum of squares on the device; nothing here reads
a device value back to the host. The reference's pre-clip norm gauge
(`_publish_preclip_norm`) waits for the port's telemetry.
"""
import torch


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
        factor = global_factor(self.global_norm(params_grads),
                               self.clip_norm)
        return [(p, g) if _skip(p, g)
                else (p, (g.float() * factor).to(g.dtype))
                for p, g in params_grads]
