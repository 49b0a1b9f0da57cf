"""Weight quantization for serving — the port's own copy of what it needs
from `paddle_tpu/quantization/__init__.py`.

`quantize_to_int8` is the JAX package's (:134) in torch ops, so it runs
where the weight lives (on the card, a 1.3B model's matmul weights in
well under a second rather than a round trip through host numpy): the
same fp32 operations in the same order, each correctly rounded (the
divisions are tensor by tensor, never by a Python scalar, which torch
may turn into a multiply by the reciprocal), with round half to even as
`np.round`. So its codes and scales are bit-equal to the reference's on
the same values (tests/test_torch_serving.py holds it).

`dequantize_weight` is the serving engine's dequantization at use,
engine.py:1224-1233: `q * (s / 127)` per out-channel in fp32, cast once
to the weight's dtype.
"""
import torch


def quantize_to_int8(t, quant_axis=None, bits=8):
    """(int8 codes, fp32 scales) of tensor `t`: symmetric abs-max over
    the whole tensor (quant_axis None; a 0-dim scale) or per index of
    `quant_axis` (scales of that axis' length), scale floored at 1e-8,
    codes round(clip(t, -s, s) * (2^(bits-1) - 1) / s)."""
    a = t.detach().float()
    bin_cnt = float(2 ** (bits - 1) - 1)
    if quant_axis is None:
        s = a.abs().amax().clamp_min(1e-8)
        sr = s
    else:
        axis = quant_axis % a.ndim
        dims = tuple(i for i in range(a.ndim) if i != axis)
        s = a.abs().amax(dim=dims).clamp_min(1e-8)
        shape = [1] * a.ndim
        shape[axis] = -1
        sr = s.reshape(shape)
    factor = torch.full_like(sr, bin_cnt) / sr
    q = torch.round(torch.clamp(a, -sr, sr) * factor).to(torch.int8)
    return q, s


def dequantize_weight(q, s, dtype):
    """The per-out-channel weight `q` [in, out] int8 with scales `s`
    [out] back in `dtype`, as the JAX engine's step computes it."""
    return (q.float() * (s * (1.0 / 127.0)).reshape(1, -1)).to(dtype)
