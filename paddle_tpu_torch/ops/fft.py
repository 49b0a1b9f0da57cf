"""paddle.fft — counterpart of `paddle_tpu/ops/fft.py`, on `torch.fft`:
the same names, `n`/`s`, `axis`/`axes` and `norm` arguments. Real
inputs give complex64 (fp32) or complex128 (fp64) results. None is
reached by `amp.auto_cast`, as the reference's are not.
"""
import torch

from ..amp import uncast
from ..device import resolve_device
from .common import as_tensor, register_public


def _fft_op(name, tfn):
    @uncast
    def op(x, n=None, axis=-1, norm='backward', name_=None):
        return tfn(as_tensor(x), n=n, dim=axis, norm=norm)
    op.__name__ = name
    return op


def _fftn_op(name, tfn, default_axes=None):
    @uncast
    def op(x, s=None, axes=None, norm='backward', name_=None):
        axes = default_axes if axes is None else tuple(axes)
        return tfn(as_tensor(x), s=s, dim=axes, norm=norm)
    op.__name__ = name
    return op


fft = _fft_op('fft', torch.fft.fft)
ifft = _fft_op('ifft', torch.fft.ifft)
rfft = _fft_op('rfft', torch.fft.rfft)
irfft = _fft_op('irfft', torch.fft.irfft)
hfft = _fft_op('hfft', torch.fft.hfft)
ihfft = _fft_op('ihfft', torch.fft.ihfft)
fft2 = _fftn_op('fft2', torch.fft.fftn, (-2, -1))
ifft2 = _fftn_op('ifft2', torch.fft.ifftn, (-2, -1))
rfft2 = _fftn_op('rfft2', torch.fft.rfftn, (-2, -1))
irfft2 = _fftn_op('irfft2', torch.fft.irfftn, (-2, -1))
fftn = _fftn_op('fftn', torch.fft.fftn)
ifftn = _fftn_op('ifftn', torch.fft.ifftn)
rfftn = _fftn_op('rfftn', torch.fft.rfftn)
irfftn = _fftn_op('irfftn', torch.fft.irfftn)


def fftfreq(n, d=1.0, dtype=None, name=None, device=None):
    return torch.fft.fftfreq(n, d, device=resolve_device(device))


def rfftfreq(n, d=1.0, dtype=None, name=None, device=None):
    return torch.fft.rfftfreq(n, d, device=resolve_device(device))


@uncast
def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(as_tensor(x), dim=axes)


@uncast
def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(as_tensor(x), dim=axes)


__all__ = ['fft', 'fft2', 'fftfreq', 'fftn', 'fftshift', 'hfft', 'ifft',
           'ifft2', 'ifftn', 'ifftshift', 'ihfft', 'irfft', 'irfft2',
           'irfftn', 'rfft', 'rfft2', 'rfftfreq', 'rfftn']
register_public(globals(), __all__)
