"""Linear algebra — counterpart of `paddle_tpu/ops/linalg.py`, on
`torch.linalg`, as `paddle.linalg`. Every op stands for one `run_op` of
the reference (none is reached by `amp.auto_cast`).

Conventions kept from the reference: `svd` returns (U, S, V) with V, not
its transpose; `slogdet` stacks [sign, log|det|]; `lu` returns the
packed LU and 1-based int32 pivots; `cholesky_solve(x, y)` solves with
the right-hand side x and the factor y; `triangular_solve(x, y)` solves
x z = y (x upper by default); `eigh` reads the `UPLO` triangle (the
reference symmetrises its input first: the same for a symmetric one).
`lstsq` returns (solution, residuals, rank, singular values), the last
three computed beside the solve, since CUDA's driver returns none of
them.
"""
import torch

from ..amp import uncast
from .common import as_tensor, register_public


@uncast
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(as_tensor(x), upper=upper)


@uncast
def inverse(x, name=None):
    return torch.linalg.inv(as_tensor(x))


inv = inverse


@uncast
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(as_tensor(x), n)


def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(as_tensor(x), atol=tol,
                                    hermitian=hermitian)


@uncast
def det(x):
    return torch.linalg.det(as_tensor(x))


@uncast
def slogdet(x):
    sign, logdet = torch.linalg.slogdet(as_tensor(x))
    return torch.stack([sign, logdet])


@uncast
def svd(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(as_tensor(x), full_matrices=full_matrices)
    return u, s, vh.mT


@uncast
def qr(x, mode='reduced'):
    return tuple(torch.linalg.qr(as_tensor(x), mode=mode))


def eig(x):
    return tuple(torch.linalg.eig(as_tensor(x)))


@uncast
def eigh(x, UPLO='L'):
    return tuple(torch.linalg.eigh(as_tensor(x), UPLO=UPLO))


def eigvals(x):
    return torch.linalg.eigvals(as_tensor(x))


@uncast
def eigvalsh(x, UPLO='L'):
    return torch.linalg.eigvalsh(as_tensor(x), UPLO=UPLO)


@uncast
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(as_tensor(x), rtol=rcond, hermitian=hermitian)


@uncast
def solve(x, y):
    return torch.linalg.solve(as_tensor(x), as_tensor(y))


@uncast
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    """z with op(x) z = y, op the transpose when asked."""
    a = as_tensor(x)
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, as_tensor(y), upper=upper,
                                         unitriangular=unitriangular)


@uncast
def lstsq(x, y, rcond=None):
    a, b = as_tensor(x), as_tensor(y)
    sol = torch.linalg.lstsq(a, b, rcond=rcond).solution
    sv = torch.linalg.svdvals(a)
    rank = torch.linalg.matrix_rank(a)
    m, n = a.shape[-2:]
    if m > n and int(rank.min()) == n:
        res = ((a @ sol - b) ** 2).sum(-2)
    else:
        res = torch.empty((0,), dtype=a.dtype, device=a.device)
    return sol, res, rank, sv


def lu(x, pivot=True):
    return tuple(torch.linalg.lu_factor(as_tensor(x), pivot=pivot))


@uncast
def cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(as_tensor(x), as_tensor(y), upper=upper)


def cond(x, p=None):
    return torch.linalg.cond(as_tensor(x), p)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    x = as_tensor(x)
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0)


def corrcoef(x, rowvar=True):
    x = as_tensor(x)
    return torch.corrcoef(x if rowvar else x.T)


@uncast
def bilinear_tensor_product(x, y, weight, bias=None):
    """Parity: operators/bilinear_tensor_product_op: out[b, o] =
    x[b] W[o] y[b] (+ bias)."""
    out = torch.einsum('bi,oij,bj->bo', as_tensor(x), as_tensor(weight),
                       as_tensor(y))
    return out if bias is None else out + as_tensor(bias)


@uncast
def einsum(equation, *operands):
    return torch.einsum(equation, *[as_tensor(o) for o in operands])


__all__ = [
    'bilinear_tensor_product', 'cholesky', 'cholesky_solve', 'cond',
    'corrcoef', 'cov', 'det', 'eig', 'eigh', 'eigvals', 'eigvalsh',
    'einsum', 'inv', 'inverse', 'lstsq', 'lu', 'matrix_power',
    'matrix_rank', 'pinv', 'qr', 'slogdet', 'solve', 'svd',
    'triangular_solve']
register_public(globals(), __all__)
