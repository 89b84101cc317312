"""Linear algebra ops (port of ``paddle_tpu/ops/linalg.py``), over
``torch.linalg``; ``matmul``'s products take the card's cuBLAS, as the
port's layers do."""
from __future__ import annotations

import torch

from ..framework.op import primitive
from ._util import as_t, float_of, pair

__all__ = ["matmul", "mm", "bmm", "mv", "norm", "p_norm", "dist", "cholesky",
           "cholesky_solve", "inv", "inverse", "pinv", "det", "slogdet",
           "matrix_rank", "matrix_power", "qr", "svd", "eig", "eigh",
           "eigvalsh", "solve", "triangular_solve", "lstsq", "lu",
           "multi_dot", "cross", "cov", "corrcoef", "cosine_similarity",
           "einsum", "matrix_transpose"]


def _mT(x):
    return torch.swapaxes(x, -1, -2) if x.dim() > 1 else x


@primitive("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = pair(x, y)
    if transpose_x:
        x = _mT(x)
    if transpose_y:
        y = _mT(y)
    return torch.matmul(x, y)


mm = matmul


@primitive("bmm")
def bmm(x, y, name=None):
    return torch.matmul(*pair(x, y))


@primitive("mv")
def mv(x, vec, name=None):
    return torch.matmul(*pair(x, vec))


def _ax(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@primitive("norm")
def norm(x, p="fro", axis=None, keepdim=False, name=None):
    x = float_of(as_t(x))
    ax = _ax(axis)
    if ax is None:
        ax = tuple(range(x.dim()))
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(x), dim=ax,
                                    keepdim=keepdim))
    if p in (float("inf"), "inf"):
        return torch.amax(torch.abs(x), dim=ax, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=ax, keepdim=keepdim)
    p = float(p)
    return torch.sum(torch.abs(x) ** p, dim=ax, keepdim=keepdim) ** (1.0 / p)


@primitive("p_norm")
def p_norm(x, porder=2.0, axis=-1, epsilon=1e-12, keepdim=False):
    x = float_of(as_t(x))
    return torch.clamp_min(torch.sum(torch.abs(x) ** porder, dim=axis,
                                     keepdim=keepdim) ** (1.0 / porder),
                           epsilon)


@primitive("dist")
def dist(x, y, p=2, name=None):
    x, y = pair(x, y)
    d = x - y
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


@primitive("cholesky")
def cholesky(x, upper=False, name=None):
    L = torch.linalg.cholesky(as_t(x))
    return _mT(L) if upper else L


@primitive("cholesky_solve")
def cholesky_solve(x, y, upper=False, name=None):
    x, y = pair(x, y)
    L = _mT(y) if upper else y
    z = torch.linalg.solve_triangular(L, x, upper=False)
    return torch.linalg.solve_triangular(_mT(L), z, upper=True)


@primitive("inverse")
def inv(x, name=None):
    return torch.linalg.inv(as_t(x))


inverse = inv


@primitive("pinv")
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(as_t(x), rtol=rcond, hermitian=hermitian)


@primitive("det")
def det(x, name=None):
    return torch.linalg.det(as_t(x))


@primitive("slogdet")
def slogdet(x, name=None):
    sign, logabs = torch.linalg.slogdet(as_t(x))
    return torch.stack([sign, logabs])


@primitive("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False, name=None):
    x = as_t(x)
    if tol is None:
        return torch.linalg.matrix_rank(x).to(torch.int32)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0).to(torch.int32)


@primitive("matrix_power")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(as_t(x), n)


@primitive("qr")
def qr(x, mode="reduced", name=None):
    out = torch.linalg.qr(as_t(x), mode=mode)
    return out.R if mode == "r" else (out.Q, out.R)


@primitive("svd_op")
def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(as_t(x), full_matrices=full_matrices)
    return u, s, vh


@primitive("eig")
def eig(x, name=None):
    w, v = torch.linalg.eig(as_t(x))
    return w, v


@primitive("eigh")
def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(as_t(x), UPLO=UPLO)
    return w, v


@primitive("eigvalsh")
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(as_t(x), UPLO=UPLO)


@primitive("solve")
def solve(x, y, name=None):
    return torch.linalg.solve(*pair(x, y))


@primitive("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    x, y = pair(x, y)
    if transpose:
        x, upper = _mT(x), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


@primitive("lstsq")
def lstsq(x, y, rcond=None, name=None):
    """jnp.linalg.lstsq's four outputs (solution, residuals, rank,
    singular values) over an SVD (no LAPACK driver choice)."""
    x, y = pair(x, y)
    vec = y.dim() == 1
    b = y[:, None] if vec else y
    m, n = x.shape[-2], x.shape[-1]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    eps = torch.finfo(x.dtype).eps
    cut = (rcond if rcond is not None else eps * max(m, n)) * s[..., :1]
    keep = s > cut
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    sol = _mT(vh) @ (sinv[..., None] * (_mT(u) @ b))
    rank = keep.sum(-1).to(torch.int32)
    if m > n and int(rank) == n:
        res = torch.sum(torch.square(x @ sol - b), dim=-2)
    else:
        res = torch.zeros((0,), dtype=x.dtype, device=x.device)
    if vec:
        sol = sol[:, 0]
        res = res.reshape(-1)
    return sol, res, rank, s


@primitive("lu")
def lu(x, pivot=True, name=None):
    lu_mat, piv = torch.linalg.lu_factor(as_t(x), pivot=pivot)
    return lu_mat, (piv - 1).to(torch.int32)


@primitive("multi_dot")
def multi_dot(xs, name=None):
    return torch.linalg.multi_dot([as_t(x) for x in xs])


@primitive("cross")
def cross(x, y, axis=None, name=None):
    x, y = pair(x, y)
    if axis is None:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


@primitive("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = float_of(as_t(x))
    if not rowvar:
        x = _mT(x)
    return torch.cov(x, correction=1 if ddof else 0,
                     fweights=None if fweights is None else as_t(fweights),
                     aweights=None if aweights is None else as_t(aweights))


@primitive("corrcoef")
def corrcoef(x, rowvar=True, name=None):
    x = float_of(as_t(x))
    return torch.corrcoef(x if rowvar else _mT(x))


@primitive("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = pair(x1, x2)
    d = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return d / torch.clamp_min(n1 * n2, eps)


@primitive("einsum")
def einsum(equation, *operands):
    return torch.einsum(equation, *[as_t(o) for o in operands])


@primitive("matrix_transpose")
def matrix_transpose(x, name=None):
    return torch.swapaxes(as_t(x), -1, -2)
