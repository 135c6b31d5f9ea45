"""Linear-algebra ops (counterpart of ``mxnet_tpu/ops/linalg.py``): the
``linalg_*`` family of ``mx.nd`` under the JAX package's names,
arguments and output conventions, batched over leading dimensions and
differentiable through torch autograd.  None is a TPU kernel: they run
on ``torch.linalg`` (cuSOLVER and cuBLAS on the card, LAPACK on the
CPU).  Eigenvectors (``linalg_syevd``) and singular vectors
(``linalg_svd``) are fixed up to a sign per vector, which each library
chooses its own way.  ``moments`` is in :mod:`.nn`.
"""
from __future__ import annotations

import math

import torch

from .table import register

__all__ = []


def _t(x):
    return x.transpose(-1, -2)


def _solve(a, b, lower, trans):
    """Solve ``op(a) x = b`` with ``a`` triangular (only its ``lower``
    or upper triangle read), ``op`` a transpose when ``trans``."""
    if trans:
        return torch.linalg.solve_triangular(_t(a), b, upper=lower)
    return torch.linalg.solve_triangular(a, b, upper=not lower)


@register("linalg_gemm", args=("A", "B", "C"))
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """``alpha * op(A) op(B) + beta * C``."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2", args=("A", "B"))
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    """``alpha * op(A) op(B)``."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf", args=("A",))
def linalg_potrf(A):
    """The Cholesky factor ``L`` of ``A = L L^T``."""
    return torch.linalg.cholesky(A)


@register("linalg_potri", args=("A",))
def linalg_potri(A):
    """``(L L^T)^-1`` from the Cholesky factor ``L``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape).contiguous()
    linv = _solve(A, eye, lower=True, trans=False)
    return torch.matmul(_t(linv), linv)


@register("linalg_trsm", args=("A", "B"))
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``X`` with ``op(A) X = alpha B`` (``X op(A) = alpha B`` when
    ``rightside``), ``A`` triangular."""
    if rightside:
        return _t(_solve(_t(A), _t(alpha * B), lower=not lower,
                         trans=transpose))
    return _solve(A, alpha * B, lower=lower, trans=transpose)


@register("linalg_trmm", args=("A", "B"))
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(tri(A)) B`` (``B op(tri(A))`` when ``rightside``)."""
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = _t(tri)
    if rightside:
        return alpha * torch.matmul(B, tri)
    return alpha * torch.matmul(tri, B)


@register("linalg_syrk", args=("A",))
def linalg_syrk(A, transpose=False, alpha=1.0):
    """``alpha A A^T`` (``alpha A^T A`` when ``transpose``)."""
    if transpose:
        return alpha * torch.matmul(_t(A), A)
    return alpha * torch.matmul(A, _t(A))


@register("linalg_sumlogdiag", args=("A",))
def linalg_sumlogdiag(A):
    """``sum(log(diag(A)))`` of each matrix."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("linalg_extractdiag", args=("A",))
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register("linalg_makediag", args=("A",))
def linalg_makediag(A, offset=0):
    return torch.diag_embed(A, offset=int(offset))


def _trian_index(n, offset, lower, device):
    idx = torch.tril_indices(n, n, offset, device=device) if lower \
        else torch.triu_indices(n, n, offset, device=device)
    return idx[0], idx[1]


@register("linalg_extracttrian", args=("A",))
def linalg_extracttrian(A, offset=0, lower=True):
    """The triangle of each matrix, flattened row by row."""
    rows, cols = _trian_index(A.shape[-1], int(offset), lower, A.device)
    return A[..., rows, cols]


@register("linalg_maketrian", args=("A",))
def linalg_maketrian(A, offset=0, lower=True):
    """The inverse of :func:`linalg_extracttrian` at ``offset`` 0."""
    if offset != 0:
        raise NotImplementedError("maketrian supports offset=0")
    k = A.shape[-1]
    n = int((math.sqrt(8 * k + 1) - 1) / 2)
    rows, cols = _trian_index(n, 0, lower, A.device)
    flat = torch.zeros(A.shape[:-1] + (n * n,), dtype=A.dtype,
                       device=A.device)
    return flat.index_copy(-1, rows * n + cols, A) \
        .reshape(A.shape[:-1] + (n, n))


@register("linalg_syevd", args=("A",))
def linalg_syevd(A):
    """``(U, L)`` with ``A = U^T diag(L) U``: eigenvectors as rows,
    eigenvalues ascending."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("linalg_inverse", args=("A",), aliases=("inverse",))
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_det", args=("A",), aliases=("det",))
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet", args=("A",), aliases=("slogdet",))
def linalg_slogdet(A):
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


@register("linalg_svd", args=("A",))
def linalg_svd(A):
    """The thin SVD as ``(UT, L, V)`` with ``A = UT^T diag(L) V``."""
    u, s, vh = torch.linalg.svd(A, full_matrices=False)
    return _t(u), s, vh
