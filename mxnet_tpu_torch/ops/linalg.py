"""Linear-algebra ops of the port (``linalg_*``): the port of
``mxnet_tpu/ops/linalg.py``.

The reference writes each op in ``jnp.linalg`` / ``jax.scipy.linalg``
(no ``pallas_call``); here they map to ``torch.linalg`` and
``torch.linalg.solve_triangular`` (LAPACK on the CPU; cuBLAS, cuSOLVER
or MAGMA on the card), differentiated by torch's autograd.  The
reference's conventions are kept as they are:

- ``potrf`` and ``syevd`` read the symmetrized input ``(A + A^T) / 2``,
  as ``jnp.linalg.cholesky`` / ``eigh`` do by default: equal on a
  symmetric input, and the gradient is the symmetric one JAX gives;
- ``trmm`` multiplies by the whole of ``A`` and ignores ``lower``
  (upstream MXNet reads only the named triangle; ROADMAP.md C13);
- ``trsm`` with ``rightside`` solves ``op(A)^T X^T = B^T`` with the
  ``trans`` flag swapped, as the reference does;
- ``gelqf`` is the QR of ``A^T`` transposed and ``syevd`` returns the
  eigenvectors as rows: both are unique only up to one sign per row,
  which two LAPACK builds may fix apart (float32 ``eigh`` does between
  the two packages on the CPU) and cuSOLVER on the card too;
- ``extracttrian`` packs the triangle row by row (``tril_indices`` /
  ``triu_indices``, made on the tensor's device: no host copy).

``potrf`` and ``inverse`` call the ``_ex`` forms, which return LAPACK's
status instead of reading it back: no host synchronization on the card,
and no error where the reference raises none (it returns what the
factorization gives).  ``syevd`` is the one op here that synchronizes on
the card: ``torch.linalg.eigh`` reads cuSOLVER's status on the host, and
torch has no form without that check.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_potri",
           "linalg_trmm", "linalg_trsm", "linalg_sumlogdiag",
           "linalg_extractdiag", "linalg_makediag", "linalg_extracttrian",
           "linalg_syrk", "linalg_gelqf", "linalg_syevd", "linalg_inverse",
           "linalg_det", "linalg_slogdet"]


def _t(x):
    return x.transpose(-1, -2)


def _sym(a):
    """``(A + A^T) / 2``: the input ``jnp.linalg`` reads by default."""
    return (a + _t(a)) / 2


def _solve_tri(a, b, lower, trans):
    """``jax.scipy.linalg.solve_triangular(a, b, lower, trans)``:
    ``op(a) x = b`` reading the ``lower`` (or upper) triangle of ``a``."""
    if trans:
        return torch.linalg.solve_triangular(_t(a), b, upper=lower)
    return torch.linalg.solve_triangular(a, b, upper=not lower)


@register("_linalg_gemm", arg_names=["A", "B", "C"],
          aliases=("linalg_gemm",))
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """``alpha * op(A) op(B) + beta * C`` (reference: la_op.cc gemm)."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * (a @ b) + beta * C


@register("_linalg_gemm2", arg_names=["A", "B"], aliases=("linalg_gemm2",))
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    """``alpha * op(A) op(B)`` (reference: la_op.cc gemm2)."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * (a @ b)


@register("_linalg_potrf", arg_names=["A"], aliases=("linalg_potrf",))
def linalg_potrf(A):
    """The lower Cholesky factor (reference: la_op.cc potrf)."""
    return torch.linalg.cholesky_ex(_sym(A))[0]


@register("_linalg_potri", arg_names=["A"], aliases=("linalg_potri",))
def linalg_potri(A):
    """``(L L^T)^-1`` from the lower factor ``L`` (reference: la_op.cc
    potri)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    inv_l = _solve_tri(A, eye, lower=True, trans=False)
    return _t(inv_l) @ inv_l


@register("_linalg_trmm", arg_names=["A", "B"], aliases=("linalg_trmm",))
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(A) B`` (or ``B op(A)``) over the whole of ``A``: the
    reference ignores ``lower`` (ROADMAP.md C13)."""
    a = _t(A) if transpose else A
    out = (B @ a) if rightside else (a @ B)
    return alpha * out


@register("_linalg_trsm", arg_names=["A", "B"], aliases=("linalg_trsm",))
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve ``op(A) X = alpha B`` (or ``X op(A) = alpha B``)."""
    if rightside:
        # X op(A) = B  <=>  op(A)^T X^T = B^T
        x = _solve_tri(A, _t(B), lower, trans=not transpose)
        return alpha * _t(x)
    return alpha * _solve_tri(A, B, lower, trans=transpose)


@register("_linalg_sumlogdiag", arg_names=["A"],
          aliases=("linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    """The sum of the logs of the diagonal (reference: la_op.cc
    sumlogdiag)."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("_linalg_extractdiag", arg_names=["A"],
          aliases=("linalg_extractdiag",))
def linalg_extractdiag(A, offset=0):
    """The ``offset``-th diagonal (reference: la_op.cc extractdiag)."""
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register("_linalg_makediag", arg_names=["A"], aliases=("linalg_makediag",))
def linalg_makediag(A, offset=0):
    """Vectors as the ``offset``-th diagonal of square matrices of side
    ``len + |offset|`` (reference: la_op.cc makediag)."""
    return torch.diag_embed(A, offset=int(offset))


@register("_linalg_extracttrian", arg_names=["A"],
          aliases=("linalg_extracttrian",))
def linalg_extracttrian(A, offset=0, lower=True):
    """The lower (upper) triangle from diagonal ``offset`` on, packed row
    by row (reference: la_op.cc extracttrian)."""
    n = A.shape[-1]
    pick = torch.tril_indices if lower else torch.triu_indices
    rc = pick(n, n, int(offset), device=A.device)
    return A.reshape(A.shape[:-2] + (n * n,))[..., rc[0] * n + rc[1]]


@register("_linalg_syrk", arg_names=["A"], aliases=("linalg_syrk",))
def linalg_syrk(A, transpose=False, alpha=1.0):
    """``alpha * op(A) op(A)^T`` (reference: la_op.cc syrk)."""
    a = _t(A) if transpose else A
    return alpha * (a @ _t(a))


@register("_linalg_gelqf", arg_names=["A"], num_outputs=2,
          aliases=("linalg_gelqf",))
def linalg_gelqf(A):
    """LQ factorization ``A = L Q`` (reference: la_op.cc gelqf)."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    return _t(r), _t(q)


@register("_linalg_syevd", arg_names=["A"], num_outputs=2,
          aliases=("linalg_syevd",))
def linalg_syevd(A):
    """Eigenvectors (as rows) and ascending eigenvalues of a symmetric
    matrix (reference: la_op.cc syevd)."""
    w, u = torch.linalg.eigh(_sym(A))
    return _t(u), w


@register("_linalg_inverse", arg_names=["A"], aliases=("linalg_inverse",))
def linalg_inverse(A):
    """Batched inverse (reference: la_op.cc inverse)."""
    return torch.linalg.inv_ex(A)[0]


@register("_linalg_det", arg_names=["A"], aliases=("linalg_det",))
def linalg_det(A):
    """Batched determinant (reference: la_op.cc det)."""
    return torch.linalg.det(A)


@register("_linalg_slogdet", arg_names=["A"], num_outputs=2,
          aliases=("linalg_slogdet",))
def linalg_slogdet(A):
    """Sign and ``log|det|`` (reference: la_op.cc slogdet)."""
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet
