"""Small dense linear algebra by unrolled Gauss-Jordan elimination.

Counterpart of ``gab1_shp2_tpu/ops/smalllu.py``: batched over arbitrary
leading dimensions, written out of place (selects instead of indexed
writes) so that ``torch.func.jvp``/``vmap`` trace it.  Inverting the
10x10 Newton blocks explicitly turns every later triangular solve into a
batched matmul.
"""

from __future__ import annotations

import torch


def gauss_jordan_solve(A: torch.Tensor, B: torch.Tensor, *,
                       pivoting: bool = False) -> torch.Tensor:
    """Solve ``A @ X = B`` for small n by Gauss-Jordan.

    ``A``: (..., n, n); ``B``: (..., n, m).  The default is pivot-free
    with pivots clamped to +-1e-30 (f64) or +-1e-20 (otherwise): the
    matrices it factors are ``I - a*h*J``, diagonally dominant for the
    steps an adaptive integrator accepts, and a garbage solve surfaces
    as a rejected step.  ``pivoting=True`` takes partial pivoting for
    general matrices.
    """
    n = A.shape[-1]
    M = torch.cat([A, B], dim=-1)  # (..., n, n+m)
    rows = torch.arange(n, device=A.device)
    tiny = 1e-30 if M.dtype == torch.float64 else 1e-20
    for k in range(n):
        is_k = (rows == k)[:, None]
        if pivoting:
            col = M[..., :, k].abs()
            col = torch.where(rows < k, -torch.inf, col)  # only rows >= k
            p = torch.argmax(col, dim=-1)  # (...,)
            idx = p[..., None, None].expand(p.shape + (1, M.shape[-1]))
            row_k = torch.take_along_dim(M, idx, dim=-2)[..., 0, :]
            is_p = (rows == p[..., None])[..., :, None]
            M = torch.where(is_k, row_k[..., None, :],
                            torch.where(is_p, M[..., k:k + 1, :], M))
            piv = M[..., k:k + 1, k:k + 1]
        else:
            piv = M[..., k:k + 1, k:k + 1]
            piv = torch.where(piv.abs() < tiny,
                              torch.where(piv < 0, -tiny, tiny), piv)
        # eliminate column k everywhere except row k
        row_k = M[..., k:k + 1, :] / piv
        factors = M[..., :, k:k + 1]
        M = torch.where(is_k, row_k, M - factors * row_k)
    return M[..., n:]


def inv_small(A: torch.Tensor, *, pivoting: bool = False) -> torch.Tensor:
    """Explicit inverse of small matrices via Gauss-Jordan."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return gauss_jordan_solve(A, eye, pivoting=pivoting)
