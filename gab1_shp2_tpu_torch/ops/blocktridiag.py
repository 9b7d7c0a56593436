"""Block-tridiagonal factorization and solve by a block Thomas sweep.

Counterpart of ``gab1_shp2_tpu/ops/blocktridiag.py``.  The MoL Jacobian
is block-tridiagonal with one 10x10 block per radial node plus the
(padded) membrane block.  The JAX package runs the sweep as a
``lax.scan``; here it is a Python loop over the block rows, each
iteration a few small batched products.  The stiff solvers use block
cyclic reduction (``ops/cyclic_reduction.py``); this sweep is the
sequential reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gab1_shp2_tpu_torch.ops.smalllu import inv_small


class BTFactors(NamedTuple):
    """Explicit inverses of the Schur-complement diagonals
    W_i = D_i - L_i G_{i-1}, the propagated upper blocks
    G_i = W_i^{-1} U_i and the lower blocks (needed by the solve)."""

    Winv: torch.Tensor  # (NB, n, n)
    G: torch.Tensor     # (NB, n, n)
    L: torch.Tensor     # (NB, n, n), L[0] zeroed


def bt_factor(L: torch.Tensor, D: torch.Tensor,
              U: torch.Tensor) -> BTFactors:
    """Factor the block-tridiagonal matrix [L_i, D_i, U_i], blocks
    (NB, n, n); ``L[0]`` and ``U[-1]`` are ignored."""
    L = torch.cat([torch.zeros_like(L[:1]), L[1:]], dim=0)
    G_prev = torch.zeros_like(D[0])
    Winv, G = [], []
    for i in range(D.shape[0]):
        Wi = D[i] - L[i] @ G_prev
        Winv_i = inv_small(Wi)
        G_prev = Winv_i @ U[i]
        Winv.append(Winv_i)
        G.append(G_prev)
    return BTFactors(Winv=torch.stack(Winv), G=torch.stack(G), L=L)


def bt_solve(fac: BTFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve the factored system for the right-hand side ``b`` (NB, n)."""
    NB = b.shape[0]
    z_prev = torch.zeros_like(b[0])
    z = []
    for i in range(NB):
        z_prev = fac.Winv[i] @ (b[i] - fac.L[i] @ z_prev)
        z.append(z_prev)
    x_next = torch.zeros_like(b[0])
    x = [None] * NB
    for i in reversed(range(NB)):
        x_next = z[i] - fac.G[i] @ x_next
        x[i] = x_next
    return torch.stack(x)


def bt_matvec(L: torch.Tensor, D: torch.Tensor, U: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """The block-tridiagonal matrix times ``x`` (NB, n)."""
    y = torch.einsum("bij,bj->bi", D, x)
    zero = torch.zeros_like(x[:1])
    lower = torch.einsum("bij,bj->bi", L[1:], x[:-1])
    upper = torch.einsum("bij,bj->bi", U[:-1], x[1:])
    return (y + torch.cat([zero, lower], dim=0)
            + torch.cat([upper, zero], dim=0))
