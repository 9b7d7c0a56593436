"""Block cyclic reduction for one block-tridiagonal system.

Counterpart of ``gab1_shp2_tpu/ops/cyclic_reduction.py``: the
single-member, padded-to-a-power-of-two reduction that
``ops/trbdf2.solve_stiff`` factors its Newton matrices with (the lane
version of the ensemble solvers is ``cr_factor_lanes`` in
``ops/batch_stiff.py``).  Each of the O(log2 NB) levels eliminates the
odd-indexed blocks in one batched operation; the factorization is
computed once per W and reused by every stage solve of a step.  Written
out of place, so ``torch.func.jvp``/``vmap`` trace it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from gab1_shp2_tpu_torch.ops.smalllu import inv_small


class CRLevel(NamedTuple):
    Dinv_odd: torch.Tensor  # (n_odd, n, n) inverses of eliminated blocks
    L_odd: torch.Tensor     # (n_odd, n, n) lower blocks of eliminated rows
    U_odd: torch.Tensor     # (n_odd, n, n) upper blocks of eliminated rows
    LDinv: torch.Tensor     # (n_even, n, n) L_even @ Dinv of left neighbour
    UDinv: torch.Tensor     # (n_even, n, n) U_even @ Dinv of right neighbour
    n_blocks: int           # size of the system entering this level


class CRFactors(NamedTuple):
    levels: Tuple[CRLevel, ...]
    root_inv: torch.Tensor  # (1, n, n)


def _pad_pow2(L, D, U, n_blocks):
    """Pad with decoupled identity blocks to the next power of two."""
    n = D.shape[-1]
    m = 1
    while m < n_blocks:
        m *= 2
    pad = m - n_blocks
    if pad:
        eye = torch.eye(n, dtype=D.dtype, device=D.device).expand(pad, n, n)
        zero = torch.zeros((pad, n, n), dtype=D.dtype, device=D.device)
        L = torch.cat([L, zero], dim=0)
        D = torch.cat([D, eye], dim=0)
        U = torch.cat([U, zero], dim=0)
    return L, D, U, m


def cr_factor(L: torch.Tensor, D: torch.Tensor,
              U: torch.Tensor) -> CRFactors:
    """Factor the block-tridiagonal matrix [L_i, D_i, U_i] (NB, n, n).

    ``L[0]`` and ``U[-1]`` are ignored.  At each level the odd-indexed
    blocks are eliminated; the reduced (even-indexed) system halves in
    size until one block remains.
    """
    nb0 = D.shape[0]
    L = torch.cat([torch.zeros_like(L[:1]), L[1:]], dim=0)
    U = torch.cat([U[:-1], torch.zeros_like(U[:1])], dim=0)
    L, D, U, nb = _pad_pow2(L, D, U, nb0)

    levels: List[CRLevel] = []
    while nb > 1:
        De, Do = D[0::2], D[1::2]
        Le, Lo = L[0::2], L[1::2]
        Ue, Uo = U[0::2], U[1::2]
        Dinv_odd = inv_small(Do)

        # even block m couples to odd neighbours m-1 (left) and m
        # (right); a zero block stands in for m=0's missing left one
        zero1 = torch.zeros_like(D[:1])
        Dinv_left = torch.cat([zero1, Dinv_odd[:-1]], dim=0)
        U_left = torch.cat([zero1, Uo[:-1]], dim=0)
        L_left = torch.cat([zero1, Lo[:-1]], dim=0)

        LDinv = Le @ Dinv_left
        UDinv = Ue @ Dinv_odd

        D_new = De - LDinv @ U_left - UDinv @ Lo
        L_new = -LDinv @ L_left
        U_new = -UDinv @ Uo

        levels.append(CRLevel(Dinv_odd=Dinv_odd, L_odd=Lo, U_odd=Uo,
                              LDinv=LDinv, UDinv=UDinv, n_blocks=nb))
        L, D, U = L_new, D_new, U_new
        nb //= 2

    return CRFactors(levels=tuple(levels), root_inv=inv_small(D))


def _mv(A, x):
    """Block matvec (b, i, j) @ (b, j) -> (b, i)."""
    return (A @ x[..., None])[..., 0]


def cr_solve(fac: CRFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve for the right-hand side ``b`` (NB, n) using the factors."""
    nb0, n = b.shape
    m = fac.levels[0].n_blocks if fac.levels else 1
    if m > nb0:
        b = torch.cat([b, b.new_zeros((m - nb0, n))], dim=0)

    # forward reduction: fold odd entries into even ones
    bs = [b]
    for lv in fac.levels:
        be, bo = b[0::2], b[1::2]
        zb = torch.zeros_like(b[:1])
        b = (be - _mv(lv.LDinv, torch.cat([zb, bo[:-1]], dim=0))
             - _mv(lv.UDinv, bo))
        bs.append(b)

    x = _mv(fac.root_inv, b)

    # back substitution: recover odd entries level by level
    for lv, b_lvl in zip(reversed(fac.levels), reversed(bs[:-1])):
        bo = b_lvl[1::2]
        # odd j sits between even j-1 (x[m]) and even j+1 (x[m+1]); the
        # last odd block has no right neighbour
        x_right = torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)
        rhs = bo - _mv(lv.L_odd, x) - _mv(lv.U_odd, x_right)
        x_odd = _mv(lv.Dinv_odd, rhs)
        x = torch.stack([x, x_odd], dim=1).reshape(lv.n_blocks, n)

    return x[:nb0]
