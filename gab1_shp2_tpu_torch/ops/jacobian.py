"""Structure-aware block-tridiagonal Jacobian bands, lane-minor.

Counterpart of ``gab1_shp2_tpu/ops/jacobian.py:fast_block_jacobian_lanes``.
The MoL right-hand side couples each node only to its two neighbours
(and the last node to the membrane through the Robin closure), so the
Jacobian is block-tridiagonal with (10, 10) blocks.  The diffusion
stencil's blocks are analytic (diagonal, scaled by ``d_eff`` and the
metric factors); only the pointwise pieces are differentiated, by
forward-mode dual numbers (``ops/fwdgrad.FwdDual``, one tangent per
seed) run through the same rate functions that the right-hand side
uses:

  * 10 seeds of ``bulk_rates`` over all (node, lane) points,
  * 18 seeds of the boundary map ``H(C_near, m) = (C_R, memb_rates)``,
    which deliver the total derivatives of the closure.

(``torch.func.jvp`` computes the same, but its per-op overhead is an
order of magnitude above the duals' on small tensors.)  Under a
gradient evaluation the state and the kinetics are duals themselves;
the seeds then sit one level above them, and the bands carry the
gradient's tangents.

Entry convention: ``band[block_row, row_species, col_species, lane]``;
``lower`` couples block j to j-1, ``upper`` to j+1.

The single-member block layout (``blocks_to_state``/``state_to_blocks``)
and the 38-colored-JVP Jacobians (``block_jacobian``,
``gab1_shp2_tpu/ops/jacobian.py:39-118``, and ``block_jacobian_lanes``,
``gab1_shp2_tpu/ops/batch_stiff.py:325-362``) are here too.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.models.species import N_CYTO, N_MEMB
from gab1_shp2_tpu_torch.models.system import Geometry
from gab1_shp2_tpu_torch.ops import rhs as rhs_mod
from gab1_shp2_tpu_torch.ops.fwdgrad import seed

BLK = N_CYTO  # block size (membrane block zero-padded from 8 to 10)


def lane_bands(system, y: torch.Tensor, k: Dict[str, torch.Tensor],
               d_eff: torch.Tensor, rj: torch.Tensor, dr: float):
    """Bands (lower, diag, upper), each (NB, 10, 10, B), at state ``y``
    (NB, 10, B) for per-lane kinetics ``k`` (name -> (B,)) and
    diffusivities ``d_eff`` (B, 10); ``rj`` (M,) is the interior radii
    in ``y``'s dtype."""
    NB, _, B = y.shape
    M = NB - 1
    dtype, dev = y.dtype, y.device
    C_int = y[:-1].movedim(0, 1)                          # (10, M, B)
    m_t = y[-1, :N_MEMB, :].T                             # (B, 8)
    C_near_t = C_int[:, -1, :].T                          # (B, 10)

    # --- reaction Jacobian: 10 seeds (one per input species) in one
    # dual evaluation over the (M, B) points
    eye10 = torch.eye(N_CYTO, dtype=dtype, device=dev)
    over = (d_eff,) + tuple(k.values())
    C_d = seed(C_int, eye10[:, :, None, None].expand(
        N_CYTO, N_CYTO, M, B), *over)
    Jr = rhs_mod.bulk_rates(system, C_d, k).d          # (seed, row, M, B)
    Dreact = Jr.permute(2, 1, 0, 3)                       # (M,10,10,B)

    # --- boundary closure: total derivatives of (C_R, dm) w.r.t.
    # (C_near, m) from 18 seeds, one dual evaluation over the B lanes
    S = N_CYTO + N_MEMB
    eye18 = torch.eye(S, dtype=dtype, device=dev)
    cn_d = seed(C_near_t, eye18[:, None, :N_CYTO].expand(S, B, N_CYTO),
                m_t, *over)
    m_d = seed(m_t, eye18[:, None, N_CYTO:].expand(S, B, N_MEMB),
               C_near_t, *over)
    C_R = rhs_mod.bc_closure(system, cn_d, m_d, k, d_eff, dr)
    dm = rhs_mod.memb_rates(system, m_d, C_R, k)
    Tcr = C_R.d                               # (seed, B, row)
    Tdm = dm.d
    Jcr_cn = Tcr[:N_CYTO].permute(2, 0, 1)    # (10 row, 10 col, B)
    Jcr_m = Tcr[N_CYTO:].permute(2, 0, 1)     # (10, 8, B)
    dm_dcn = Tdm[:N_CYTO].permute(2, 0, 1)    # (8, 10, B)
    dm_dm = Tdm[N_CYTO:].permute(2, 0, 1)     # (8, 8, B)

    # --- stencil coefficients (basepdesolver.jl:151)
    inv2 = 1.0 / dr**2
    if system.geometry is Geometry.SPHERICAL:
        met = 1.0 / (rj * dr)
    else:
        met = torch.zeros_like(rj)
    c_m = inv2 - met                                      # coeff of u_{j-1}
    c_p = inv2 + met                                      # coeff of u_{j+1}
    de_l = d_eff.T                                        # (10, B)
    de_row = de_l[None, :, None, :]
    eye_b = eye10[None, :, :, None]

    # interior diagonal: reactions + stencil center (assembled out of
    # place, so the bands can carry forward-mode tangents)
    diag_int = Dreact + eye_b * (-2.0 * inv2) * de_row
    # node 0: the r=0 ghost copies node 0, folding c_m into the center
    first = diag_int[0] + eye10[:, :, None] * (c_m[0] * de_l)[:, None, :]
    # node M-1: u_{j+1} is the eliminated C_R(C_near=node M-1, m)
    close = (c_p[M - 1] * de_l)[:, None, :] * Jcr_cn
    if M == 1:
        diag_int = (first + close)[None]
    else:
        diag_int = torch.cat([first[None], diag_int[1:M - 1],
                              (diag_int[M - 1] + close)[None]], dim=0)

    zpad_c = torch.zeros((N_MEMB, BLK - N_MEMB, B), dtype=dtype, device=dev)
    zpad_r = torch.zeros((BLK - N_MEMB, BLK, B), dtype=dtype, device=dev)
    diag_memb = torch.cat([torch.cat([dm_dm, zpad_c], dim=1), zpad_r], dim=0)
    diag = torch.cat([diag_int, diag_memb[None]], dim=0)

    # lower band: stencil blocks for j >= 1; the membrane row couples to
    # the last interior node through C_R
    low_int = eye_b * (c_m[:, None, None, None] * de_row)
    low_int = torch.cat([torch.zeros_like(low_int[:1]), low_int[1:]], dim=0)
    low_memb = torch.cat([dm_dcn, zpad_r], dim=0)
    lower = torch.cat([low_int, low_memb[None]], dim=0)

    # upper band: stencil blocks for j <= M-2; node M-1 couples to the
    # membrane block through C_R's m-dependence
    up_int = eye_b * (c_p[:, None, None, None] * de_row)
    up_last = torch.cat(
        [(c_p[M - 1] * de_l)[:, None, :] * Jcr_m,
         torch.zeros((BLK, BLK - N_MEMB, B), dtype=dtype, device=dev)],
        dim=1)
    upper = torch.cat(
        [up_int[:M - 1], up_last[None],
         torch.zeros((1, BLK, BLK, B), dtype=dtype, device=dev)], dim=0)
    return lower, diag, upper


def interior_radii(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``r[1:-1]`` in ``like``'s dtype and device."""
    return r[1:-1].to(dtype=like.dtype, device=like.device)


def fast_block_jacobian_lanes(system, y: torch.Tensor, params: Params,
                              r: torch.Tensor, dr: float):
    """Exact block-tridiagonal Jacobian of the lane-minor MoL RHS at ``y``
    (NB, 10, B) for batched ``params`` (B, ...); ``r`` is the (Nr+1,)
    radial grid.  Returns (lower, diag, upper), each (NB, 10, 10, B)."""
    k = rhs_mod.kdict(params.k)
    d_eff = rhs_mod.effective_diffusivities(system, params)
    return lane_bands(system, y, k, d_eff, interior_radii(r, y), dr)


# ---------------------------------------------------------------------------
# single-member block layout and the colored-JVP Jacobian
# ---------------------------------------------------------------------------


def blocks_to_state(y_blocks: torch.Tensor):
    """(NB, 10) block layout -> (C_int (10, M), m (8,))."""
    return y_blocks[:-1].T, y_blocks[-1, :N_MEMB]


def state_to_blocks(C_int: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(C_int (10, M), m (8,)) -> (NB, 10) block layout (membrane padded)."""
    pad = m.new_zeros((BLK - N_MEMB,))
    return torch.cat([C_int.T, torch.cat([m, pad])[None]], dim=0)


def _color_seeds(NB: int, dtype) -> np.ndarray:
    """The 38 JVP seed tangents, shape (38, NB, 10): 30 node colors (one
    per species and node index mod 3; same-colored nodes are >= 3 apart,
    so their +-1-node coupling windows never overlap) and 8 membrane
    seeds."""
    seeds = np.zeros((3 * N_CYTO + N_MEMB, NB, BLK), dtype=np.float64)
    j = np.arange(NB - 1)
    for s in range(N_CYTO):
        for c in range(3):
            seeds[s * 3 + c, j[j % 3 == c], s] = 1.0
    for ms in range(N_MEMB):
        seeds[3 * N_CYTO + ms, NB - 1, ms] = 1.0
    return seeds.astype(dtype)


def block_jacobian_lanes(rhs_lanes, y: torch.Tensor):
    """Exact block-tridiagonal Jacobian (lower, diag, upper) of a
    lane-minor right-hand side ``rhs_lanes`` ((NB, 10, B) -> (NB, 10, B),
    parameters closed over) at ``y``, from 38 colored JVPs
    (``torch.func.vmap`` of ``torch.func.jvp`` over the seeds, tangents
    broadcast over lanes; nothing in the right-hand side branches on
    data).  Returns three (NB, 10, 10, B) stacks with
    ``J[row_block, row_species, col_species, lane]``; lower couples block
    i to i-1, upper to i+1.  The solvers use the cheaper
    :func:`lane_bands`."""
    NB, _, B = y.shape
    dtype, dev = y.dtype, y.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    seeds = torch.as_tensor(_color_seeds(NB, np_dtype), device=dev)

    def jvp_one(v):
        tangent = v[..., None].expand(y.shape)
        return torch.func.jvp(rhs_lanes, (y,), (tangent,))[1]

    T = torch.func.vmap(jvp_one)(seeds)  # (38, NB, 10, B)

    # T[s*3+c] is the response to perturbing every node j == c (mod 3)
    # in species s; at block j it belongs to the lower coupling if
    # (j-1) % 3 == c, the diagonal if j % 3 == c, the upper if
    # (j+1) % 3 == c
    Tn = T[: 3 * N_CYTO].reshape(N_CYTO, 3, NB, BLK, B)
    jidx = np.arange(NB)
    cidx = np.arange(3)

    def mask(offset):
        return torch.as_tensor(
            (jidx[None, :] + offset) % 3 == cidx[:, None], dtype=dtype,
            device=dev)  # (3, NB)

    lower = torch.einsum("scjrb,cj->jrsb", Tn, mask(-1))
    diag = torch.einsum("scjrb,cj->jrsb", Tn, mask(0))
    upper = torch.einsum("scjrb,cj->jrsb", Tn, mask(1))

    # membrane perturbations reach the last interior node (upper
    # coupling of block NB-2) and the membrane block itself; the node
    # einsum left zeros in those slots
    Tm = T[3 * N_CYTO:]  # (8, NB, 10, B)
    pad = torch.zeros((BLK - N_MEMB, BLK, B), dtype=dtype, device=dev)
    up_edge = torch.cat([Tm[:, NB - 2], pad]).movedim(0, 1)  # (10, 10, B)
    di_edge = torch.cat([Tm[:, NB - 1], pad]).movedim(0, 1)
    col_memb = torch.as_tensor(np.arange(BLK) < N_MEMB, dtype=dtype,
                               device=dev)[:, None]

    def rows(j):
        return torch.as_tensor(jidx == j, dtype=dtype,
                               device=dev)[:, None, None, None]

    upper = upper * (1.0 - rows(NB - 2) * col_memb) + rows(NB - 2) * up_edge
    diag = diag * (1.0 - rows(NB - 1) * col_memb) + rows(NB - 1) * di_edge
    return lower, diag, upper


def block_jacobian(rhs_blocks, y_blocks: torch.Tensor):
    """Exact block-tridiagonal Jacobian of a single-member right-hand
    side ``rhs_blocks`` ((NB, 10) -> (NB, 10)) at ``y_blocks``: the 38
    colored JVPs of :func:`block_jacobian_lanes` with one lane.  Returns
    three (NB, 10, 10) stacks."""
    bands = block_jacobian_lanes(lambda y: rhs_blocks(y[..., 0])[..., None],
                                 y_blocks[..., None])
    return tuple(b[..., 0] for b in bands)
