"""Structure-aware block-tridiagonal Jacobian bands, lane-minor.

Counterpart of ``gab1_shp2_tpu/ops/jacobian.py:fast_block_jacobian_lanes``.
The MoL right-hand side couples each node only to its two neighbours
(and the last node to the membrane through the Robin closure), so the
Jacobian is block-tridiagonal with (10, 10) blocks.  The diffusion
stencil's blocks are analytic (diagonal, scaled by ``d_eff`` and the
metric factors); only the pointwise pieces are differentiated, by
forward-mode dual numbers run through the same rate functions that the
right-hand side uses:

  * 10 seeds of ``bulk_rates`` over all (node, lane) points,
  * 18 seeds of the boundary map ``H(C_near, m) = (C_R, memb_rates)``,
    which deliver the total derivatives of the closure.

(``torch.func.jvp`` computes the same, but its per-op overhead is an
order of magnitude above the duals' on small tensors.)

Entry convention: ``band[block_row, row_species, col_species, lane]``;
``lower`` couples block j to j-1, ``upper`` to j+1.
"""

from __future__ import annotations

from typing import Dict

import torch

from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.models.species import N_CYTO, N_MEMB
from gab1_shp2_tpu_torch.models.system import Geometry
from gab1_shp2_tpu_torch.ops import rhs as rhs_mod

BLK = N_CYTO  # block size (membrane block zero-padded from 8 to 10)


class _Dual:
    """Forward-mode dual number: a value ``v`` and a tangent ``d`` of the
    same shape.

    The rate functions of ``ops/rhs.py`` run on it unchanged (element-wise
    arithmetic, indexing, ``torch.stack``/``torch.cat``/``zeros_like``).
    Seeds ride in the lane axis: the value is repeated once per seed, so
    one evaluation yields every directional derivative at once.  Plain
    tensors mixed in are constants.
    """

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __getitem__(self, i):
        return _Dual(self.v[i], self.d[i])

    def __add__(a, b):
        if isinstance(b, _Dual):
            return _Dual(a.v + b.v, a.d + b.d)
        return _Dual(a.v + b, a.d)

    def __radd__(a, b):
        return _Dual(b + a.v, a.d)

    def __sub__(a, b):
        if isinstance(b, _Dual):
            return _Dual(a.v - b.v, a.d - b.d)
        return _Dual(a.v - b, a.d)

    def __rsub__(a, b):
        return _Dual(b - a.v, -a.d)

    def __mul__(a, b):
        if isinstance(b, _Dual):
            return _Dual(a.v * b.v, a.d * b.v + a.v * b.d)
        return _Dual(a.v * b, a.d * b)

    def __rmul__(a, b):
        return _Dual(b * a.v, b * a.d)

    def __truediv__(a, b):
        if isinstance(b, _Dual):
            q = a.v / b.v
            return _Dual(q, (a.d - q * b.d) / b.v)
        return _Dual(a.v / b, a.d / b)

    def __pow__(a, n: int):
        return _Dual(a.v**n, (n * a.v ** (n - 1)) * a.d)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.stack, torch.cat):
            parts = args[0]
            vs = [x.v if isinstance(x, _Dual) else x for x in parts]
            ds = [x.d if isinstance(x, _Dual) else torch.zeros_like(x)
                  for x in parts]
            return _Dual(func(vs, *args[1:], **kwargs),
                         func(ds, *args[1:], **kwargs))
        if func is torch.zeros_like:
            return func(args[0].v, *args[1:], **kwargs)
        # Tensor (op) _Dual: a TypeError here makes Python fall back to
        # the reflected operator of _Dual
        raise TypeError(f"{func} is not defined on dual numbers")


def _seeded(x: torch.Tensor, lane_dim: int, tangents: torch.Tensor):
    """A dual of ``x`` repeated once per seed along its lane axis;
    ``tangents`` has the shape of the result."""
    reps = [1] * x.ndim
    reps[lane_dim] = tangents.shape[lane_dim] // x.shape[lane_dim]
    return _Dual(x.repeat(*reps), tangents)


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
    # dual evaluation over (M, seed*B) points
    eye10 = torch.eye(N_CYTO, dtype=dtype, device=dev)
    S = N_CYTO
    k_r = {n: v.repeat(S) for n, v in k.items()}
    tan = eye10[:, None, :, None].expand(N_CYTO, M, S, B)
    C_d = _seeded(C_int, 2, tan.reshape(N_CYTO, M, S * B))
    Jr = rhs_mod.bulk_rates(system, C_d, k_r).d.reshape(N_CYTO, M, S, B)
    Dreact = Jr.permute(1, 0, 2, 3)                       # (M,10,10,B)

    # --- boundary closure: total derivatives of (C_R, dm) w.r.t.
    # (C_near, m) from 18 seeds, one dual evaluation over seed*B lanes
    S = N_CYTO + N_MEMB
    eye18 = torch.eye(S, dtype=dtype, device=dev)
    k_b = {n: v.repeat(S) for n, v in k.items()}
    cn_d = _seeded(C_near_t, 0, eye18[:, None, :N_CYTO].expand(
        S, B, N_CYTO).reshape(S * B, N_CYTO))
    m_d = _seeded(m_t, 0, eye18[:, None, N_CYTO:].expand(
        S, B, N_MEMB).reshape(S * B, N_MEMB))
    C_R = rhs_mod.bc_closure(system, cn_d, m_d, k_b, d_eff.repeat(S, 1), dr)
    dm = rhs_mod.memb_rates(system, m_d, C_R, k_b)
    Tcr = C_R.d.reshape(S, B, N_CYTO)         # (seed, B, row)
    Tdm = dm.d.reshape(S, B, N_MEMB)
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

    # interior diagonal: reactions + stencil center
    diag_int = Dreact + eye_b * (-2.0 * inv2) * de_row
    # node 0: the r=0 ghost copies node 0, folding c_m into the center
    diag_int[0] += eye10[:, :, None] * (c_m[0] * de_l)[:, None, :]
    # node M-1: u_{j+1} is the eliminated C_R(C_near=node M-1, m)
    diag_int[M - 1] += (c_p[M - 1] * de_l)[:, None, :] * Jcr_cn

    diag_memb = torch.zeros((BLK, BLK, B), dtype=dtype, device=dev)
    diag_memb[:N_MEMB, :N_MEMB] = dm_dm
    diag = torch.cat([diag_int, diag_memb[None]], dim=0)

    # lower band: stencil blocks for j >= 1; the membrane row couples to
    # the last interior node through C_R
    low_int = eye_b * (c_m[:, None, None, None] * de_row)
    low_int[0] = 0.0
    low_memb = torch.zeros((BLK, BLK, B), dtype=dtype, device=dev)
    low_memb[:N_MEMB] = dm_dcn
    lower = torch.cat([low_int, low_memb[None]], dim=0)

    # upper band: stencil blocks for j <= M-2; node M-1 couples to the
    # membrane block through C_R's m-dependence
    up_int = eye_b * (c_p[:, None, None, None] * de_row)
    up_int[M - 1] = 0.0
    up_int[M - 1, :, :N_MEMB] = (c_p[M - 1] * de_l)[:, None, :] * Jcr_m
    upper = torch.cat(
        [up_int, torch.zeros((1, BLK, BLK, B), dtype=dtype, device=dev)],
        dim=0)
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
