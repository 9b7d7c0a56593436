"""Lane-minor MoL RHS in double-f32 (EFT) arithmetic.

Counterpart of ``gab1_shp2_tpu/ops/rhs_df32.py``: the state is split
into an f32 hi/lo pair and the whole right-hand side — reaction
polynomials, Laplacian, boundary closure, membrane ODEs — is evaluated
with the compensated primitives of :mod:`gab1_shp2_tpu_torch.ops.df32`,
recombining to float64 at the end.  Every elementary operation carries
its rounding error, so the result matches the float64 RHS to ~2^-48.
It backs ``rhs_mixed="df32"`` of the batched stiff solver.

The generic mass-action lowering (``ops.rhs._net_reaction_terms``) is
reused as it is: it is written against arithmetic operators only, and
:class:`df32.DF32` implements them, so the same declarative reaction
tables, looped in the same order, drive both precisions.
"""

from __future__ import annotations

import torch

from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.models.species import CYTO, MEMB, N_MEMB
from gab1_shp2_tpu_torch.models.system import (
    Geometry,
    ReactionDiffusionSystem,
)
from gab1_shp2_tpu_torch.ops import df32 as d3
from gab1_shp2_tpu_torch.ops import rhs as rhs_mod
from gab1_shp2_tpu_torch.ops.df32 import DF32
from gab1_shp2_tpu_torch.ops.jacobian import BLK
from gab1_shp2_tpu_torch.ops.rhs import _ETOT_IDX, _K_IDX


def _kdict_df32(k: torch.Tensor):
    kd = d3.from_f64(k)
    return {name: kd[..., i] for name, i in _K_IDX.items()}


def _bulk_rates(system, C: DF32, k) -> DF32:
    zero = d3.zeros_like(C[0])
    out = {name: zero for name in CYTO}
    out = rhs_mod._net_reaction_terms(system.bulk_reactions,
                                      lambda s: C[CYTO[s]], k, out)
    return d3.stack([out[name] for name in CYTO])


def _memb_rates(system, m: DF32, C_R: DF32, k) -> DF32:
    zero = d3.zeros_like(m[..., 0])
    out = {name: zero for name in MEMB}
    out = rhs_mod._net_reaction_terms(system.memb_reactions,
                                      lambda s: m[..., MEMB[s]], k, out)
    for sb in system.surface_bindings:
        net = (k[sb.kf] * C_R[..., CYTO[sb.cyto]] * m[..., MEMB[sb.memb]]
               - k[sb.kr] * m[..., MEMB[sb.product]])
        out[sb.memb] = out[sb.memb] - net
        out[sb.product] = out[sb.product] + net
    return d3.stack([out[name] for name in MEMB], dim=-1)


def _etot(m: DF32) -> DF32:
    return rhs_mod.ETOT_SCALE * sum(
        (m[..., i] for i in _ETOT_IDX), d3.zeros_like(m[..., 0]))


def _bc_closure(system, C_near: DF32, m: DF32, k, d_eff: DF32, dr) -> DF32:
    zero = d3.zeros_like(C_near[..., 0])
    gains = [zero] * len(CYTO)
    losses = [zero] * len(CYTO)
    for sb in system.surface_bindings:
        ci = CYTO[sb.cyto]
        gains[ci] = gains[ci] + k[sb.kr] * m[..., MEMB[sb.product]]
        losses[ci] = losses[ci] + k[sb.kf] * m[..., MEMB[sb.memb]]
    Et = _etot(m)
    losses[CYTO["iSFK"]] = losses[CYTO["iSFK"]] + k["kSa"] * Et

    g = d3.stack(gains, dim=-1)
    loss = d3.stack(losses, dim=-1)
    C_R = (C_near + g * dr / d_eff) / (1.0 + loss * dr / d_eff)
    a = CYTO["aSFK"]
    asfk_R = (C_near[..., a]
              + k["kSa"] * C_R[..., CYTO["iSFK"]] * Et * dr / d_eff[..., a])
    mask = torch.arange(len(CYTO), device=C_R.hi.device) == a
    return d3.where(mask, asfk_R[..., None], C_R)


def make_mol_rhs_lanes_df32(system: ReactionDiffusionSystem, R: float,
                            dr: float):
    """``f(y (NB, BLK, B) f64, params f64) -> (NB, BLK, B) f64`` with the
    interior evaluated entirely in compensated f32 pairs, and the (Nr+1,)
    float64 radial grid.  Mirror of ``batch_stiff.make_mol_rhs_lanes``
    (same layout contract)."""
    Nr = int(round(R / dr))
    r = torch.arange(Nr + 1, dtype=torch.float64) * dr
    inv_dr2_64 = torch.tensor(1.0 / dr**2, dtype=torch.float64)
    # metric coefficient 1/(r_j * dr) for interior nodes j=1..M
    inv_rdr_64 = 1.0 / (r[1:-1] * dr)
    # both split once per device: a copy from the host inside every call
    # would wait for the card (and cannot stand in a CUDA graph)
    on_device = {}

    def consts(dev):
        if dev not in on_device:
            on_device[dev] = (d3.from_f64(inv_dr2_64.to(dev)),
                              d3.from_f64(inv_rdr_64.to(dev)))
        return on_device[dev]

    def rhs(y: torch.Tensor, params: Params) -> torch.Tensor:
        B = y.shape[-1]
        k = _kdict_df32(params.k)
        d_eff = d3.from_f64(rhs_mod.effective_diffusivities(system, params))
        inv_dr2, inv_rdr = consts(y.device)
        yd = d3.from_f64(y)
        C_int = d3.moveaxis(yd[:-1], 0, 1)                 # (10, M, B)
        m_t = d3.moveaxis(yd[-1, :N_MEMB, :], 0, -1)       # (B, 8)
        C_near_t = d3.moveaxis(C_int[:, -1, :], 0, -1)     # (B, 10)
        C_R = _bc_closure(system, C_near_t, m_t, k, d_eff, dr)
        C_R_l = d3.moveaxis(C_R, -1, 0)                    # (10, B)
        C_full = d3.concatenate(
            [C_int[:, :1], C_int, C_R_l[:, None]], dim=1)  # (10, M+2, B)

        um, uc, up = C_full[:, :-2], C_full[:, 1:-1], C_full[:, 2:]
        lap = ((up - uc) - (uc - um)) * inv_dr2
        if system.geometry is Geometry.SPHERICAL:
            lap = lap + (up - um) * inv_rdr[None, :, None]

        dC = d_eff.T[:, None, :] * lap + _bulk_rates(system, C_int, k)
        dm = _memb_rates(system, m_t, C_R, k)              # (B, 8)
        dC64 = d3.to_f64(dC)
        dm64 = d3.to_f64(dm)
        dm_pad = torch.cat([dm64.T, y.new_zeros((BLK - N_MEMB, B))], dim=0)
        return torch.cat([dC64.movedim(1, 0), dm_pad[None]], dim=0)

    return rhs, r
