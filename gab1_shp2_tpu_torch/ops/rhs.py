"""Eager torch evaluation of the declarative reaction system.

Counterpart of the lane parts of ``gab1_shp2_tpu/ops/rhs.py``:

  * ``bulk_rates``  — mass-action net rates for the 10 bulk species,
                      vectorized over any trailing (node, lane) axes,
  * ``memb_rates``  — the 8 membrane ODE right-hand sides,
  * ``bc_closure``  — the Robin (reactive-flux) boundary values of the
                      bulk species at r = R by ghost-node elimination
                      (``basepdesolver.jl:197-215``).

The loops over the reaction tables run in Python on every call; each term
is one small tensor op.  All functions are written without in-place
updates so that ``torch.func.jvp``/``vmap`` can trace them (the Jacobian
bands in ``ops/jacobian.py`` differentiate them).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.models.species import (
    CYTO,
    DIFF_SLOT_OF_CYTO,
    K_NAMES,
    MEMB,
    N_CYTO,
    N_MEMB,
)
from gab1_shp2_tpu_torch.models.system import (
    D_ASFK_MEMB,
    ETOT_MEMBERS,
    ETOT_SCALE,
    ReactionDiffusionSystem,
)

_K_IDX = {n: i for i, n in enumerate(K_NAMES)}
_ETOT_IDX = tuple(MEMB[s] for s in ETOT_MEMBERS)


def kdict(k: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split the packed kinetic vector into named scalars (or (B,) rows)."""
    return {name: k[..., i] for name, i in _K_IDX.items()}


def effective_diffusivities(system: ReactionDiffusionSystem,
                            params: Params) -> torch.Tensor:
    """Per-bulk-species diffusivities (..., 10), from the 7-slot D vector.

    The membrane-confined-SFK variant pins aSFK's diffusivity to 1e-32
    (``basepdesolver.jl:366``).
    """
    D = params.D
    cols = [D[..., s] for s in DIFF_SLOT_OF_CYTO]
    if system.memb_sfk:
        cols[CYTO["aSFK"]] = torch.full_like(cols[0], D_ASFK_MEMB)
    return torch.stack(cols, dim=-1)


def _net_reaction_terms(reactions, conc, k: Dict[str, torch.Tensor], out):
    """Accumulate mass-action net-rate contributions into ``out``
    (same expression order as the JAX package's lowering)."""
    for rx in reactions:
        rf = k[rx.kf]
        if rx.rate_scale is not None:
            rf = rf * k[rx.rate_scale]
        for s, st in zip(rx.reactants, rx.r_stoich()):
            c = conc(s)
            rf = rf * (c if st == 1 else c**st)
        for s in rx.catalysts:
            rf = rf * conc(s)
        net = rf
        if rx.kr is not None:
            rr = k[rx.kr]
            for s, st in zip(rx.products, rx.p_stoich()):
                c = conc(s)
                rr = rr * (c if st == 1 else c**st)
            net = rf - rr
        for s, st in zip(rx.reactants, rx.r_stoich()):
            out[s] = out[s] - st * net
        for s, st in zip(rx.products, rx.p_stoich()):
            out[s] = out[s] + st * net
    return out


def bulk_rates(system: ReactionDiffusionSystem, C: torch.Tensor,
               k: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Net mass-action rates for the bulk species; ``C`` is (10, ...)."""
    zero = torch.zeros_like(C[0])
    out = {name: zero for name in CYTO}
    out = _net_reaction_terms(system.bulk_reactions,
                              lambda s: C[CYTO[s]], k, out)
    return torch.stack([out[name] for name in CYTO])


def memb_rates(system: ReactionDiffusionSystem, m: torch.Tensor,
               C_R: torch.Tensor, k: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Membrane ODE right-hand sides (..., 8), species-last.

    ``m`` is the membrane state (..., 8); ``C_R`` the bulk
    concentrations at r = R (..., 10) (``basepdesolver.jl:220-231``).
    """
    zero = torch.zeros_like(m[..., 0])
    out = {name: zero for name in MEMB}
    out = _net_reaction_terms(system.memb_reactions,
                              lambda s: m[..., MEMB[s]], k, out)
    for sb in system.surface_bindings:
        net = (k[sb.kf] * C_R[..., CYTO[sb.cyto]] * m[..., MEMB[sb.memb]]
               - k[sb.kr] * m[..., MEMB[sb.product]])
        out[sb.memb] = out[sb.memb] - net
        out[sb.product] = out[sb.product] + net
    return torch.stack([out[name] for name in MEMB], dim=-1)


def etot(m: torch.Tensor) -> torch.Tensor:
    """Total signaling-competent EGFR ``2*(E + EG2 + EG2G1 + EG2PG1 +
    EG2PG1S)`` (``basepdesolver.jl:205``)."""
    return ETOT_SCALE * sum(m[..., i] for i in _ETOT_IDX)


def bc_closure(system: ReactionDiffusionSystem, C_near: torch.Tensor,
               m: torch.Tensor, k: Dict[str, torch.Tensor],
               d_eff: torch.Tensor, dr) -> torch.Tensor:
    """Bulk-species boundary values at r = R by ghost-node elimination.

    ``u_R = (u_near + gain*dr/D) / (1 + loss*dr/D)`` per species
    (``basepdesolver.jl:206-215``); the aSFK gain uses the just-eliminated
    iSFK_R (``basepdesolver.jl:206-207``).  The expression order is the
    JAX package's: with memb_sfk, ``dr/d_eff`` is ~2e31 in f32, and the
    order decides whether the aSFK value overflows.
    """
    zero = torch.zeros_like(C_near[..., 0])
    gains = [zero] * N_CYTO
    losses = [zero] * N_CYTO
    for sb in system.surface_bindings:
        ci = CYTO[sb.cyto]
        gains[ci] = gains[ci] + k[sb.kr] * m[..., MEMB[sb.product]]
        losses[ci] = losses[ci] + k[sb.kf] * m[..., MEMB[sb.memb]]
    Et = etot(m)
    losses[CYTO["iSFK"]] = losses[CYTO["iSFK"]] + k["kSa"] * Et

    g = torch.stack(gains, dim=-1)
    l = torch.stack(losses, dim=-1)
    C_R = (C_near + g * dr / d_eff) / (1.0 + l * dr / d_eff)
    a = CYTO["aSFK"]
    asfk_R = (C_near[..., a]
              + k["kSa"] * C_R[..., CYTO["iSFK"]] * Et * dr / d_eff[..., a])
    return torch.cat([C_R[..., :a], asfk_R[..., None], C_R[..., a + 1:]],
                     dim=-1)


class MolState(NamedTuple):
    """Method-of-lines state: interior bulk nodes ``C_int`` (10, Nr-1)
    and membrane species ``m`` (8,)."""

    C_int: torch.Tensor
    m: torch.Tensor


def initial_state(Co: torch.Tensor, Nr: int) -> MolState:
    """Initial condition (``basepdesolver.jl:94-97,137-141``): uniform
    iSFK/GRB2/GAB1/SHP2 at their total concentrations, EGFR as mE."""
    C = torch.zeros((N_CYTO, Nr - 1), dtype=Co.dtype, device=Co.device)
    for name, i in (("iSFK", 0), ("GRB2", 1), ("GAB1", 2), ("SHP2", 3)):
        C[CYTO[name]] = Co[i]
    m = torch.zeros((N_MEMB,), dtype=Co.dtype, device=Co.device)
    m[MEMB["mE"]] = Co[4]
    return MolState(C_int=C, m=m)
