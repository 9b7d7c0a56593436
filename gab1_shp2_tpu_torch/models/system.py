"""Declarative reaction-diffusion system definition.

One data-driven definition of the GAB1-SHP2/EGFR network replaces the
reference's seven hand-unrolled solver clones (``Julia/basepdesolver.jl``,
``basepdesolver_rect.jl``, ``pulsechase_solver.jl``, ``sapdesolver*.jl``):
variants become configuration —

  * geometry: ``Geometry.SPHERICAL`` vs ``Geometry.RECT``
    (``basepdesolver_rect.jl:132`` drops the 2/r metric term),
  * membrane-confined SFKs: ``memb_sfk=True`` pins the active-SFK
    diffusivity to 1e-32 (``basepdesolver.jl:366,530``),
  * gefitinib pulse-chase: a time event zeroing ``kp``
    (``pulsechase_solver.jl:156-158``) handled by the steppers.

The network is expressed as mass-action reactions over named species;
``gab1_shp2_tpu_torch.ops.rhs`` evaluates these tables as eager torch
expressions, and ``gab1_shp2_tpu_torch.ops.ros23_cuda`` generates the
CUDA kernel's rate functions from the same tables.  This module is a
copy of ``gab1_shp2_tpu/models/system.py``; the tests hold the two equal.

Bulk reactions, membrane reactions, and surface (Robin-flux) couplings
mirror ``basepdesolver.jl:151-231``; see that file for the reference
equations these tables reproduce.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from gab1_shp2_tpu_torch.models.species import CYTO, MEMB

# aSFK diffusivity in the membrane-confined-SFK variant
# (``basepdesolver.jl:366``).
D_ASFK_MEMB = 1e-32


class Geometry(enum.Enum):
    SPHERICAL = "spherical"
    RECT = "rect"


@dataclasses.dataclass(frozen=True)
class Reaction:
    """Mass-action reaction among bulk species (or membrane species).

    ``rate_f = kf * prod(conc[reactants]) * prod(conc[catalysts])`` and, if
    ``kr`` is given, ``rate_r = kr * prod(conc[products])``.  ``stoich``
    multiplies the net rate's contribution to every participant (used for
    the EGFR dimerization 2 mES <-> mESmES where d[mES]/dt carries a
    factor 2, ``basepdesolver.jl:221``).
    """

    reactants: Tuple[str, ...]
    products: Tuple[str, ...]
    kf: str
    kr: Optional[str] = None
    catalysts: Tuple[str, ...] = ()
    # per-species stoichiometric multiplicity for reactants/products
    reactant_stoich: Tuple[int, ...] = ()
    product_stoich: Tuple[int, ...] = ()
    # multiply forward rate by this named parameter (e.g. EGF concentration)
    rate_scale: Optional[str] = None

    def r_stoich(self) -> Tuple[int, ...]:
        return self.reactant_stoich or tuple(1 for _ in self.reactants)

    def p_stoich(self) -> Tuple[int, ...]:
        return self.product_stoich or tuple(1 for _ in self.products)


@dataclasses.dataclass(frozen=True)
class SurfaceBinding:
    """Reversible binding of a bulk species to a membrane species.

    cyto + memb <-> product(memb), generating (a) a Robin flux on the bulk
    species at r = R and (b) source/sink terms in the membrane ODEs
    (``basepdesolver.jl:197-231``).
    """

    cyto: str
    memb: str
    product: str
    kf: str
    kr: str


# --- Bulk (cytosolic) reactions: basepdesolver.jl:151-180 -----------------
BULK_REACTIONS: Tuple[Reaction, ...] = (
    Reaction(("GRB2", "GAB1"), ("G2G1",), "kG1f", "kG1r"),
    Reaction(("GRB2", "pGAB1"), ("G2PG1",), "kG1f", "kG1r"),
    Reaction(("GRB2", "PG1S"), ("G2PG1S",), "kG1f", "kG1r"),
    Reaction(("SHP2", "pGAB1"), ("PG1S",), "kS2f", "kS2r"),
    Reaction(("SHP2", "G2PG1"), ("G2PG1S",), "kS2f", "kS2r"),
    Reaction(("GAB1",), ("pGAB1",), "kG1p", "kG1dp", catalysts=("aSFK",)),
    Reaction(("G2G1",), ("G2PG1",), "kG1p", "kG1dp", catalysts=("aSFK",)),
    Reaction(("aSFK",), ("iSFK",), "kSi"),
)

# --- Membrane-only reactions: basepdesolver.jl:220-222 --------------------
MEMB_REACTIONS: Tuple[Reaction, ...] = (
    Reaction(("mE",), ("mES",), "kEGFf", "kEGFr", rate_scale="EGF"),
    Reaction(("mES",), ("mESmES",), "kdf", "kdr",
             reactant_stoich=(2,), product_stoich=(1,)),
    Reaction(("mESmES",), ("E",), "kp", "kdp"),
)

# --- Surface couplings (Robin BC + membrane source terms):
#     basepdesolver.jl:197-231 -------------------------------------------
SURFACE_BINDINGS: Tuple[SurfaceBinding, ...] = (
    SurfaceBinding("GRB2", "E", "EG2", "kG2f", "kG2r"),
    SurfaceBinding("G2G1", "E", "EG2G1", "kG2f", "kG2r"),
    SurfaceBinding("G2PG1", "E", "EG2PG1", "kG2f", "kG2r"),
    SurfaceBinding("G2PG1S", "E", "EG2PG1S", "kG2f", "kG2r"),
    SurfaceBinding("GAB1", "EG2", "EG2G1", "kG1f", "kG1r"),
    SurfaceBinding("pGAB1", "EG2", "EG2PG1", "kG1f", "kG1r"),
    SurfaceBinding("PG1S", "EG2", "EG2PG1S", "kG1f", "kG1r"),
    SurfaceBinding("SHP2", "EG2PG1", "EG2PG1S", "kS2f", "kS2r"),
)

# Membrane species contributing to the active-EGFR total
# Etot = 2*(E + EG2 + EG2G1 + EG2PG1 + EG2PG1S) (basepdesolver.jl:205);
# Etot drives SFK activation at the surface: iSFK -> aSFK with rate
# kSa * Etot * iSFK|_R (basepdesolver.jl:206-207).
ETOT_MEMBERS: Tuple[str, ...] = ("E", "EG2", "EG2G1", "EG2PG1", "EG2PG1S")
ETOT_SCALE = 2.0


@dataclasses.dataclass(frozen=True, eq=True)
class ReactionDiffusionSystem:
    """Static configuration for one model variant.

    Hashable and compared by value, so it can key the cache of built
    kernel libraries.
    """

    geometry: Geometry = Geometry.SPHERICAL
    memb_sfk: bool = False
    name: str = "base"

    bulk_reactions: Tuple[Reaction, ...] = BULK_REACTIONS
    memb_reactions: Tuple[Reaction, ...] = MEMB_REACTIONS
    surface_bindings: Tuple[SurfaceBinding, ...] = SURFACE_BINDINGS

    def __post_init__(self):
        for rx in self.bulk_reactions:
            for s in rx.reactants + rx.products + rx.catalysts:
                assert s in CYTO, s
        for rx in self.memb_reactions:
            for s in rx.reactants + rx.products + rx.catalysts:
                assert s in MEMB, s
        for sb in self.surface_bindings:
            assert sb.cyto in CYTO and sb.memb in MEMB and sb.product in MEMB


def base_system() -> ReactionDiffusionSystem:
    """The base spherical model (``basepdesolver.jl:25``)."""
    return ReactionDiffusionSystem()


def rect_system() -> ReactionDiffusionSystem:
    """Rectangular (Cartesian 1-D) geometry (``basepdesolver_rect.jl:23``)."""
    return ReactionDiffusionSystem(geometry=Geometry.RECT, name="rect")


def memb_sfk_system(geometry: Geometry = Geometry.SPHERICAL) -> ReactionDiffusionSystem:
    """Membrane-confined active SFKs (``basepdesolver.jl:350``)."""
    return ReactionDiffusionSystem(geometry=geometry, memb_sfk=True,
                                   name="memb_sfk")
