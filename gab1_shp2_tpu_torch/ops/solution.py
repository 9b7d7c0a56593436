"""Solution container with named species access and derived outputs
(counterpart of ``gab1_shp2_tpu/ops/solution.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gab1_shp2_tpu_torch.models.species import CYTO, MEMB
from gab1_shp2_tpu_torch.ops.rhs import etot


class Solution(NamedTuple):
    """Trajectory of one PDE solve.

    ``C``: (Nts+1, 10, Nr+1) bulk profiles (time, species, node);
    ``m``: (Nts+1, 8) membrane states; ``t``: (Nts+1,) save times;
    ``r``: (Nr+1,) radial grid; ``CoEGFR``: scalar total EGFR.  Leading
    batch dimensions appear for ensemble solves; all accessors broadcast
    over them (``basepdesolver.jl:303-311``, time leading).
    """

    C: torch.Tensor
    m: torch.Tensor
    t: torch.Tensor
    r: torch.Tensor
    CoEGFR: torch.Tensor

    def cyto(self, name: str) -> torch.Tensor:
        """Bulk species trajectory, shape (..., Nts+1, Nr+1)."""
        return self.C[..., CYTO[name], :]

    def memb(self, name: str) -> torch.Tensor:
        """Membrane species trajectory, shape (..., Nts+1)."""
        return self.m[..., MEMB[name]]

    # --- derived outputs (basepdesolver.jl:287,298-300) -------------------
    @property
    def PG1Stot(self) -> torch.Tensor:
        """Total GAB1-SHP2 complexes: PG1S + G2PG1S."""
        return self.cyto("PG1S") + self.cyto("G2PG1S")

    @property
    def PG1tot(self) -> torch.Tensor:
        """Total phosphorylated GAB1: pGAB1 + G2PG1 + PG1Stot."""
        return self.cyto("pGAB1") + self.cyto("G2PG1") + self.PG1Stot

    @property
    def pE(self) -> torch.Tensor:
        """Percent phosphorylated EGFR: Etot*100/CoEGFR."""
        return etot(self.m) * 100.0 / self.CoEGFR[..., None]

    @property
    def EGFR_SHP2(self) -> torch.Tensor:
        """Percent EGFR with SHP2 bound: EG2PG1S*100/CoEGFR."""
        return self.memb("EG2PG1S") * 100.0 / self.CoEGFR[..., None]
