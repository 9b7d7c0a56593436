"""Scalar observables extracted from PDE solutions (counterpart of
``gab1_shp2_tpu/models/observables.py``).

  * ``pct_shp2_bound_gab1`` — the single fit datum observable
    (``param_fitting+inference_finitediff.jl:210-217``),
  * ``gsa_outputs`` — the 6-scalar eFAST output map
    (``sapdesolver.jl:306-318``),
  * ``length_scale`` — r_1/2 and r_1/10 penetration depths.

All three broadcast over leading batch axes and trace under
``torch.func.vmap``.
"""

from __future__ import annotations

import torch

from gab1_shp2_tpu_torch.ops.solution import Solution, spatial_average


def pct_shp2_bound_gab1(sol: Solution, Co: torch.Tensor,
                        R: float) -> torch.Tensor:
    """Percent SHP2-bound GAB1 at the final time.

    Cytoplasmic GAB1-SHP2 (PG1S + G2PG1S) is volume-averaged; membrane
    EG2PG1S is converted to volume units with the surface/volume ratio
    ``sa/vol = 3/R`` (``param_fitting+inference_finitediff.jl:210-216``).
    """
    pg1s_cyt = sol.cyto("PG1S")[..., -1, :] + sol.cyto("G2PG1S")[..., -1, :]
    cyt_ave = spatial_average(pg1s_cyt, sol.r, R)
    memb = sol.memb("EG2PG1S")[..., -1] * 3.0 / R
    return (cyt_ave + memb) / Co[..., 2] * 100.0


def length_scale(profile: torch.Tensor, r: torch.Tensor, R: float,
                 frac: float) -> torch.Tensor:
    """Penetration depth ``R - min{r : C(r) >= frac*max(C)}``
    (``sapdesolver.jl:306-309``): the distance from the membrane to the
    innermost node where the profile still exceeds ``frac`` of its max.
    ``profile``'s trailing axis is the node axis."""
    thresh = frac * torch.amax(profile, dim=-1, keepdim=True)
    above = profile >= thresh
    big = (r[..., -1:] * 2).to(profile.dtype)
    rmin = torch.amin(torch.where(above, r.to(profile.dtype), big), dim=-1)
    return R - rmin


def gsa_outputs(sol: Solution, R: float) -> torch.Tensor:
    """The 6-scalar GSA output map (``sapdesolver.jl:306-318``):

    ``[r1/2 aSFK, r1/10 aSFK, r1/2 PG1Stot, r1/10 PG1Stot,
       center/surface PG1Stot ratio, volume-avg PG1Stot]`` at tf.
    """
    asfk = sol.cyto("aSFK")[..., -1, :]
    pg1s = sol.PG1Stot[..., -1, :]
    return torch.stack(
        [
            length_scale(asfk, sol.r, R, 0.5),
            length_scale(asfk, sol.r, R, 0.1),
            length_scale(pg1s, sol.r, R, 0.5),
            length_scale(pg1s, sol.r, R, 0.1),
            pg1s[..., 0] / pg1s[..., -1],
            spatial_average(pg1s, sol.r, R),
        ],
        dim=-1,
    )
