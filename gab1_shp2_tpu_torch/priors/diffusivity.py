"""Protein diffusivity estimation from Stokes radii.

Port of ``Julia/diffusivity_calculations.jl``: molecular weights are
mapped to Stokes radii by linear interpolation through the Erickson 2009
protein standards, and diffusivities scale as D_tubulin * Rs_tub / Rs
from the Rh-tubulin measurement of Pepperkok et al. (tubulin's
measurement uncertainty propagates multiplicatively to every species).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

# cm^2/s -> um^2/min (diffusivity_calculations.jl:12)
DIFF_CF = (1e6 / 100.0) ** 2 * 60.0

# Rh-tubulin diffusivity, mean of two measurements with propagated error
# (diffusivity_calculations.jl:15-16)
_TUB_VALS = np.array([1.61e-8, 1.34e-8])
_TUB_ERRS = np.array([0.10e-8, 0.12e-8])
D_RHTUB = float(_TUB_VALS.mean() * DIFF_CF)
D_RHTUB_ERR = float(math.sqrt((_TUB_ERRS**2).sum()) / 2.0 * DIFF_CF)
M_RHTUB = 50000.0

# Erickson 2009 standards (diffusivity_calculations.jl:20-21)
MW_STD = np.array([14044.0, 25665.0, 42910.0, 69322.0, 157368.0,
                   239656.0, 489324.0, 606444.0])
RS_STD = np.array([1.64, 2.09, 3.05, 3.55, 4.81, 5.20, 6.10, 8.50])

# model species molecular weights (diffusivity_calculations.jl:45-47)
_MI = {"SFK": 59835.0, "GRB2": 25206.0, "GAB1": 115000.0, "SHP2": 68436.0}
SPECIES_MW = {
    "Dsfk": _MI["SFK"],
    "Dg2": _MI["GRB2"],
    "Dg1": _MI["GAB1"],
    "Ds2": _MI["SHP2"],
    "Dg2g1": _MI["GRB2"] + _MI["GAB1"],
    "Dg1s2": _MI["GAB1"] + _MI["SHP2"],
    "Dg2g1s2": _MI["GRB2"] + _MI["GAB1"] + _MI["SHP2"],
}


def stokes_radius(mw) -> np.ndarray:
    """Linear interpolation MW -> Stokes radius (nm) through the
    standards (the reference uses an order-1 spline,
    ``diffusivity_calculations.jl:37-38``; all model species fall inside
    the standard range so no extrapolation occurs)."""
    return np.interp(mw, MW_STD, RS_STD)


def estimate_diffusivities() -> Dict[str, Tuple[float, float]]:
    """Per-species (D, error) in um^2/min, with both the value and the
    propagated uncertainty rounded to integers as in the reference's
    output table (``diffusivity_calculations.jl:91`` applies
    ``round`` to the Measurement, which rounds value and error; the
    per-species scatter of the shipped ensemble's diffusivity sigmas
    confirms the rounded errors entered the priors)."""
    rs_tub = float(stokes_radius(M_RHTUB))
    rel_err = D_RHTUB_ERR / D_RHTUB
    out = {}
    for name, mw in SPECIES_MW.items():
        d = D_RHTUB * rs_tub / float(stokes_radius(mw))
        out[name] = (float(round(d)), float(round(rel_err * d)))
    return out
