"""Space/time-averaged reaction-rate summaries (counterpart of
``gab1_shp2_tpu/models/rates.py``; ``Julia/calc_rxn_rates.jl:106-155``):
per-member averages of SFK activation/inactivation and GAB1
(de)phosphorylation rates in molecules/um^3/min (multiply by
``MOLEC_TO_UM`` for uM/min).
"""

from __future__ import annotations

from typing import Dict

import torch

from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.ops.solution import Solution, spatial_average

# molecules/um^3 -> uM (calc_rxn_rates.jl:165 etc.)
MOLEC_TO_UM = 1e15 / 6.022e23 * 1e6


def _time_average(y: torch.Tensor, t: torch.Tensor, tf) -> torch.Tensor:
    return torch.trapezoid(y, t, dim=-1) / tf


def _ddt(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """d/dt on the uniform save grid: central differences inside,
    one-sided first-order differences at both ends (the edge order of
    ``jnp.gradient``)."""
    return torch.gradient(y, spacing=float(t[1] - t[0]), dim=-1,
                          edge_order=1)[0]


def reaction_rate_summaries(sol: Solution, params: Params, Co: torch.Tensor,
                            R: float = 10.0) -> Dict[str, torch.Tensor]:
    """The six rate summaries of ``calc_rxn_rates.jl`` for one solve:

    * ``v_sfk_i``  — inactivation kSi*<aSFK>, space+time averaged
    * ``v_sfk_a``  — activation kSa*Etot*iSFK (the reference's
      ``iSFK[1,:]``, the center node; ``calc_rxn_rates.jl:126``)
    * ``v_sfk_net``— time-averaged d<aSFK>/dt
    * ``v_g1_p``   — phosphorylation kG1p*<aSFK*(GAB1+G2G1)>
    * ``v_pg1_dp`` — dephosphorylation kG1dp*<PG1tot>
    * ``v_pg1_net``— time-averaged d<PG1tot incl. membrane>/dt
    """
    t = sol.t
    tf = t[-1]
    r = sol.r

    asfk_ave = spatial_average(sol.cyto("aSFK"), r, R)  # (T,)
    v_sfk_i = _time_average(params.kSi * asfk_ave, t, tf)

    etot = sol.pE / (100.0 / Co[..., 4])
    v_sfk_a = _time_average(params.kSa * etot * sol.cyto("iSFK")[..., 0],
                            t, tf)

    v_sfk_net = _time_average(_ddt(asfk_ave, t), t, tf)

    g1_cyt = sol.cyto("GAB1") + sol.cyto("G2G1")
    v_g1_p = _time_average(
        params.kG1p * spatial_average(sol.cyto("aSFK") * g1_cyt, r, R),
        t, tf)

    pg1_cyt = spatial_average(sol.PG1tot, r, R)
    v_pg1_dp = _time_average(params.kG1dp * pg1_cyt, t, tf)

    pg1_tot = pg1_cyt + (sol.memb("EG2PG1") + sol.memb("EG2PG1S")) * 3.0 / R
    v_pg1_net = _time_average(_ddt(pg1_tot, t), t, tf)

    return {"v_sfk_a": v_sfk_a, "v_sfk_i": v_sfk_i, "v_sfk_net": v_sfk_net,
            "v_g1_p": v_g1_p, "v_pg1_dp": v_pg1_dp, "v_pg1_net": v_pg1_net}
