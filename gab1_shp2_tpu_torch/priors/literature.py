"""Literature evidence tables and prior assembly.

Port of ``Julia/get_param_priors.jl``: each kinetic parameter's
literature values, uncertainties, weights, and error types feed the
Tsigkinopoulou protocol (``priors/protocol.py``) to produce lognormal
prior parameters; five (Kd, kon, koff) triples become correlated
bivariate lognormals.

Unit conversions follow the reference exactly (molar -> molecules/um^3
via Avogadro, per-second -> per-minute).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from gab1_shp2_tpu_torch.priors.diffusivity import estimate_diffusivities
from gab1_shp2_tpu_torch.priors.protocol import (
    MvLogNormal2,
    calc_mode_spread,
    multivariate3param,
)

# EGF concentration, uM (10 ng/mL; get_param_priors.jl:14)
EGF_UM = 1.67e-3

_AV = 6.022e23


def _evidence_tables() -> Dict[str, np.ndarray]:
    """name -> rows [value, error, weight, err_type]
    (get_param_priors.jl:19-186)."""
    t: Dict[str, List[Tuple[float, float, float, float]]] = {}

    # EGFR-GRB2 binding (get_param_priors.jl:22-29): SPR-style kon in
    # 1/(M*s) -> um^3/(molec*min); Kd in nM -> molec/um^3
    kG2f = 16.0 * 1e15 * 1e6 / _AV * 60.0
    KdG2 = 100.0 / 1e15 / 1e9 * _AV
    t["kG2f"] = [(kG2f, 1.1, 12.0, 1)]
    t["kG2r"] = [(480.0, 1.1, 12.0, 1)]
    t["KdG2"] = [(KdG2, 3.0, 12.0, 1)]

    # SHP2-pGAB1: same SH2-pY chemistry, lower weight (:34-39)
    t["kS2f"] = [(kG2f, 1.1, 10.0, 1)]
    t["kS2r"] = [(480.0, 1.1, 10.0, 1)]
    t["KdS2"] = [(KdG2, 3.0, 10.0, 1)]

    # GRB2/Src SH3 - proline-rich-domain binding (:44-68)
    f_cf = 1e15 / _AV * 60.0
    kG1f_v = np.array([2.3e3, 6.4e4, 9.5e4, 1.1e3, 7.8e3, 1.5e4, 1.3e3,
                       2.4e4, 0.9e3]) * f_cf
    kG1f_e = np.array([0.1e3, 0.1e4, 0.1e4, 7.0e3, 0.1e3, 0.2e4, 0.2e4,
                       0.3e4, 0.1e3]) * f_cf * math.sqrt(30.0)
    kG1f_w = np.array([12.0, 12, 12, 12, 10, 10, 10, 10, 10])
    kG1r_v = np.array([3.9e-2, 1.9e-3, 2.2e-3, 3.0e-3, 9.9e-4, 2.2e-3,
                       1.6e-3, 3.2e-3, 1.6e-3]) * 60.0
    kG1r_e = np.array([0.2e-2, 0.2e-3, 0.1e-3, 0.1e-3, 0.2e-4, 0.3e-3,
                       0.3e-3, 0.3e-3, 0.04e-3]) * 60.0 * math.sqrt(30.0)
    t["kG1f"] = list(zip(kG1f_v, kG1f_e, kG1f_w, [0.0] * 9))
    t["kG1r"] = list(zip(kG1r_v, kG1r_e, kG1f_w, [0.0] * 9))

    # Kd estimates per protein with correlated-mean error propagation
    # (get_param_priors.jl:57-60; the shared denominator's uncertainty
    # does not cancel across the averaged ratios)
    def kd_with_err(rv, re, fv, fe):
        mf, mr = fv.mean(), rv.mean()
        ef = math.sqrt((fe**2).sum()) / len(fv)
        n = len(rv)
        var = (re**2).sum() / (n**2 * mf**2) + (mr / mf**2) ** 2 * ef**2
        return mr / mf, math.sqrt(var)

    kd1 = kd_with_err(kG1r_v[:4], kG1r_e[:4], kG1f_v[:4], kG1f_e[:4])
    kd2 = kd_with_err(kG1r_v[4:], kG1r_e[4:], kG1f_v[4:], kG1f_e[4:])
    t["KdG1"] = [(kd1[0], kd1[1], 12.0, 0), (kd2[0], kd2[1], 10.0, 0)]

    # EGF-EGFR binding (:72-106)
    t["kEGFf"] = [(63.0, 19.0 * math.sqrt(3.0), 14.0, 0)]
    t["kEGFr"] = [(0.16, 0.05 * math.sqrt(3.0), 14.0, 0)]
    kdegf = 0.16 / 63.0
    kdegf_e = kdegf * math.sqrt((0.05 / 0.16) ** 2 + (19.0 / 63.0) ** 2)
    t["KdEGF"] = [(kdegf, kdegf_e, 14.0, 0)]

    # EGFR dimerization (:110-122)
    s_kdd = math.sqrt(100.0) * (1.9 - 0.068) / 3.92
    d_kdr = math.exp(math.sqrt(math.log(1.1) ** 2 + math.log(s_kdd) ** 2))
    t["kdf"] = [(1.2, 1.1, 14.0, 1)]
    t["Kdd"] = [(3.8e-1, s_kdd, 14.0, 1)]
    t["kdr"] = [(1.2 * 3.8e-1, d_kdr, 14.0, 1)]

    # EGFR phosphorylation (:127-137)
    kp_v = [14.4, 17.4, 7.2, 12.9, 13.1, 15.1]
    kp_e = [e * math.sqrt(4.0) for e in [0.5, 0.6, 0.3, 0.4, 0.4, 0.2]]
    t["kp"] = [(v, e, 12.0, 0) for v, e in zip(kp_v, kp_e)]

    # EGFR dephosphorylation (:142-157)
    s2 = math.sqrt(2.0)
    kdp_v = [8.0, 40.2, 52.8, 36.0, 127.2]
    kdp_e = [0.8, 2.76 * s2, 9.0 * s2, 14.0 * s2, 37.8 * s2]
    t["kdp"] = [(v, e, 10.0, 0) for v, e in zip(kdp_v, kdp_e)]

    # GAB1 (de)phosphorylation and SFK (in)activation (:162-173)
    t["kG1p"] = [(0.42, 10.0, 12.0, 1)]
    t["kG1dp"] = [(9.5, 10.0, 12.0, 1)]
    t["kSa"] = [(0.42, 10.0, 12.0, 1)]
    t["kSi"] = [(9.5, 10.0, 12.0, 1)]

    # diffusivities (:177-185)
    for name, (d, err) in estimate_diffusivities().items():
        t[name] = [(d, err, 12.0, 0)]

    return {k: np.array(v, dtype=float) for k, v in t.items()}


@dataclass(frozen=True)
class PriorSet:
    """Assembled priors: univariate lognormal (mu, sigma) per parameter
    name plus the five correlated binding-triple distributions
    (``get_param_priors.jl:270-271``)."""

    lognorm: Dict[str, Tuple[float, float]]   # all protocol outputs
    mv: Dict[str, MvLogNormal2]               # G2, G1, S2, EGF, dim

    UV_NAMES = ("kG1p", "kG1dp", "kSa", "kSi", "kp", "kdp",
                "Dsfk", "Dg2", "Dg2g1", "Dg2g1s2", "Dg1", "Dg1s2", "Ds2")

    def uv(self, name: str) -> Tuple[float, float]:
        return self.lognorm[name]

    def baseline_pvals(self) -> Dict[str, float]:
        """Baseline parameter values ("modes", exp(mu)):
        ``get_param_priors.jl:274-301``."""
        out = {n: math.exp(self.lognorm[n][0]) for n in self.UV_NAMES}
        for key, (fname, rname) in {
            "G2": ("kG2f", "kG2r"), "G1": ("kG1f", "kG1r"),
            "S2": ("kS2f", "kS2r"), "EGF": ("kEGFf", "kEGFr"),
            "dim": ("kdf", "kdr"),
        }.items():
            kf, kr = self.mv[key].modes()
            out[fname] = kf
            out[rname] = kr
        out["EGF"] = EGF_UM
        return out


@lru_cache(maxsize=1)
def build_priors() -> PriorSet:
    """Run the full protocol over the evidence tables."""
    tables = _evidence_tables()
    ln = {}
    for name, V in tables.items():
        mode, spread = calc_mode_spread(V)
        ln[name] = (math.log(mode), math.log(spread))

    def triple(kd, kf, kr):
        return multivariate3param(ln[kd][0], ln[kd][1], ln[kf][0],
                                  ln[kf][1], ln[kr][0], ln[kr][1])

    mv = {
        "G2": triple("KdG2", "kG2f", "kG2r"),
        "G1": triple("KdG1", "kG1f", "kG1r"),
        "S2": triple("KdS2", "kS2f", "kS2r"),
        "EGF": triple("KdEGF", "kEGFf", "kEGFr"),
        "dim": triple("Kdd", "kdf", "kdr"),
    }
    return PriorSet(lognorm=ln, mv=mv)
