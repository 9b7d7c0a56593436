"""Length-scale analysis in a large cell (port of
``Julia/length_scale_estimates.jl``).

Counterpart of ``gab1_shp2_tpu/workloads/length_scales.py``: R = 100 um,
perturbations of {Dsfk, Dg1, Dg1s2, kSi, kG1dp, kS2r} by x{0.1, 1, 10};
measured r_1/2 / r_1/10 penetration depths compared with the
order-of-magnitude estimate delta = sqrt(D/k)
(``length_scale_estimates.jl:77-122``).

    python -m gab1_shp2_tpu_torch.workloads.length_scales [--cpu] ...
"""

from __future__ import annotations

import math

import numpy as np

import gab1_shp2_tpu_torch as g
from gab1_shp2_tpu_torch.ensemble.engine import run_ensemble
from gab1_shp2_tpu_torch.models.observables import gsa_outputs
from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.workloads import common
from gab1_shp2_tpu_torch.workloads.common import to_numpy
from gab1_shp2_tpu_torch.workloads.run_base_model import _stack

R_BIG = 100.0
PERTURB = ("Dsfk", "Dg1", "Dg1s2", "kSi", "kG1dp", "kS2r")
FACTORS = (0.1, 1.0, 10.0)


def delta_estimates(p: Params) -> dict:
    """delta = sqrt(D/k) length-scale estimates
    (``length_scale_estimates.jl:112-122``): aSFK from (Dsfk, kSi);
    GAB1-SHP2 as the sum of the pGAB1 and complex contributions."""
    d_sfk = math.sqrt(float(p.Dsfk / p.kSi))
    d_pg1 = math.sqrt(float(p.Dg1 / p.kG1dp))
    d_pg1s = math.sqrt(float(p.Dg1s2 / p.kS2r))
    return {"aSFK": d_sfk, "PG1S": d_pg1 + d_pg1s}


def main(argv=None):
    ap = common.default_argparser(__doc__)
    ap.set_defaults(dr=1.0, nts=2, tf=5.0)
    args = ap.parse_args(argv)
    dev = common.device(args)
    system = g.base_system()
    Co = g.default_co(R=R_BIG, device=dev)

    base = g.default_params(device=dev)
    rows = []
    for pname in PERTURB:
        batch = _stack([base.scale(**{pname: f}) for f in FACTORS])
        out, ok = run_ensemble(
            system, Co, batch, solver=args.solver, device=dev, R=R_BIG,
            dr=args.dr, tf=args.tf, Nts=args.nts, rtol=args.rtol,
            linsolve_dtype=common.linsolve_dtype(args),
            scheduler=common.scheduler(args),
            extract=lambda s: gsa_outputs(s, R_BIG))
        for f, o, valid in zip(FACTORS, to_numpy(out), to_numpy(ok)):
            p_f = base.scale(**{pname: f})
            d = delta_estimates(p_f)
            rows.append([pname, f, *(o if valid else [np.nan] * 6),
                         d["aSFK"], d["PG1S"]])
            if valid:
                print(f"{pname} x{f:g}: r1/2(aSFK)={o[0]:.1f} um "
                      f"(delta={d['aSFK']:.1f}), "
                      f"r1/2(PG1S)={o[2]:.1f} (delta~{d['PG1S']:.1f})")
    common.save_csv(
        f"{args.outdir}/length_scales_R100.csv",
        ["param", "factor", "r12_sfk", "r110_sfk", "r12_pg1s",
         "r110_pg1s", "cs_ratio", "pg1s_ave", "delta_sfk", "delta_pg1s"],
        rows)


if __name__ == "__main__":
    main()
