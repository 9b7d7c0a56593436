"""Ensemble reaction-rate quantiles (port of ``Julia/calc_rxn_rates.jl``).

Counterpart of ``gab1_shp2_tpu/workloads/calc_rxn_rates.py``: N-member
ensemble at dr=0.25, tol 1e-2; prints the 2.5/25/50/75/97.5% quantiles
of the space/time-averaged SFK and GAB1 (de)phosphorylation rates in
uM/min (``calc_rxn_rates.jl:160-206``).

    python -m gab1_shp2_tpu_torch.workloads.calc_rxn_rates [--cpu] ...
"""

from __future__ import annotations

import numpy as np
import torch

import gab1_shp2_tpu_torch as g
from gab1_shp2_tpu_torch.ensemble.engine import run_ensemble
from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.models.rates import (
    MOLEC_TO_UM,
    reaction_rate_summaries,
)
from gab1_shp2_tpu_torch.ops.solution import Solution
from gab1_shp2_tpu_torch.workloads import common
from gab1_shp2_tpu_torch.workloads.common import to_numpy

QS = (0.025, 0.25, 0.5, 0.75, 0.975)


def main(argv=None):
    ap = common.default_argparser(__doc__)
    ap.set_defaults(dr=0.25)
    args = ap.parse_args(argv)
    dev = common.device(args)
    system = g.base_system()
    Co = g.default_co(device=dev)
    ens = common.get_ensemble(args.n, seed=args.seed)

    # rates need the full trajectory: keep whole Solutions
    out, ok = run_ensemble(
        system, Co, ens, solver=args.solver, device=dev, dr=args.dr,
        tf=args.tf, Nts=args.nts, rtol=args.rtol, chunk=args.chunk,
        linsolve_dtype=common.linsolve_dtype(args),
        scheduler=common.scheduler(args),
        extract=lambda s: s)
    ok = to_numpy(ok)
    # one member at a time (the JAX package vmaps): the time derivative
    # reads each member's save spacing as a number
    pb = Params.unpack(torch.as_tensor(ens, device=dev))
    per_member = [
        reaction_rate_summaries(Solution(*(x[i] for x in out)),
                                Params(D=pb.D[i], k=pb.k[i]), Co)
        for i in range(len(ens))]
    rates = {k: torch.stack([m[k] for m in per_member])
             for k in per_member[0]}

    print(f"rates over {int(ok.sum())}/{len(ens)} valid members "
          f"(quantiles {QS}):")
    rows = []
    for key, label, conv in (
        ("v_sfk_a", "time-avg SFK activation rate (uM/min)", MOLEC_TO_UM),
        ("v_sfk_i", "time-avg SFK inactivation rate (uM/min)", MOLEC_TO_UM),
        ("v_sfk_net", "net SFK activation rate (uM/min)", 1.0),
        ("v_g1_p", "time-avg GAB1 phos. rate (uM/min)", MOLEC_TO_UM),
        ("v_pg1_dp", "time-avg pGAB1 dephos. rate (uM/min)", MOLEC_TO_UM),
        ("v_pg1_net", "net GAB1 phos. rate (uM/min)", 1.0),
    ):
        v = to_numpy(rates[key])[ok] * conv
        q = np.quantile(v, QS)
        print(f"  {label}: " + " ".join(f"{x:.3g}" for x in q))
        rows.append([key] + list(q))
    common.save_csv(f"{args.outdir}/rxn_rate_quantiles.csv",
                    ["rate"] + [f"q{q}" for q in QS], rows)


if __name__ == "__main__":
    main()
