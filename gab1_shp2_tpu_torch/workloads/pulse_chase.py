"""EGF-gefitinib pulse-chase driver (port of
``Julia/gefitinib_pulse_chase.jl``).

Counterpart of ``gab1_shp2_tpu/workloads/pulse_chase.py``: 5 min EGF
stimulation followed by a 2 min gefitinib chase (kp -> 0); ensemble
median pEGFR decay compared against the reaction-only ODE model trace
``pEGFR_pulsechase-res_dynamic.tsv``.

    python -m gab1_shp2_tpu_torch.workloads.pulse_chase [--cpu] ...
"""

from __future__ import annotations

import csv
import os

import numpy as np

import gab1_shp2_tpu_torch as g
from gab1_shp2_tpu_torch.ensemble.engine import masked_quantiles, run_ensemble
from gab1_shp2_tpu_torch.workloads import common
from gab1_shp2_tpu_torch.workloads.common import to_numpy

REFERENCE_TRACE = "/root/reference/Julia/pEGFR_pulsechase-res_dynamic.tsv"
# the same trace as committed beside the JAX package's full-scale run:
# the ode_ref column of results/pulse_chase/pulse_chase_vs_ode.csv
COMMITTED_TRACE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "results", "pulse_chase", "pulse_chase_vs_ode.csv")


def reference_trace():
    """The reaction-only ODE model's normalized pEGFR decay, on the
    t = 4.97:0.07:7 grid (``gefitinib_pulse_chase.jl:54-56``): the
    reference's file when present, else its committed copy (the
    ``ode_ref`` column of ``results/pulse_chase/pulse_chase_vs_ode.csv``);
    ``(None, None)`` when neither exists."""
    if os.path.exists(REFERENCE_TRACE):
        vals = np.loadtxt(REFERENCE_TRACE)
    elif os.path.exists(COMMITTED_TRACE):
        with open(COMMITTED_TRACE, newline="") as fh:
            vals = np.array([float(row["ode_ref"])
                             for row in csv.DictReader(fh)])
    else:
        return None, None
    t = 4.97 + 0.07 * np.arange(len(vals))
    return t, vals


def main(argv=None):
    ap = common.default_argparser(__doc__)
    ap.add_argument("--t-prechase", type=float, default=5.0)
    ap.add_argument("--t-chase", type=float, default=2.0)
    args = ap.parse_args(argv)
    args.nts = 120 if args.nts == 100 else args.nts  # reference Nts=120
    dev = common.device(args)
    out = args.outdir
    os.makedirs(out, exist_ok=True)

    system = g.base_system()
    Co = g.default_co(device=dev)
    tf = args.t_prechase + args.t_chase
    ens = common.get_ensemble(args.n, seed=args.seed)

    kw = dict(solver=args.solver, device=dev, dr=args.dr, tf=tf,
              Nts=args.nts, rtol=args.rtol, chunk=args.chunk,
              linsolve_dtype=common.linsolve_dtype(args),
              scheduler=common.scheduler(args),
              t_prechase=args.t_prechase)
    # one ensemble pass for both observables (extract returns a tuple;
    # the per-lane validity mask is shared)
    (pe, qg), ok = run_ensemble(
        system, Co, ens, extract=lambda s: (s.pE, s.PG1Stot), **kw)
    q = to_numpy(masked_quantiles(pe, ok))
    t = np.linspace(0, tf, args.nts + 1)

    # rotated-azimuth chase surface of cytosolic GAB1-SHP2
    # (gefitinib_pulse_chase.jl:215-253)
    qsurf = to_numpy(masked_quantiles(qg, ok))  # (3, Nts+1, Nr+1)
    chase = t >= args.t_prechase - 1e-9
    t_ch = t[chase] - args.t_prechase
    r_grid = np.arange(qsurf.shape[-1]) * args.dr
    common.save_rotated_chase_surface(
        f"{out}/pulse_chase_PG1S_surf_rotated.png", t_ch, r_grid,
        qsurf[1][chase],
        ci_tf=(qsurf[0][-1], qsurf[2][-1]),
        ci_rR=(qsurf[0][chase, -1], qsurf[2][chase, -1]),
        zlabel="GAB1-SHP2 (molec/um^3)",
        title="EGF-gefitinib pulse chase")
    common.save_csv(
        f"{out}/pulse_chase_PG1S_chase_surface.csv",
        ["t_chase"] + [f"r{ri:.1f}" for ri in r_grid],
        np.concatenate([t_ch[:, None], qsurf[1][chase]], axis=1).tolist())
    print(f"pulse-chase ensemble: {int(ok.sum())}/{len(ens)} ok")

    # normalize to the chase start, as the reference trace is (100 at
    # t~=5; gefitinib_pulse_chase.jl comparison convention)
    i5 = int(np.argmin(np.abs(t - args.t_prechase)))
    med = q[1]
    norm = med / med[i5] * 100.0

    ys = {"PDE ensemble median": norm}
    t_dyn, ref = reference_trace()
    if ref is not None:
        interp = np.interp(t_dyn, t, norm)
        rmse = float(np.sqrt(np.mean((interp - ref) ** 2)))
        print(f"RMSE vs reaction-only ODE trace: {rmse:.2f} "
              f"(percent points, trace normalized to 100)")
        common.save_csv(f"{out}/pulse_chase_vs_ode.csv",
                        ["t", "pde_norm", "ode_ref"],
                        np.stack([t_dyn, interp, ref], axis=1).tolist())
        ys["reaction-only ODE"] = np.interp(t, t_dyn, ref,
                                            left=np.nan, right=np.nan)
    common.save_line_plot(f"{out}/pulse_chase_pE.png", t, ys,
                          "t (min)", "pEGFR (% of chase start)",
                          "EGF pulse / gefitinib chase")


if __name__ == "__main__":
    main()
