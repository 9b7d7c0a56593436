"""eFAST / Sobol GSA drivers (ports of
``Julia/GSA_diffs+kinetic-params_MoL.jl``,
``GSA_diff+kinetic-params_memb-SFK_MoL.jl`` and ``GSA_concs.jl``).

Counterpart of ``gab1_shp2_tpu/workloads/gsa_driver.py``.  Writes S1/ST
CSVs in the reference's layout (one row per parameter, one column per
output variable).

    python -m gab1_shp2_tpu_torch.workloads.gsa_driver [--cpu] ...
"""

from __future__ import annotations

import numpy as np
import torch

import gab1_shp2_tpu_torch as g
from gab1_shp2_tpu_torch.gsa.runner import (
    GSA_VAR_NAMES,
    conc_bounds,
    dk_bounds,
    make_conc_evaluator,
    make_param_evaluator,
    run_efast,
    run_sobol,
)
from gab1_shp2_tpu_torch.models.species import CO_NAMES, PNAMES
from gab1_shp2_tpu_torch.workloads import common


def main(argv=None):
    ap = common.default_argparser(__doc__)
    ap.add_argument("--target",
                    choices=("dk", "dk_membsfk", "concs", "concs_membsfk"),
                    default="dk")
    ap.add_argument("--samples", type=int, default=1000,
                    help="eFAST samples per parameter (reference: 1000)")
    ap.add_argument("--method", choices=("efast", "sobol"),
                    default="efast")
    ap.add_argument("--resamples", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=2500)
    ap.add_argument("--f32", action="store_true",
                    help="float32 solves: fast, but the x1000-bounds "
                         "corners hit the f32 error floor and zero out "
                         "-- f64 with f32 linear algebra is the default")
    ap.add_argument("--full-f64-linsolve", action="store_true",
                    help="factor/solve W in float64 too (outputs agree "
                         "with the default recipe to p99 rel 1e-4 in the "
                         "JAX package's validation)")
    ap.add_argument("--replot", action="store_true",
                    help="regenerate heatmap figures from committed "
                         "artifact CSVs in --outdir (no solves)")
    args = ap.parse_args(argv)
    if args.replot:
        # the committed GSA artifacts live in results/; only an
        # explicit --outdir overrides that (the shared argparser's
        # 'images' default is for figure-emitting drivers)
        outdir = args.outdir if args.outdir != "images" else "results"
        import glob as _glob

        if not _glob.glob(f"{outdir}/*_ST.csv"):
            raise SystemExit(
                f"--replot: no *_ST.csv artifacts found in {outdir!r}")
        replot(outdir)
        return
    dev = common.device(args)

    solver_kw = dict(max_steps=args.max_steps)
    if args.f32:
        solver_kw["dtype"] = torch.float32
    # default: f64 RODAS4 with f32 linear algebra (the Rosenbrock stage
    # solves keep their order under a perturbed-but-consistent W, which
    # an f32 factorization is).  Full-f32 *state* stays opt-in: corner
    # RHS evaluation underflows there.
    if not args.full_f64_linsolve and not args.f32:
        solver_kw["linsolve_dtype"] = torch.float32

    system = (g.memb_sfk_system() if args.target.endswith("membsfk")
              else g.base_system())
    Co = g.default_co(device=dev)
    params = g.default_params(device=dev)

    if args.target.startswith("concs"):
        # GSA over initial concentrations (GSA_concs.jl:62-71)
        bounds = conc_bounds(Co)
        names = CO_NAMES
        evaluate = make_conc_evaluator(system, params, device=dev,
                                       dr=args.dr, tf=args.tf,
                                       rtol=args.rtol, chunk=args.chunk,
                                       **solver_kw)
    else:
        bounds = dk_bounds(params)
        names = PNAMES
        evaluate = make_param_evaluator(system, Co, device=dev, dr=args.dr,
                                        tf=args.tf, rtol=args.rtol,
                                        chunk=args.chunk, **solver_kw)

    if args.method == "efast":
        S1, ST, design = run_efast(evaluate, bounds,
                                   samples=args.samples,
                                   num_harmonics=4,
                                   resamples=args.resamples,
                                   seed=args.seed + 123)
        tag = f"eFAST_{args.target}_{args.samples}spls"
        if args.resamples > 1:
            tag += f"_{args.resamples}rs"
    else:
        S1, ST, design = run_sobol(evaluate, bounds, n=args.samples,
                                   seed=args.seed + 123)
        tag = f"Sobol_{args.target}_{args.samples}spls"

    for label, M in (("S1", S1), ("ST", ST)):
        rows = [[names[i]] + list(M[i]) for i in range(len(names))]
        common.save_csv(f"{args.outdir}/{tag}_{label}.csv",
                        ["param"] + list(GSA_VAR_NAMES), rows)
    save_heatmaps(args.outdir, tag, names, S1, ST)
    # quick ranking printout for the average-PG1Stot output
    order = np.argsort(-ST[:, 5])
    print(f"{tag}: top-8 parameters by ST on [pG1S2]_average:")
    for i in order[:8]:
        print(f"  {names[i]:9s} ST={ST[i,5]:.3f} S1={S1[i,5]:.3f}")


def save_heatmaps(outdir, tag, names, S1, ST):
    """S1/ST index heatmaps, the reference's figure form
    (``GSA_diffs+kinetic-params_MoL.jl:118-156``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 0.28 * len(names) + 2),
                             constrained_layout=True)
    for ax, (label, M) in zip(axes, (("S1", S1), ("ST", ST))):
        im = ax.imshow(np.asarray(M), aspect="auto", cmap="viridis",
                       vmin=0.0, vmax=max(1e-6, float(np.nanmax(ST))))
        ax.set_xticks(range(len(GSA_VAR_NAMES)))
        ax.set_xticklabels(GSA_VAR_NAMES, rotation=45, ha="right",
                           fontsize=7)
        ax.set_yticks(range(len(names)))
        ax.set_yticklabels(names, fontsize=7)
        ax.set_title(f"{label} ({tag})", fontsize=9)
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(f"{outdir}/{tag}_heatmap.png", dpi=150)
    plt.close(fig)


def replot(outdir="results"):
    """Regenerate heatmaps from committed artifact CSVs (no solves)."""
    import csv
    import glob
    import os

    for st_path in sorted(glob.glob(f"{outdir}/*_ST.csv")):
        tag = os.path.basename(st_path)[:-7]
        mats = {}
        names = None
        for label in ("S1", "ST"):
            with open(f"{outdir}/{tag}_{label}.csv") as f:
                rows = list(csv.reader(f))
            names = [r[0] for r in rows[1:]]
            mats[label] = np.asarray(
                [[float(x) for x in r[1:]] for r in rows[1:]])
        save_heatmaps(outdir, tag, names, mats["S1"], mats["ST"])
        print(f"wrote {outdir}/{tag}_heatmap.png")


if __name__ == "__main__":
    main()
