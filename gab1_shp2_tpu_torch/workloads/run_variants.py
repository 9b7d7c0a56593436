"""Variant-comparison drivers.

Counterpart of ``gab1_shp2_tpu/workloads/run_variants.py``: ports of
``run_base_model_HeLa.jl`` (base vs HeLa abundances),
``run_base_model_rect.jl`` (spherical vs rectangular geometry),
``run_base_model_membrane-SFKs.jl`` (diffusible vs membrane-confined
active SFKs), and ``run_base_model_hi-EGFR-binding(_HeLa).jl``
(kG2f x10^1..10^4 sweeps vs center:surface gradient flattening).

    python -m gab1_shp2_tpu_torch.workloads.run_variants --variant hela \
        [--cpu] ...
"""

from __future__ import annotations

import os

import numpy as np
import torch

import gab1_shp2_tpu_torch as g
from gab1_shp2_tpu_torch.ensemble.engine import masked_quantiles, run_ensemble
from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.workloads import common
from gab1_shp2_tpu_torch.workloads.common import to_numpy

R = 10.0


def _ens_profiles(system, Co, ens, kw):
    q, n_ok = common.summary_surfaces(
        system, Co, ens, lambda s: s.PG1Stot[-1], **kw)
    return q, n_ok


def _save_profiles(path, r, **qs):
    """Median/68%-CI profile data behind each comparison figure."""
    hdr = ["r"]
    cols = [np.asarray(r)]
    for name, q in qs.items():
        hdr += [f"{name}_lo68", f"{name}_median", f"{name}_hi68"]
        cols += [np.asarray(q[0]), np.asarray(q[1]), np.asarray(q[2])]
    common.save_csv(path, hdr, np.stack(cols, axis=1).tolist())


def main(argv=None):
    ap = common.default_argparser(__doc__)
    ap.add_argument("--variant", choices=("hela", "rect", "memb_sfk",
                                          "hi_egfr", "hi_egfr_hela"),
                    required=True)
    args = ap.parse_args(argv)
    dev = common.device(args)
    out = args.outdir
    os.makedirs(out, exist_ok=True)
    ens = common.get_ensemble(args.n, seed=args.seed)
    kw = dict(solver=args.solver, device=dev, dr=args.dr, tf=args.tf,
              Nts=args.nts, rtol=args.rtol, chunk=args.chunk,
              linsolve_dtype=common.linsolve_dtype(args),
              scheduler=common.scheduler(args))
    base_sys = g.base_system()
    co_base = g.default_co(device=dev)
    co_hela = g.hela_co(device=dev)
    r = np.arange(int(round(R / args.dr)) + 1) * args.dr

    if args.variant == "hela":
        # run_base_model_HeLa.jl:71-98: HeLa copy numbers vs base
        q_b, _ = _ens_profiles(base_sys, co_base, ens, kw)
        q_h, _ = _ens_profiles(base_sys, co_hela, ens, kw)
        common.save_line_plot(
            f"{out}/hela_vs_base_PG1Stot.png", r,
            {"base median": q_b[1], "HeLa median": q_h[1]},
            "r (um)", "PG1Stot (molec/um^3)",
            "GAB1-SHP2 at tf: base vs HeLa abundances",
            bands={"base 68%": (q_b[0], q_b[2]),
                   "HeLa 68%": (q_h[0], q_h[2])})
        _save_profiles(f"{out}/hela_vs_base_PG1Stot.csv", r,
                       base=q_b, hela=q_h)
        # center:surface ratio comparison with a native JZS Bayes
        # factor (the reference calls R's BayesFactor via RCall;
        # run_base_model_HeLa.jl:295-318)
        groups = {}
        for name, co in (("base", co_base), ("hela", co_hela)):
            cs, ok = run_ensemble(
                base_sys, co, ens,
                extract=lambda s: s.PG1Stot[-1, 0] / s.PG1Stot[-1, -1],
                **kw)
            qs = to_numpy(masked_quantiles(cs, ok))
            groups[name] = to_numpy(cs)[to_numpy(ok)]
            print(f"{name}: center:surface PG1Stot ratio median "
                  f"{qs[1]:.4f} [{qs[0]:.4f}, {qs[2]:.4f}]")
        from gab1_shp2_tpu_torch.utils.stats import hedges_g, jzs_ttest_bf10

        bf = jzs_ttest_bf10(groups["base"], groups["hela"])
        gg = hedges_g(groups["base"], groups["hela"])
        print(f"JZS Bayes factor (base vs HeLa cs-ratio): BF10 = {bf:.3g}, "
              f"Hedges g = {gg:.3f}")
        common.save_csv(f"{out}/hela_cs_ratio_bf.csv",
                        ["bf10", "hedges_g"], [[bf, gg]])

    elif args.variant == "rect":
        # run_base_model_rect.jl:81-89
        q_s, _ = _ens_profiles(base_sys, co_base, ens, kw)
        q_r, _ = _ens_profiles(g.rect_system(), co_base, ens, kw)
        common.save_line_plot(
            f"{out}/rect_vs_sphere_PG1Stot.png", r,
            {"spherical": q_s[1], "rectangular": q_r[1]},
            "r (um)", "PG1Stot", "GAB1-SHP2 at tf: geometry comparison",
            bands={"sph 68%": (q_s[0], q_s[2]),
                   "rect 68%": (q_r[0], q_r[2])})
        _save_profiles(f"{out}/rect_vs_sphere_PG1Stot.csv", r,
                       sphere=q_s, rect=q_r)

    elif args.variant == "memb_sfk":
        # run_base_model_membrane-SFKs.jl:88-89
        q_b, _ = _ens_profiles(base_sys, co_base, ens, kw)
        q_m, _ = _ens_profiles(g.memb_sfk_system(), co_base, ens, kw)
        common.save_line_plot(
            f"{out}/membSFK_vs_base_PG1Stot.png", r,
            {"diffusible aSFK": q_b[1], "membrane-confined aSFK": q_m[1]},
            "r (um)", "PG1Stot",
            "GAB1-SHP2 at tf: SFK confinement comparison",
            bands={"base 68%": (q_b[0], q_b[2]),
                   "memb 68%": (q_m[0], q_m[2])})
        _save_profiles(f"{out}/membSFK_vs_base_PG1Stot.csv", r,
                       base=q_b, memb_sfk=q_m)

    else:
        # hi-EGFR-binding sweep (run_base_model_hi-EGFR-binding.jl:85-150)
        co = co_hela if args.variant == "hi_egfr_hela" else co_base
        rows = []
        scatter = []
        for fac in (1.0, 10.0, 100.0, 1000.0, 10000.0):
            pe = Params.unpack(torch.as_tensor(ens, device=dev)).scale(
                kG2f=fac)
            cs, ok = run_ensemble(
                base_sys, co, pe,
                extract=lambda s: torch.stack(
                    [s.PG1Stot[-1, 0] / s.PG1Stot[-1, -1],
                     s.memb("EG2PG1S")[-1] * 3.0 / R /
                     (s.PG1Stot[-1, -1] + s.memb("EG2PG1S")[-1] * 3.0 / R)]),
                **kw)
            # HeLa GAB1 is only 1.53e3 copies/cell: at extreme kG2f the
            # center-node PG1Stot denominator can underflow (f32) to
            # 0/0 — treat non-finite ratios as failed lanes, the same
            # masking discipline as solver failures
            finite = torch.isfinite(cs).all(dim=-1)
            ok = ok & finite
            qs = to_numpy(masked_quantiles(cs, ok))
            rows.append([fac, qs[1, 0], qs[0, 0], qs[2, 0], qs[1, 1]])
            okm = to_numpy(ok)
            scatter.append(np.concatenate(
                [np.full((int(okm.sum()), 1), fac),
                 to_numpy(cs)[okm]], axis=1))
            print(f"kG2f x{fac:g}: cs ratio median {qs[1,0]:.4f}, "
                  f"EGFR-bound fraction {qs[1,1]:.4f}")
        common.save_csv(f"{out}/hi_egfr_{args.variant}.csv",
                        ["kG2f_factor", "cs_ratio_median", "cs_lo", "cs_hi",
                         "egfr_bound_frac_median"], rows)
        # per-member scatter + linear fit of cs-ratio vs EGFR-bound
        # fraction (run_base_model_hi-EGFR-binding.jl:85-150)
        sc = np.concatenate(scatter, axis=0)
        frac, csr = sc[:, 2], sc[:, 1]
        slope, intercept = np.polyfit(frac, csr, 1)
        r = np.corrcoef(frac, csr)[0, 1]
        print(f"linear fit cs_ratio ~ {slope:.4f} * egfr_bound_frac "
              f"+ {intercept:.4f}  (r = {r:.3f}, n = {len(sc)})")
        common.save_csv(f"{out}/hi_egfr_{args.variant}_scatter.csv",
                        ["kG2f_factor", "cs_ratio", "egfr_bound_frac"],
                        sc.tolist())


if __name__ == "__main__":
    main()
