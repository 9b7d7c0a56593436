"""Base-model analysis driver (port of ``Julia/run_base_model.jl``).

Counterpart of ``gab1_shp2_tpu/workloads/run_base_model.py``: single
baseline solve, posterior-ensemble median/68%-CI surfaces for active
SFKs and GAB1-SHP2, the model-vs-experiment %SHP2-bound-GAB1
comparison, and single-parameter perturbation sweeps.

    python -m gab1_shp2_tpu_torch.workloads.run_base_model [--cpu] ...
"""

from __future__ import annotations

import os

import numpy as np
import torch

import gab1_shp2_tpu_torch as g
from gab1_shp2_tpu_torch.ensemble.engine import masked_quantiles, run_ensemble
from gab1_shp2_tpu_torch.models.observables import pct_shp2_bound_gab1
from gab1_shp2_tpu_torch.models.params import EXPTL_PCT_SHP2_BOUND_GAB1, Params
from gab1_shp2_tpu_torch.workloads import common
from gab1_shp2_tpu_torch.workloads.common import to_numpy


def main(argv=None):
    ap = common.default_argparser(__doc__)
    ap.add_argument("--perturb", action="store_true",
                    help="run the single-parameter perturbation sweeps "
                         "(run_base_model.jl:465-818)")
    ap.add_argument("--scales", action="store_true",
                    help="time/length-scale analysis over the ensemble "
                         "(run_base_model.jl:823-902)")
    args = ap.parse_args(argv)
    dev = common.device(args)
    system = g.base_system()
    Co = g.default_co(device=dev)
    R = 10.0
    out = args.outdir
    os.makedirs(out, exist_ok=True)

    # --- single baseline solve (run_base_model.jl:83) ---
    sol = g.solve_stiff(system, Co, g.default_params(device=dev),
                        device=dev, dr=args.dr, tf=args.tf, Nts=args.nts,
                        rtol=args.rtol)
    r, t = to_numpy(sol.r), to_numpy(sol.t)
    common.save_surface_plot(f"{out}/base_aSFK_surface.png", r, t,
                             to_numpy(sol.cyto("aSFK")).T,
                             "active SFKs (baseline)", "aSFK (molec/um^3)")
    common.save_surface_plot(f"{out}/base_PG1Stot_surface.png", r, t,
                             to_numpy(sol.PG1Stot).T,
                             "GAB1-SHP2 (baseline)", "PG1Stot (molec/um^3)")

    # --- ensemble median/CI surfaces (run_base_model.jl:89-175) ---
    ens = common.get_ensemble(args.n, seed=args.seed)
    kw = dict(solver=args.solver, device=dev, dr=args.dr, tf=args.tf,
              Nts=args.nts, rtol=args.rtol, chunk=args.chunk,
              linsolve_dtype=common.linsolve_dtype(args),
              scheduler=common.scheduler(args))
    # one ensemble pass for the two surfaces and the % bound (extract
    # returns a tuple; the per-lane validity mask is shared)
    (pg1s, asfk, pct), ok = run_ensemble(
        system, Co, ens, extract=lambda s: (s.PG1Stot, s.cyto("aSFK"),
                                            pct_shp2_bound_gab1(s, Co, R)),
        **kw)
    q_pg1s = to_numpy(masked_quantiles(pg1s, ok))
    q_asfk = to_numpy(masked_quantiles(asfk, ok))
    n_ok = int(ok.sum())
    print(f"ensemble: {n_ok}/{len(ens)} members valid")
    common.save_surface_plot(f"{out}/ens_PG1Stot_median.png", r, t,
                             q_pg1s[1].T, "GAB1-SHP2 (ensemble median)",
                             "PG1Stot")
    common.save_surface_plot(f"{out}/ens_aSFK_median.png", r, t,
                             q_asfk[1].T, "aSFK (ensemble median)", "aSFK")
    common.save_line_plot(
        f"{out}/ens_PG1Stot_tf_profile.png", r,
        {"median": q_pg1s[1][-1]},
        "r (um)", "PG1Stot (molec/um^3)",
        "GAB1-SHP2 at tf, ensemble median with 68% CI",
        bands={"68% CI": (q_pg1s[0][-1], q_pg1s[2][-1])})

    # --- model vs experiment %SHP2-bound GAB1 (run_base_model.jl:257-311) ---
    qs = to_numpy(masked_quantiles(pct, ok, qs=(0.025, 0.5, 0.975)))
    # ~89% credible interval for the reference's bar figure
    # (run_base_model.jl:294-296: quantile(0.5 -+ 0.445))
    q89 = to_numpy(masked_quantiles(pct, ok, qs=(0.055, 0.945)))
    mu, sigma = EXPTL_PCT_SHP2_BOUND_GAB1
    print(f"% SHP2-bound GAB1: model median {qs[1]:.2f} "
          f"[{qs[0]:.2f}, {qs[2]:.2f}] vs experiment {mu} +- {sigma}")
    common.save_csv(f"{out}/pct_shp2_bound_gab1.csv",
                    ["q2.5", "median", "q97.5", "exptl_mu", "exptl_sigma",
                     "q5.5", "q94.5"],
                    [[qs[0], qs[1], qs[2], mu, sigma, q89[0], q89[1]]])
    common.save_bar_comparison(
        f"{out}/pct_bound_model_vs_expt.png",
        [("model", qs[1], qs[1] - q89[0], q89[1] - qs[1]),
         ("Expt", mu, sigma, sigma)],
        "% SHP2-bound\nGAB1",
        "Model (89% CI) vs experiment (run_base_model.jl:257-311)")

    # --- perturbation sweeps (run_base_model.jl:465-818) ---
    if args.perturb:
        base = g.default_params(device=dev)
        factors = np.array([0.01, 0.1, 1.0, 10.0, 100.0])
        rows = []
        for pname in ("Dsfk", "Dg1", "Ds2", "kSa", "kSi", "kG1p", "kG1dp",
                      "kS2f", "kS2r"):
            batch = _stack([base.scale(**{pname: f}) for f in factors])
            res, ok2 = run_ensemble(system, Co, batch,
                                    extract=lambda s:
                                    pct_shp2_bound_gab1(s, Co, R), **kw)
            for f, v, o in zip(factors, to_numpy(res), to_numpy(ok2)):
                rows.append([pname, f, float(v) if o else np.nan])
        common.save_csv(f"{out}/perturbation_pct_bound.csv",
                        ["param", "factor", "pct_shp2_bound_gab1"], rows)
        print(f"perturbation sweep written ({len(rows)} rows)")
        perturbation_profiles(system, Co, base, out, kw)

    if args.scales:
        _scales_analysis(ens, g.default_params(device=dev), out)


def _stack(params) -> Params:
    """Batch a list of single-member Params along a new leading axis."""
    return Params(D=torch.stack([p.D for p in params]),
                  k=torch.stack([p.k for p in params]))


def _profile_extract(s):
    """tf profiles of total GAB1-SHP2 and total pGAB1."""
    return torch.stack([s.PG1Stot[-1], s.PG1tot[-1]])


def _co_scaled(Co, species: str, factor: float):
    """Scale one initial concentration by name (``run_base_model.jl``
    ``pert_Cind`` regex matching: "SHP2" -> CoS2, "EGFR" -> CoEGFR)."""
    from gab1_shp2_tpu_torch.models.species import CO_NAMES

    i = CO_NAMES.index(species)
    Co = Co.clone()
    Co[i] *= factor
    return Co


def perturbation_profiles(system, Co, base, out, kw, R=10.0):
    """Steady-state perturbation studies with normalized spatial-profile
    outputs (``run_base_model.jl:465-818``).

    Five studies, each reporting max-normalized PG1Stot ("PG1S") and
    PG1tot ("PG1") profiles at tf per condition:

    - diffusivity: Dsfk x [0.01, 1] (``:476-506``)
    - kinetic: kS2r x [0.01, 1, 100] (``:514-553``)
    - joint kinetic + concentration: {kSi, kG1dp} x [1, 100] with
      [SHP2] x [1, 10], dropping the unperturbed-k/10x-Co rows as the
      reference does (``:560-645``, Co-perturbation intent ``:467-469``)
    - joint kinetic + diffusivity: {kS2r, kG1dp} x [1, 0.01] with
      Dsfk x [1, 0.01] (``:655-745``)
    - concentration only: [EGFR] x [0.001, 0.01, 0.1, 1] (``:752-811``)

    Conditions within a study that share one ``Co`` are batched through
    the ensemble engine (the reference threads each solve;
    ``Threads.@threads`` at ``:478``); per-``Co`` groups are separate
    calls, as in the JAX package.
    """

    def solve_profiles(Co_j, conditions):
        """conditions: list of (label, Params). Returns rows + figure
        series dicts for both observables."""
        batch = _stack([p for _, p in conditions])
        prof, okp = run_ensemble(system, Co_j, batch,
                                 extract=_profile_extract, **kw)
        prof, okp = to_numpy(prof), to_numpy(okp)
        # max-normalize each profile (run_base_model.jl:484-485)
        prof = prof / prof.max(axis=-1, keepdims=True)
        return [(lab, prof[i, 0], prof[i, 1], bool(okp[i]))
                for i, (lab, _) in enumerate(conditions)]

    r = np.arange(prof_len := int(round(R / kw.get("dr", 0.2))) + 1) \
        * kw.get("dr", 0.2)

    def write_study(name, results, title):
        rows = []
        for lab, pg1s, pg1, okc in results:
            if not okc:
                pg1s = pg1 = np.full_like(r, np.nan)
            for j in range(prof_len):
                rows.append([lab, r[j], pg1s[j], pg1[j]])
        common.save_csv(f"{out}/perturbation_profiles_{name}.csv",
                        ["condition", "r_um", "PG1S_norm", "PG1_norm"],
                        rows)
        common.save_line_plot(
            f"{out}/perturbation_PG1S_{name}.png", r,
            {lab: pg1s for lab, pg1s, _, okc in results if okc},
            "r (um)", "norm. GAB1-SHP2", title)
        common.save_line_plot(
            f"{out}/perturbation_pGAB1_{name}.png", r,
            {lab: pg1 for lab, _, pg1, okc in results if okc},
            "r (um)", "norm. pGAB1", title)

    # 1. diffusivity study: Dsfk x [0.01, 1] (:480 pert_vecD)
    res = solve_profiles(Co, [(f"{f:g}-fold", base.scale(Dsfk=f))
                              for f in (1.0, 0.01)])
    write_study("Dsfk", res, "Dsfk sensitivity")

    # 2. kinetic study: kS2r x [0.01, 1, 100] (:521 pert_vec)
    res = solve_profiles(Co, [(f"{f:g}-fold", base.scale(kS2r=f))
                              for f in (1.0, 0.01, 100.0)])
    write_study("kS2r", res, "kS2r sensitivity")

    # 3. joint k + [SHP2] (:563-605): conditions base / 100x kSi /
    # 100x kG1dp at 1x Co, then 100x kSi / 100x kG1dp at 10x [SHP2]
    # (the reference drops pertk==1x && pertC==10x at :612)
    res = solve_profiles(Co, [
        ("base model", base),
        ("100x kSi", base.scale(kSi=100.0)),
        ("100x kG1dp", base.scale(kG1dp=100.0))])
    res += solve_profiles(_co_scaled(Co, "CoS2", 10.0), [
        ("100x kSi; 10x [SHP2]", base.scale(kSi=100.0)),
        ("100x kG1dp; 10x [SHP2]", base.scale(kG1dp=100.0))])
    write_study("kSi-kG1dp_SHP2", res, "k + [SHP2] perturbations")

    # 4. joint k + Dsfk (:655-712): {kS2r, kG1dp} x 0.01 at 1x and
    # 0.01x Dsfk (the base-k rows collapse to one per Dsfk level)
    res = solve_profiles(Co, [
        ("base model", base),
        ("0.01x kS2r", base.scale(kS2r=0.01)),
        ("0.01x kG1dp", base.scale(kG1dp=0.01))])
    res += solve_profiles(Co, [
        ("0.01x Dsfk", base.scale(Dsfk=0.01)),
        ("0.01x kS2r; 0.01x Dsfk", base.scale(kS2r=0.01, Dsfk=0.01)),
        ("0.01x kG1dp; 0.01x Dsfk", base.scale(kG1dp=0.01, Dsfk=0.01))])
    write_study("kS2r-kG1dp_Dsfk", res, "k + Dsfk perturbations")

    # 5. concentration study: [EGFR] x [0.001, 0.01, 0.1, 1] (:771)
    res = []
    for f in (1.0, 0.1, 0.01, 0.001):
        res += solve_profiles(_co_scaled(Co, "CoEGFR", f),
                              [(f"{f:g}x [EGFR]", base)])
    write_study("EGFR", res, "[EGFR] sensitivity")
    print("perturbation profile studies written (5 CSVs + 10 figures)")


def _scales_analysis(ens, base, out):
    """Ensemble time scales (run_base_model.jl:823-855) and
    order-of-magnitude delta = sqrt(D/k) length scales (:858-902)."""
    from gab1_shp2_tpu_torch.models.species import PNAMES

    idx = {n: i for i, n in enumerate(PNAMES)}
    e = np.asarray(ens)
    tau = {
        "tau_Si": 60.0 / e[:, idx["kSi"]],
        "tau_G1dp": 60.0 / e[:, idx["kG1dp"]],
        "tau_S2r": 60.0 / e[:, idx["kS2r"]],
    }
    R = 10.0
    print(f"tau_EGFRp  = {60.0 / float(base.kp):.3g} sec")
    print(f"tau_EGFRdp = {60.0 / float(base.kdp):.3g} sec")
    print(f"tau_Dsfk   = {R**2 / (6 * float(base.Dsfk)) * 60:.3g} sec")
    print(f"tau_Dg1s2  = {R**2 / (6 * float(base.Dg1s2)) * 60:.3g} sec")
    for name, v in tau.items():
        print(f"{name} median = {np.median(v):.3g} sec")

    delta = {
        "delta_SFK": np.sqrt(e[:, idx["Dsfk"]] / e[:, idx["kSi"]]),
        "delta_dis": np.sqrt(e[:, idx["Dg1s2"]] / e[:, idx["kS2r"]]),
        "delta_dep": np.sqrt(e[:, idx["Dg1"]] / e[:, idx["kG1dp"]]),
    }
    delta["delta_G1S2"] = (delta["delta_SFK"] + delta["delta_dis"]
                           + delta["delta_dep"])
    rows = []
    for name, v in delta.items():
        q = np.quantile(v, [0.159, 0.5, 0.841])
        rows.append([name, q[1], q[0], q[2]])
        print(f"{name}: median {q[1]:.2f} um [{q[0]:.2f}, {q[2]:.2f}]")
    common.save_csv(f"{out}/oom_length_scales.csv",
                    ["scale", "median_um", "lo68", "hi68"], rows)


if __name__ == "__main__":
    main()
