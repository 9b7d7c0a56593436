"""Shared infrastructure for the workload drivers.

Counterpart of ``gab1_shp2_tpu/workloads/common.py``.  Each reference
analysis script (``run_base_model.jl`` and friends) has a workload
module here; this module holds the shared pieces: the argument parser,
the device and dtype flags, ensemble acquisition, median/credible-
interval summary surfaces, and figure/CSV output.

Every driver runs on the CUDA card and raises when there is none;
``--cpu`` runs all of it on the CPU instead (``device(args)``).  The
CSVs are written as the JAX package writes them, so the two packages'
outputs compare number by number.  Figures need matplotlib, which is
imported inside the plot helpers only: nothing a CSV needs imports it.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from gab1_shp2_tpu_torch.ensemble.engine import masked_quantiles, run_ensemble
from gab1_shp2_tpu_torch.models.params import load_ensemble_csv, resolve_device

REFERENCE_ENSEMBLE = "/root/reference/Julia/parameter_ensemble.csv"
REFERENCE_CHAIN = ("/root/reference/Julia/Turing results/"
                   "Turing_res_5-chains_1000-spls_posteriors.csv")


def default_argparser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--cpu", action="store_true",
                    help="run every solve on the CPU (default: the CUDA "
                         "card, which must be present)")
    ap.add_argument("--n", type=int, default=200,
                    help="ensemble size (reference defaults are 1000-5000)")
    ap.add_argument("--dr", type=float, default=0.2)
    ap.add_argument("--tf", type=float, default=5.0)
    ap.add_argument("--nts", type=int, default=100)
    ap.add_argument("--rtol", type=float, default=1e-4)
    ap.add_argument("--solver", choices=("stiff", "explicit"),
                    default="stiff")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--linsolve", choices=("none", "f32", "bf16"),
                    default="f32",
                    help="mixed-precision linear algebra for the stiff "
                         "solver (default f32: the stage solves of a "
                         "Rosenbrock method keep their order under an "
                         "f32 factorization of W; 'none' keeps the "
                         "state's dtype)")
    ap.add_argument("--scheduler", choices=("auto", "sorted", "refill"),
                    default="auto",
                    help="stiff ensemble dispatch strategy (auto = the "
                         "engine's default, the lane-refill scheduler; "
                         "see ensemble/engine.py run_ensemble)")
    ap.add_argument("--outdir", default="images")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def device(args) -> torch.device:
    """Map the --cpu flag to the device every entry point takes: the
    CPU, or the CUDA card (raising when there is none)."""
    return resolve_device("cpu" if getattr(args, "cpu", False) else None)


def linsolve_dtype(args):
    """Map the --linsolve flag to a dtype (or None)."""
    return {"none": None, "f32": torch.float32,
            "bf16": torch.bfloat16}[args.linsolve]


def scheduler(args):
    """Map the --scheduler flag to run_ensemble's kwarg (None = auto)."""
    return None if getattr(args, "scheduler", "auto") == "auto" \
        else args.scheduler


def get_ensemble(n: int, seed: int = 0) -> np.ndarray:
    """Parameter ensemble: subsample the reference's shipped CSV when
    available (exact parity), else generate from chain+priors
    (``get_param_posteriors.jl:38-86``).  The same draws as the JAX
    package's for the same ``seed``."""
    rng = np.random.default_rng(seed)
    if os.path.exists(REFERENCE_ENSEMBLE):
        ens = load_ensemble_csv(REFERENCE_ENSEMBLE)
        idx = rng.choice(len(ens), size=min(n, len(ens)), replace=False)
        return ens[idx]
    from gab1_shp2_tpu_torch.priors.posteriors import (
        generate_ensemble,
        load_chain_csv,
    )

    chain = None
    if os.path.exists(REFERENCE_CHAIN):
        chain = load_chain_csv(REFERENCE_CHAIN)
    return generate_ensemble(chain, n=n, rng=rng)


def to_numpy(x):
    """A tensor (or pytree leaf) as a numpy array on the host."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def summary_surfaces(system, Co, ensemble, extract: Callable, *,
                     qs=(0.159, 0.5, 0.841), **kw):
    """Run the ensemble and return per-(whatever extract emits)
    quantile summaries as numpy, mirroring the median/68%-CI surfaces of
    ``run_base_model.jl:99-175``."""
    out, ok = run_ensemble(system, Co, ensemble, extract=extract, **kw)
    return to_numpy(masked_quantiles(out, ok, qs=qs)), int(ok.sum())


def save_csv(path: str, header, rows) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    import csv

    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        w.writerows(rows)


def save_surface_plot(path: str, r, t, surface, title: str,
                      zlabel: str) -> None:
    """3-D surface figure standing in for the reference's Makie plots
    (``run_base_model.jl:198-253``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(111, projection="3d")
    T, Rg = np.meshgrid(t, r)
    ax.plot_surface(Rg, T, surface, cmap="viridis", linewidth=0)
    ax.set_xlabel("r (um)")
    ax.set_ylabel("t (min)")
    ax.set_zlabel(zlabel)
    ax.set_title(title)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def save_line_plot(path: str, x, ys: dict, xlabel: str, ylabel: str,
                   title: str, bands: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for label, y in ys.items():
        ax.plot(x, y, label=label)
    if bands:
        for label, (lo, hi) in bands.items():
            ax.fill_between(x, lo, hi, alpha=0.25, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def save_bar_comparison(path: str, bars, ylabel: str, title: str) -> None:
    """Bar + asymmetric error-bar comparison figure, the form of the
    reference's model-vs-experiment panel (``run_base_model.jl:285-311``:
    BarPlot + Errorbars per group).

    ``bars`` is a list of (label, value, err_lo, err_hi).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = [b[0] for b in bars]
    vals = [b[1] for b in bars]
    errs = np.array([[b[2] for b in bars], [b[3] for b in bars]])
    fig, ax = plt.subplots(figsize=(2.6, 3.4))
    x = np.arange(len(bars))
    ax.bar(x, vals, width=0.6, color=["#2a6f97", "#bc4749"][:len(bars)],
           alpha=0.85)
    ax.errorbar(x, vals, yerr=errs, fmt="none", ecolor="black",
                capsize=4, lw=1.2)
    ax.set_xticks(x, labels)
    ax.set_ylabel(ylabel)
    ax.set_ylim(0, None)
    ax.set_title(title, fontsize=8)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def save_rotated_chase_surface(path: str, t_chase, r, z_med, ci_tf=None,
                               ci_rR=None, zlabel: str = "",
                               title: str = "") -> None:
    """Rotated-azimuth 3-D surface of the chase window
    (``gefitinib_pulse_chase.jl:215-253``: Axis3 azimuth=-1.9pi/3,
    elevation=0.18pi, turbo surface + black wireframe, red dashed 68%
    CI projections at t=t_chase and r=R).

    ``z_med`` is (len(t_chase), len(r)); ``ci_tf`` = (lo, hi) profiles
    over r at the final chase time; ``ci_rR`` = (lo, hi) traces over
    t_chase at r=R.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 5.5))
    ax = fig.add_subplot(111, projection="3d")
    T, Rg = np.meshgrid(t_chase, r, indexing="ij")
    ax.plot_surface(T, Rg, z_med, cmap="turbo", linewidth=0,
                    antialiased=True, alpha=0.95)
    # coarse wireframe on top, the reference's mk.wireframe!
    st, sr = max(1, len(t_chase) // 24), max(1, len(r) // 10)
    ax.plot_wireframe(T, Rg, z_med, rstride=st, cstride=sr,
                      color="black", linewidth=0.5)
    tc_end, R = float(t_chase[-1]), float(r[-1])
    if ci_tf is not None:
        for prof in ci_tf:
            ax.plot(np.full_like(r, tc_end), r, prof, "r--", lw=1.2)
    if ci_rR is not None:
        for trace in ci_rR:
            ax.plot(t_chase, np.full_like(t_chase, R), trace, "r--",
                    lw=1.2)
    # Makie azimuth=-1.9pi/3 (=-114 deg), elevation=0.18pi (=32.4 deg)
    ax.view_init(elev=32.4, azim=-114.0)
    ax.set_xlabel("Gefitinib chase\ntime (min)")
    ax.set_ylabel("r (um)")
    ax.set_zlabel(zlabel)
    ax.set_title(title, fontsize=10)
    ax.set_xlim(0, tc_end)
    ax.set_ylim(0, R)
    ax.set_zlim(0, None)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
