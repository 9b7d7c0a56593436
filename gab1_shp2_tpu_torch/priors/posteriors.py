"""Posterior loading and parameter-ensemble generation.

Counterpart of ``gab1_shp2_tpu/priors/posteriors.py`` (a port of
``Julia/get_param_posteriors.jl``): MCMC chain samples provide the four
fitted parameters; everything else is drawn fresh from the priors.
Chains are read from the reference's posterior CSVs or from either
package's own NUTS output.

A chain is a numpy structured array with one float64 field per fitted
parameter (``chain["kG1p"]`` is a column, ``chain[idx]`` a set of rows),
read with the ``csv`` module.  :func:`generate_ensemble` draws exactly
what the JAX package's draws from the same ``np.random.Generator``: the
same calls in the same order.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

import numpy as np

from gab1_shp2_tpu_torch.models.species import PNAMES
from gab1_shp2_tpu_torch.priors.literature import EGF_UM, PriorSet, build_priors

FITTED = ("kG1p", "kG1dp", "kSa", "kSi")


def load_chain_csv(path: str) -> np.ndarray:
    """Load posterior samples with columns kG1p, kG1dp, kSa, kSi (the
    reference's ``Turing results/*_posteriors.csv`` layout; other
    columns are ignored) as a structured array keyed by those names."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    header = [h.strip() for h in rows[0]]
    missing = [n for n in FITTED if n not in header]
    if missing:
        raise KeyError(f"{path}: no column(s) {missing}")
    cols = [header.index(n) for n in FITTED]
    body = [r for r in rows[1:] if r]
    out = np.empty(len(body), dtype=[(n, np.float64) for n in FITTED])
    for n, c in zip(FITTED, cols):
        out[n] = [float(r[c]) for r in body]
    return out


def best_fit_values(chain: np.ndarray) -> Dict[str, float]:
    """Highest-probability values: exp(median(log(chain)))
    (``get_param_posteriors.jl:17-20``); NaN samples are skipped."""
    return {c: float(np.exp(np.nanmedian(np.log(chain[c])))) for c in FITTED}


def generate_ensemble(
    chain: Optional[np.ndarray],
    priors: Optional[PriorSet] = None,
    *,
    n: int = 2000,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Draw an (n, 24) parameter ensemble in reference column order.

    Fitted parameters are chain rows subsampled without replacement;
    all other parameters are fresh prior draws — five correlated
    binding-triple draws plus univariate lognormals
    (``get_param_posteriors.jl:38-86``).  With ``chain=None`` everything
    comes from the priors (prior-predictive ensembles).
    """
    rng = rng or np.random.default_rng(0)
    priors = priors or build_priors()

    draws: Dict[str, np.ndarray] = {}
    for key, (fname, rname) in {
        "G2": ("kG2f", "kG2r"), "G1": ("kG1f", "kG1r"),
        "S2": ("kS2f", "kS2r"), "EGF": ("kEGFf", "kEGFr"),
        "dim": ("kdf", "kdr"),
    }.items():
        kf, kr = priors.mv[key].kf_kr(priors.mv[key].sample(rng, n))
        draws[fname], draws[rname] = kf, kr
    for name in priors.UV_NAMES:
        mu, sigma = priors.uv(name)
        draws[name] = rng.lognormal(mu, sigma, size=n)
    draws["EGF"] = np.full(n, EGF_UM)

    if chain is not None:
        idx = rng.choice(len(chain), size=n, replace=False)
        sub = chain[idx]
        for c in FITTED:
            draws[c] = np.asarray(sub[c], dtype=np.float64)

    return np.stack([draws[name] for name in PNAMES], axis=1)
