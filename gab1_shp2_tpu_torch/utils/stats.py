"""Statistical comparison utilities.

Counterpart of ``gab1_shp2_tpu/utils/stats.py`` (numpy and scipy).

The reference shells out to R (ggstatsplot/BayesFactor/easystats) for a
Bayes-factor comparison of center:surface gradient distributions
between the base and HeLa ensembles (``run_base_model_HeLa.jl:295-318``).
This module implements the same quantity natively: the JZS (Jeffreys-
Zellner-Siow) two-sample t-test Bayes factor of Rouder et al. (2009),
with the default Cauchy effect-size scale r = sqrt(2)/2 matching the R
``BayesFactor::ttestBF`` default.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import integrate


def jzs_ttest_bf10(x: np.ndarray, y: np.ndarray,
                   r_scale: float = math.sqrt(2.0) / 2.0) -> float:
    """JZS Bayes factor BF10 for a two-sample comparison.

    BF10 > 1 favors a difference in means; < 1 favors the null.
    Matches ``BayesFactor::ttestBF`` (Rouder et al. 2009, eq. 1 with
    g ~ InverseGamma(1/2, r^2/2) integrated numerically).
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    nx, ny = len(x), len(y)
    nu = nx + ny - 2
    n_eff = nx * ny / (nx + ny)
    sp2 = ((nx - 1) * x.var(ddof=1) + (ny - 1) * y.var(ddof=1)) / nu
    t = (x.mean() - y.mean()) / math.sqrt(sp2 * (1 / nx + 1 / ny))

    def null_like():
        return (1.0 + t**2 / nu) ** (-(nu + 1) / 2.0)

    def integrand(g):
        ng = 1.0 + n_eff * g * r_scale**2
        return (ng ** -0.5
                * (1.0 + t**2 / (ng * nu)) ** (-(nu + 1) / 2.0)
                * (2 * math.pi) ** -0.5 * g ** -1.5
                * math.exp(-1.0 / (2 * g)))

    alt, _ = integrate.quad(integrand, 0, np.inf, limit=200)
    return float(alt / null_like())


def hedges_g(x: np.ndarray, y: np.ndarray) -> float:
    """Bias-corrected standardized mean difference (effect size)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    nx, ny = len(x), len(y)
    nu = nx + ny - 2
    sp = math.sqrt(((nx - 1) * x.var(ddof=1)
                    + (ny - 1) * y.var(ddof=1)) / nu)
    d = (x.mean() - y.mean()) / sp
    corr = 1.0 - 3.0 / (4.0 * nu - 1.0)
    return float(d * corr)
