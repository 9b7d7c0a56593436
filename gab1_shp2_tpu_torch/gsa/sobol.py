"""Sobol global sensitivity indices (Saltelli sampling + Jansen
estimators).

A quasi-Monte-Carlo companion to eFAST (the reference exposes both via
GlobalSensitivity.jl; eFAST is what its scripts run).  Uses scipy's
Sobol sequence for the A/B matrices; the d+2 evaluation blocks batch
into one vmapped ensemble call.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
from scipy.stats import qmc


class SobolDesign(NamedTuple):
    X: np.ndarray   # ((d + 2) * n, d) stacked [A; B; AB_1..AB_d]
    n: int
    d: int


def sobol_design(bounds: np.ndarray, n: int, *, log_space: bool = True,
                 seed: int = 0) -> SobolDesign:
    """Saltelli A/B/AB_i design with 2 base matrices of ``n`` rows."""
    bounds = np.asarray(bounds, float)
    d = len(bounds)
    sampler = qmc.Sobol(2 * d, scramble=True, rng=np.random.default_rng(seed))
    u = sampler.random(n)
    A_u, B_u = u[:, :d], u[:, d:]
    if log_space:
        lo, hi = np.log(bounds[:, 0]), np.log(bounds[:, 1])
    else:
        lo, hi = bounds[:, 0], bounds[:, 1]
    A = lo + A_u * (hi - lo)
    B = lo + B_u * (hi - lo)
    blocks = [A, B]
    for i in range(d):
        ABi = A.copy()
        ABi[:, i] = B[:, i]
        blocks.append(ABi)
    X = np.concatenate(blocks, axis=0)
    if log_space:
        X = np.exp(X)
    return SobolDesign(X=X, n=n, d=d)


def sobol_indices(Y: np.ndarray, design: SobolDesign
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Jansen (1999) estimators for S1 and ST, shape (d, n_out)."""
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, d = design.n, design.d
    YA = Y[:n]
    YB = Y[n:2 * n]
    V = np.var(np.concatenate([YA, YB]), axis=0, ddof=1)
    S1 = np.zeros((d, Y.shape[-1]))
    ST = np.zeros((d, Y.shape[-1]))
    for i in range(d):
        YABi = Y[(2 + i) * n:(3 + i) * n]
        with np.errstate(invalid="ignore", divide="ignore"):
            S1[i] = (V - 0.5 * np.mean((YB - YABi) ** 2, axis=0)) / V
            ST[i] = 0.5 * np.mean((YA - YABi) ** 2, axis=0) / V
    return np.nan_to_num(S1), np.nan_to_num(ST)
