"""Extended FAST (eFAST) global sensitivity analysis.

TPU-native replacement for the reference's GlobalSensitivity.jl eFAST
runs (``GSA_diffs+kinetic-params_MoL.jl:85``: 24 parameters x 1000
samples -> 24,000 stiff PDE solves).  The search-curve design and the
spectral S1/ST estimators follow Saltelli, Tarantola & Chan (1999), the
same method GlobalSensitivity.jl implements; the model-evaluation batch
is one ``vmap``/``shard_map``-able array, so the whole 24k-solve sweep
is a single sharded ensemble call instead of ``pmap`` over worker
processes.

Outputs follow the reference convention: per-parameter first-order (S1)
and total-order (ST) indices for each of the model's summary outputs,
with failed model evaluations contributing zeros
(``sapdesolver.jl:363-366``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np


class EFASTDesign(NamedTuple):
    X: np.ndarray        # (d * resamples * samples, d) sample matrix
    omega_max: int       # fundamental frequency of the param of interest
    samples: int         # samples per search curve
    d: int               # number of parameters
    resamples: int       # search curves per parameter (random phases)


def efast_design(bounds: np.ndarray, samples: int, *,
                 num_harmonics: int = 4,
                 resamples: int = 1,
                 log_space: bool = True,
                 rng: Optional[np.random.Generator] = None) -> EFASTDesign:
    """Build the eFAST search-curve sample matrix.

    ``bounds``: (d, 2) parameter bounds.  With ``log_space`` the curves
    run in log coordinates and are exponentiated, reproducing the
    reference's exp-transform of log-space bounds
    (``GSA_diffs+kinetic-params_MoL.jl:68-74``, ``sapdesolver_MoL.jl:69``).
    ``samples`` is per curve (the reference's ``samples=1000``).

    ``resamples`` draws multiple curves per parameter with independent
    random phases (Saltelli's N_r): the along-curve variance estimate
    fluctuates strongly when low complementary frequencies interfere,
    and averaging the per-curve indices over phases removes that
    artifact.  The reference's single-curve run corresponds to
    ``resamples=1``.
    """
    rng = rng or np.random.default_rng(0)
    bounds = np.asarray(bounds, float)
    d = len(bounds)
    if log_space:
        lo, hi = np.log(bounds[:, 0]), np.log(bounds[:, 1])
    else:
        lo, hi = bounds[:, 0], bounds[:, 1]

    omega_max = (samples - 1) // (2 * num_harmonics)
    if omega_max < num_harmonics:
        raise ValueError("samples too small for the harmonic count")
    # complementary frequencies: at most omega_max/(2*num_harmonics),
    # cycled over the remaining parameters (Saltelli 1999)
    m = max(omega_max // (2 * num_harmonics), 1)
    comp = 1 + (np.arange(d - 1) % m)

    s = (2.0 * math.pi / samples) * np.arange(samples)
    X = np.empty((d, resamples, samples, d))
    for i in range(d):
        omega = np.empty(d)
        omega[i] = omega_max
        omega[np.arange(d) != i] = comp
        for rcurve in range(resamples):
            phi = rng.uniform(0.0, 2.0 * math.pi, size=d)
            g = 0.5 + (1.0 / math.pi) * np.arcsin(
                np.sin(omega[None, :] * s[:, None] + phi[None, :]))
            X[i, rcurve] = lo + g * (hi - lo)
    X = X.reshape(d * resamples * samples, d)
    if log_space:
        X = np.exp(X)
    return EFASTDesign(X=X, omega_max=omega_max, samples=samples, d=d,
                       resamples=resamples)


def efast_indices(Y: np.ndarray, design: EFASTDesign, *,
                  num_harmonics: int = 4
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Spectral S1/ST estimation from model outputs.

    ``Y``: (d * resamples * samples, n_out).  Returns (S1, ST) of shape
    (d, n_out), averaged over resample curves, NaN -> 0 as in the
    reference's post-processing (``GSA_diffs+kinetic-params_MoL.jl:87-97``).
    """
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    d, N, wmax = design.d, design.samples, design.omega_max
    NR = design.resamples
    Y = Y.reshape(d, NR, N, -1)
    n_out = Y.shape[-1]
    S1 = np.zeros((d, n_out))
    ST = np.zeros((d, n_out))
    half = (N - 1) // 2
    harm = wmax * np.arange(1, num_harmonics + 1)
    harm = harm[harm <= half]
    for i in range(d):
        F = np.fft.fft(Y[i], axis=1)  # (NR, N, n_out)
        Sp = (np.abs(F[:, 1:half + 1]) / N) ** 2  # one-sided spectrum
        V = 2.0 * Sp.sum(axis=1)
        D1 = 2.0 * Sp[:, harm - 1].sum(axis=1)
        Dt = 2.0 * Sp[:, : max(wmax // 2, 1)].sum(axis=1)
        # pooled (ratio-of-means) estimator over resample curves: the
        # per-curve ratio D1/V carries a Jensen bias of order
        # (sd(V)/mean(V))^2 when low complementary frequencies
        # interfere; pooling the spectra first removes it.
        Vm = V.mean(axis=0)
        # constant output along the curves -> all indices zero (guards
        # against fft roundoff producing a spurious ~1e-30 variance)
        live = Vm > 1e-12 * np.mean(Y[i] ** 2, axis=(0, 1)) + 1e-300
        with np.errstate(invalid="ignore", divide="ignore"):
            S1[i] = np.where(live, D1.mean(axis=0) / Vm, 0.0)
            ST[i] = np.where(live, 1.0 - Dt.mean(axis=0) / Vm, 0.0)
    return np.nan_to_num(S1), np.nan_to_num(ST)


def log_bounds_around(baseline: np.ndarray, factor: float = 1000.0
                      ) -> np.ndarray:
    """The reference's GSA bounds: baseline x/÷ ``factor``
    (``GSA_diffs+kinetic-params_MoL.jl:68-74``)."""
    baseline = np.asarray(baseline, float)
    return np.stack([baseline / factor, baseline * factor], axis=1)
