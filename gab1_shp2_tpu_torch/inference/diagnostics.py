"""MCMC convergence diagnostics: split R-hat, rank-normalized ESS,
and a sampler health gate.

The reference relies on Turing/MCMCChains printing R-hat and ESS with
every ``describe(chain)`` call (``param_fitting+inference_finitediff.jl``
displays the fitted chains at ``:411-420``); this module provides the
same checks natively so the workloads can *assert* health instead of
relying on a human reading a table.  Motivated concretely by the
round-4 exact-likelihood run, where a warmup pathology froze all
chains (100% post-warmup divergences) and the artifacts still looked
superficially plausible — ``check_chains`` turns that failure mode
into a loud refusal.

Implements the split-chain R-hat and rank-normalized ESS of Vehtari,
Gelman, Simpson, Carpenter & Buerkner (2021), "Rank-normalization,
folding, and localization: an improved R-hat for assessing convergence
of MCMC" — the same definitions MCMCChains/ArviZ/Stan use.  Pure
NumPy: diagnostics run on host after sampling, never inside jit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws) -> (2*chains, draws//2), dropping an odd draw."""
    m, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional ranks across ALL chains -> normal scores (the
    rank-normalization that makes R-hat/ESS robust to heavy tails —
    exactly what the posterior's 3-4-decade spreads produce)."""
    from scipy.special import ndtri  # inverse normal CDF

    flat = x.reshape(-1)
    ranks = np.empty_like(flat)
    order = np.argsort(flat, kind="stable")
    ranks[order] = np.arange(1, flat.size + 1)
    z = ndtri((ranks - 0.375) / (flat.size + 0.25))
    return z.reshape(x.shape)


def split_rhat(x: np.ndarray, rank_normalized: bool = True) -> float:
    """Split-chain potential scale reduction factor.

    ``x`` has shape (chains, draws).  Returns NaN when a split chain is
    constant (frozen chain: zero within-chain variance makes the
    classical formula meaningless — callers must treat NaN as failure,
    which ``check_chains`` does).
    """
    x = np.asarray(x, float)
    seqs = _split_chains(x)
    if rank_normalized:
        seqs = _rank_normalize(seqs)
    m, n = seqs.shape
    if n < 2:
        return float("nan")
    W = seqs.var(axis=1, ddof=1).mean()
    B = n * seqs.mean(axis=1).var(ddof=1)
    if W == 0.0:
        return float("nan")
    var_plus = (n - 1) / n * W + B / n
    return float(math.sqrt(var_plus / W))


def ess(x: np.ndarray, rank_normalized: bool = True) -> float:
    """Effective sample size across split chains via Geyer's initial
    monotone positive sequence on the chain-averaged autocorrelations
    (Stan's estimator)."""
    x = np.asarray(x, float)
    seqs = _split_chains(x)
    if rank_normalized:
        seqs = _rank_normalize(seqs)
    m, n = seqs.shape
    if n < 4:
        return float("nan")
    chain_var = seqs.var(axis=1, ddof=1)
    W = chain_var.mean()
    B = n * seqs.mean(axis=1).var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * W + B / n
    if var_plus == 0.0:
        return float("nan")

    # per-chain autocovariance via FFT
    centered = seqs - seqs.mean(axis=1, keepdims=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(centered, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n] / n

    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus  # combined rho_t
    # Geyer initial monotone positive sequence on EVEN/ODD pairs
    # Gamma_k = rho[2k] + rho[2k+1] (Gamma_0 includes rho_0), as in
    # Stan: only this pairing carries the positivity guarantee.
    # tau = -1 + 2 * sum(pairs).
    pairs = []
    k = 0
    while 2 * k + 1 < n:
        p = rho[2 * k] + rho[2 * k + 1]
        if p <= 0:
            break
        pairs.append(p)
        k += 1
    for i in range(1, len(pairs)):  # enforce monotone decreasing
        pairs[i] = min(pairs[i], pairs[i - 1])
    tau = max(-1.0 + 2.0 * sum(pairs), 1e-8)
    # Stan's anti-overconfidence cap: ESS <= m*n*log10(m*n)
    cap = m * n * math.log10(max(m * n, 10))
    return float(min(m * n / tau, cap))


def check_chains(
    qs: np.ndarray,
    diverged: Optional[np.ndarray] = None,
    names: Optional[Sequence[str]] = None,
    *,
    rhat_max: float = 1.05,
    div_rate_max: float = 0.25,
    min_unique_frac: float = 0.05,
) -> Dict:
    """Health report for a (chains, draws, dim) sample array.

    Returns ``{"ok": bool, "failures": [...], "rhat": {...},
    "ess": {...}, "divergence_rate": float}``.  A frozen chain (the
    round-4 failure: < ``min_unique_frac`` unique values), an R-hat
    above ``rhat_max`` (or NaN), or a divergence rate above
    ``div_rate_max`` marks the run not-ok.
    """
    qs = np.asarray(qs, float)
    m, n, d = qs.shape
    names = list(names) if names is not None else [f"q{j}" for j in range(d)]
    failures = []
    rhats, esss = {}, {}
    for j, name in enumerate(names):
        r = split_rhat(qs[:, :, j])
        e = ess(qs[:, :, j])
        rhats[name], esss[name] = r, e
        if not np.isfinite(r) or r > rhat_max:
            failures.append(f"rhat({name}) = {r:.4g} > {rhat_max}")
        for c in range(m):
            uniq = len(np.unique(qs[c, :, j]))
            if uniq < max(2, int(min_unique_frac * n)):
                failures.append(
                    f"chain {c} frozen in {name}: {uniq} unique / {n}")
    div_rate = float(np.asarray(diverged).mean()) if diverged is not None \
        else 0.0
    if div_rate > div_rate_max:
        failures.append(f"divergence rate {div_rate:.2%} > "
                        f"{div_rate_max:.0%}")
    return {"ok": not failures, "failures": failures, "rhat": rhats,
            "ess": esss, "divergence_rate": div_rate}
