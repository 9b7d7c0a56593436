"""Amortized PDE likelihood: Chebyshev surrogate of the fit observable.

Counterpart of ``gab1_shp2_tpu/inference/surrogate.py``.  The observable
``y(q) = %SHP2-bound GAB1`` is a smooth scalar field over 4
log-parameters, so it is

  1. evaluated once on an ``n^4`` tensor grid of Chebyshev nodes with
     the lane-minor batched stiff integrator,
  2. transformed to Chebyshev coefficients (DCT-I per axis), and
  3. handed to NUTS as a polynomial evaluator that autograd
     differentiates exactly.

Correctness is not delegated to the surrogate: the exact PDE likelihood
at every posterior draw importance-reweights the draws
(:func:`importance_reweight`), and the effective sample size says how
much the surrogate shaped the proposals.  The interpolated quantity is
``log(y + floor)``.  A surrogate saved by either package's
:func:`save_surrogate` loads in the other's :func:`load_surrogate`
(the same ``.npz`` fields and layouts).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

Y_FLOOR = 1e-12


class ChebSurrogate(NamedTuple):
    """Tensor-product Chebyshev interpolant of log(y + floor) over a box."""

    coef: torch.Tensor   # (n, n, n, n) Chebyshev coefficients
    lo: torch.Tensor     # (4,) box lower corner (log-parameter space)
    hi: torch.Tensor     # (4,) box upper corner

    def log_y(self, q: torch.Tensor) -> torch.Tensor:
        """Interpolated log(y + floor) at ``q`` (..., 4); clamps to the
        box (the prior puts ~1e-7 of its mass outside the default box,
        and the exact reweighting corrects draws that land there)."""
        x = 2.0 * (q - self.lo) / (self.hi - self.lo) - 1.0
        x = torch.clamp(x, -1.0, 1.0)
        n = self.coef.shape[0]
        # Chebyshev recurrence T_{k+1} = 2 x T_k - T_{k-1}, per axis
        T = [torch.ones_like(x), x]
        for _ in range(n - 2):
            T.append(2.0 * x * T[-1] - T[-2])
        T = torch.stack(T[:n], dim=-1)  # (..., 4, n)
        c = torch.einsum("ijkl,...i->...jkl", self.coef, T[..., 0, :])
        c = torch.einsum("...jkl,...j->...kl", c, T[..., 1, :])
        c = torch.einsum("...kl,...k->...l", c, T[..., 2, :])
        return torch.einsum("...l,...l->...", c, T[..., 3, :])

    def y(self, q: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_y(q))


def cheb_nodes(n: int) -> np.ndarray:
    """Chebyshev points of the second kind on [-1, 1], ascending."""
    return np.cos(np.pi * np.arange(n)[::-1] / (n - 1))


def _dct1_coeffs(vals: np.ndarray) -> np.ndarray:
    """Chebyshev coefficients from values at second-kind nodes, per axis:
    for f_j at x_j = cos(pi j / (n-1)), c_k = (2 - [k in {0, n-1}]) /
    (2(n-1)) * DCT-I(f)_k."""
    from scipy.fft import dct

    n = vals.shape[0]
    out = vals
    for axis in range(vals.ndim):
        v = np.moveaxis(out, axis, 0)
        # DCT-I expects descending-x (j = 0 at x=+1) ordering
        v = v[::-1]
        c = dct(v, type=1, axis=0) / (n - 1)
        c[0] /= 2.0
        c[-1] /= 2.0
        out = np.moveaxis(c, 0, axis)
    return out


def build_surrogate(batch_observable: Callable[[np.ndarray], np.ndarray],
                    lo: np.ndarray, hi: np.ndarray, *, n: int = 17,
                    chunk: int = 256,
                    progress: Optional[Callable[[int, int], None]] = None,
                    device=None,
                    ) -> Tuple[ChebSurrogate, np.ndarray]:
    """Evaluate ``batch_observable`` on the n^4 Chebyshev grid and fit.

    ``batch_observable``: (B, 4) log-parameter array -> (B,) observable
    values (NaN/non-finite allowed; replaced by the floor), called on
    chunks of ``chunk`` points.  Returns the surrogate (float64, on
    ``device``; the CUDA card by default) and the raw grid values
    (n, n, n, n) for diagnostics.
    """
    from gab1_shp2_tpu_torch.models.params import resolve_device

    dev = resolve_device(device)
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    t = cheb_nodes(n)
    axes = [lo[i] + (hi[i] - lo[i]) * (t + 1.0) / 2.0 for i in range(4)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    Q = grid.reshape(-1, 4)

    vals = np.empty(len(Q))
    for s in range(0, len(Q), chunk):
        vals[s:s + chunk] = np.asarray(batch_observable(Q[s:s + chunk]))
        if progress is not None:
            progress(min(s + chunk, len(Q)), len(Q))

    vals = vals.reshape((n,) * 4)
    bad = ~np.isfinite(vals) | (vals < 0)
    n_bad = int(bad.sum())
    if n_bad:
        print(f"[surrogate] {n_bad}/{vals.size} grid solves failed; "
              f"clamped to floor")
    logv = np.log(np.where(bad, 0.0, vals) + Y_FLOOR)
    coef = _dct1_coeffs(logv)

    def t64(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)

    return ChebSurrogate(coef=t64(coef), lo=t64(lo), hi=t64(hi)), vals


def save_surrogate(path: str, sur: ChebSurrogate,
                   grid_vals: np.ndarray) -> None:
    np.savez(path, coef=sur.coef.detach().cpu().numpy(),
             lo=sur.lo.detach().cpu().numpy(),
             hi=sur.hi.detach().cpu().numpy(), grid_vals=grid_vals)


def load_surrogate(path: str, device=None) -> ChebSurrogate:
    """A surrogate from a ``.npz`` of either package (float64, on
    ``device``; the CUDA card by default)."""
    from gab1_shp2_tpu_torch.models.params import resolve_device

    dev = resolve_device(device)
    with np.load(path) as z:
        return ChebSurrogate(*(torch.as_tensor(z[k], dtype=torch.float64,
                                               device=dev)
                               for k in ("coef", "lo", "hi")))


def importance_reweight(log_lik_exact: np.ndarray,
                        log_lik_surrogate: np.ndarray
                        ) -> Tuple[np.ndarray, float]:
    """Self-normalized importance weights exact/surrogate + ESS.

    The posterior draws were generated under the surrogate likelihood;
    weighting each draw by ``exp(exact - surrogate)`` makes every
    reported summary exact (up to the Monte-Carlo error the ESS
    measures).
    """
    lw = np.asarray(log_lik_exact) - np.asarray(log_lik_surrogate)
    finite = np.isfinite(lw)
    if not finite.any():
        raise ValueError(
            "importance_reweight: every draw's exact log-likelihood is "
            "non-finite — the exact PDE re-evaluation failed for all "
            "posterior samples (check solver failures / NaN lanes "
            "upstream); cannot reweight.")
    lw = lw - np.max(lw[finite])
    w = np.where(finite, np.exp(lw), 0.0)
    wsum = w.sum()
    if not np.isfinite(wsum) or wsum <= 0.0:
        raise ValueError(
            "importance_reweight: importance weights sum to zero or "
            "non-finite (all weights underflowed after max-shift); the "
            "surrogate and exact likelihoods disagree too strongly to "
            "reweight (ESS would be 0).")
    w = w / wsum
    ess = float(1.0 / np.sum(w**2))
    return w, ess


def weighted_quantiles(x: np.ndarray, w: np.ndarray, qs) -> np.ndarray:
    """Quantiles of weighted samples (inverse-CDF convention)."""
    order = np.argsort(x)
    xs, ws = x[order], w[order]
    cdf = np.cumsum(ws)
    cdf /= cdf[-1]
    return np.interp(np.asarray(qs), cdf, xs)
