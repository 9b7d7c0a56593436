"""Fitting loss and the Bayesian model for the 4-parameter inference.

Counterpart of ``gab1_shp2_tpu/inference/loss.py`` (see it for the
design decisions against the reference's ``loss`` and ``turing_model``,
``param_fitting+inference_finitediff.jl:188-226, 308-370``): the
observable is the % SHP2-bound GAB1 at 5 min EGF through the stiff
solve, the fit datum mu=26.426 with a lognormal sigma from the
protocol-transformed experimental spread.

Gradients flow through the single-member stiff solve by forward-mode AD
with 4 tangents (``ops/fwdgrad.py``; ``torch.func.jvp``/``jacfwd`` of
the observable give the same numbers, more slowly);
:func:`reverse_differentiable` hands them to reverse-mode callers (the
NUTS sampler, the LBFGS line search) as a ``torch.autograd.Function``.
Log densities broadcast over leading (chain) axes of ``q``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from gab1_shp2_tpu_torch.models.observables import pct_shp2_bound_gab1
from gab1_shp2_tpu_torch.models.params import (
    EXPTL_PCT_SHP2_BOUND_GAB1,
    Params,
    default_co,
    default_params,
    resolve_device,
)
from gab1_shp2_tpu_torch.models.species import K_NAMES
from gab1_shp2_tpu_torch.models.system import (
    ReactionDiffusionSystem,
    base_system,
)
from gab1_shp2_tpu_torch.ops.fwdgrad import value_and_fwd_grad
from gab1_shp2_tpu_torch.ops.trbdf2 import solve_stiff

FIT_NAMES = ("kG1p", "kG1dp", "kSa", "kSi")
_FIT_K_IDX = tuple(K_NAMES.index(n) for n in FIT_NAMES)

# lognormal (mu, sigma) of the fit datum, from the protocol transform of
# (26.426 +- 9.363) (param_fitting+inference_finitediff.jl:113-114)
DATUM_MU = EXPTL_PCT_SHP2_BOUND_GAB1[0]
DATUM_SIGMA = math.sqrt(math.log(
    1.0 + (EXPTL_PCT_SHP2_BOUND_GAB1[1] / EXPTL_PCT_SHP2_BOUND_GAB1[0]) ** 2))


def set_fitted(params: Params, log_k4: torch.Tensor) -> Params:
    """Insert exp(log_k4) into the four fitted kinetic slots (out of
    place, so tangents of ``log_k4`` flow into ``k``)."""
    batch = torch.broadcast_shapes(params.k.shape[:-1], log_k4.shape[:-1])
    cols = list(params.k.expand(batch + params.k.shape[-1:]).unbind(-1))
    for j, idx in enumerate(_FIT_K_IDX):
        cols[idx] = torch.exp(log_k4[..., j]).expand(batch)
    return Params(D=params.D, k=torch.stack(cols, dim=-1))


def _defaults(system, Co, base, device):
    dev = resolve_device(device)
    system = system or base_system()
    Co = default_co(device=dev) if Co is None else torch.as_tensor(
        Co, device=dev)
    base = (default_params(fit="prior", dtype=Co.dtype, device=dev)
            if base is None else base.to(dtype=Co.dtype, device=dev))
    return system, Co, base, dev


def make_observable_fn(
    system: Optional[ReactionDiffusionSystem] = None,
    Co=None,
    base: Optional[Params] = None,
    *,
    device=None,
    R: float = 10.0,
    dr: float = 0.2,
    tf: float = 5.0,
    rtol: float = 1e-4,
    atol: float = 1e-7,
    method: str = "trbdf2",
    linsolve_dtype=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns ``f(log_k4) -> pct_shp2_bound_gab1`` via the stiff solve.

    The defaults mirror the reference fit (dr=0.2, tf=5, the
    likelihood's solver tolerance rtol=1e-4); ``method="rodas4"`` solves
    the same objective in fewer steps, ``linsolve_dtype=torch.float32``
    runs the linear algebra in float32.  ``device=None`` runs on the
    CUDA card.  Differentiable by ``torch.func.jvp``/``jacfwd``.
    """
    system, Co, base, dev = _defaults(system, Co, base, device)

    def observable(log_k4: torch.Tensor) -> torch.Tensor:
        p = set_fitted(base, log_k4)
        sol = solve_stiff(system, Co, p, device=dev, R=R, dr=dr, tf=tf,
                          Nts=2, rtol=rtol, atol=atol, method=method,
                          linsolve_dtype=linsolve_dtype)
        return pct_shp2_bound_gab1(sol, Co, R)

    return observable


def chi2_loss(observable: Callable, log_k4: torch.Tensor,
              mu: float = DATUM_MU,
              sigma: float = EXPTL_PCT_SHP2_BOUND_GAB1[1]) -> torch.Tensor:
    """The MAP objective ``(mu - y)^2 / sigma^2``
    (``param_fitting+inference_finitediff.jl:218-226``); NaN -> +inf so
    failed solves are rejected, mirroring try/catch -> Inf."""
    y = observable(log_k4)
    val = (mu - y) ** 2 / sigma**2
    return torch.where(torch.isfinite(val), val, torch.inf)


# --- Bayesian model -------------------------------------------------------

def _normal_logpdf(x, mu, sigma):
    log_sigma = (torch.log(sigma) if isinstance(sigma, torch.Tensor)
                 else math.log(sigma))
    return (-0.5 * ((x - mu) / sigma) ** 2 - log_sigma
            - 0.5 * math.log(2 * math.pi))


def datum_loglik(y, *, datum: float = DATUM_MU,
                 datum_sigma: float = DATUM_SIGMA):
    """Log likelihood of the fit datum given a model observable ``y``:
    ``datum ~ truncated(LogNormal(log y, sigma), upper=100)``
    (``param_fitting+inference_finitediff.jl:368``).  Broadcasts."""
    if isinstance(y, (float, int, np.ndarray, list, tuple)):
        y = torch.as_tensor(y)
    y = torch.where(torch.isfinite(y) & (y > 0), y,
                    torch.full_like(y, 1e-10))
    log_datum = math.log(datum)
    ll = _normal_logpdf(log_datum, torch.log(y), datum_sigma) - log_datum
    z = (math.log(100.0) - torch.log(y)) / datum_sigma
    return ll - torch.special.log_ndtr(z)


def _prior_lognorm():
    from gab1_shp2_tpu_torch.priors.literature import build_priors

    ln = build_priors().lognorm
    mu = np.array([ln[n][0] for n in FIT_NAMES])
    sigma = np.array([ln[n][1] for n in FIT_NAMES])
    return mu, sigma


def prior_box(n_sigma_lo: float = 5.0, pad_hi: float = 0.3,
              trunc_decades: float = 3.0):
    """Support box for surrogate construction: ``mu - n_sigma_lo*sigma``
    up to the prior truncation point plus a barrier margin."""
    mu, sigma = _prior_lognorm()
    lo = mu - n_sigma_lo * sigma
    hi = mu + trunc_decades * math.log(10.0) + pad_hi
    return lo, hi


def make_batch_observable(
    system: Optional[ReactionDiffusionSystem] = None,
    Co=None,
    base: Optional[Params] = None,
    *,
    device=None,
    R: float = 10.0,
    dr: float = 0.2,
    tf: float = 5.0,
    rtol: float = 1e-4,
    atol: float = 1e-7,
    method: str = "trbdf2",
    linsolve_dtype=None,
    max_steps: int = 20_000,
    chunk: int = 256,
):
    """Chunked batched observable: (B, 4) log-parameters -> (B,) y, as
    numpy arrays.

    Each chunk is one lane-minor ensemble solve
    (``ops/batch_stiff.solve_stiff_batch``): the grid sweep behind the
    surrogate likelihood (``inference/surrogate.py``) and the exact
    reweighting pass.  Failed lanes return NaN.  A short last chunk is
    solved as it is (no padding to ``chunk`` lanes).
    """
    from gab1_shp2_tpu_torch.ops.batch_stiff import solve_stiff_batch

    system, Co, base, dev = _defaults(system, Co, base, device)

    def run_chunk(log_k4: torch.Tensor) -> torch.Tensor:
        B = log_k4.shape[0]
        pbase = Params(D=base.D.expand((B,) + base.D.shape),
                       k=base.k.expand((B,) + base.k.shape))
        p = set_fitted(pbase, log_k4)
        sol, stats = solve_stiff_batch(system, Co, p, device=dev, R=R,
                                       dr=dr, tf=tf, Nts=2, rtol=rtol,
                                       atol=atol, method=method,
                                       linsolve_dtype=linsolve_dtype,
                                       max_steps=max_steps,
                                       return_stats=True)
        y = pct_shp2_bound_gab1(sol, Co, R)
        return torch.where(stats.failed, torch.nan, y)

    def batch_obs(Q) -> np.ndarray:
        Q = torch.as_tensor(np.asarray(Q, float), dtype=Co.dtype,
                            device=dev)
        outs = [run_chunk(Q[s:s + chunk]) for s in range(0, len(Q), chunk)]
        return torch.cat(outs).cpu().numpy()

    return batch_obs


def make_log_posterior(
    observable: Callable,
    *,
    prior_mu: Optional[np.ndarray] = None,
    prior_sigma: Optional[np.ndarray] = None,
    trunc_decades: float = 3.0,
    datum: float = DATUM_MU,
    datum_sigma: float = DATUM_SIGMA,
    wrap_vjp: bool = True,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Log posterior over q = log(kG1p, kG1dp, kSa, kSi), (..., 4) ->
    (...).

    Priors: LogNormal(mu_i, sigma_i) truncated at mode*10^trunc_decades
    (``param_fitting+inference_finitediff.jl:329-332``), in log space a
    normal with a steep quadratic barrier at the upper bound.
    Likelihood: :func:`datum_loglik`.

    The solver only ever sees q clipped to a support box far in the
    prior tail (8 sigma below the mode, one e-fold past the truncation
    barrier), and the density is -inf outside it: early-warmup
    proposals with exp(q) ~ e^700 would overflow the stiff solve and
    turn its tangents NaN; outside the box they are clean divergences.

    ``wrap_vjp=False`` skips :func:`reverse_differentiable`, for
    observables that autograd differentiates natively (the Chebyshev
    surrogate).
    """
    if prior_mu is None:
        prior_mu, prior_sigma = _prior_lognorm()
    prior_mu = np.asarray(prior_mu, float)
    prior_sigma = np.asarray(prior_sigma, float)
    qmax = prior_mu + trunc_decades * math.log(10.0)
    support_lo = prior_mu - 8.0 * prior_sigma
    support_hi = qmax + 1.0

    def logpost_fwdonly(q: torch.Tensor) -> torch.Tensor:
        # the density follows q's dtype and device
        def c(a):
            return torch.as_tensor(a, dtype=q.dtype, device=q.device)

        lo, hi = c(support_lo), c(support_hi)
        lp = torch.sum(_normal_logpdf(q, c(prior_mu), c(prior_sigma)),
                       dim=-1)
        # steep smooth barrier for the upper truncation
        over = torch.clamp(q - c(qmax), min=0.0)
        lp = lp - 1e4 * torch.sum(over**2, dim=-1)
        q_s = torch.minimum(torch.maximum(q, lo), hi)
        ll = datum_loglik(observable(q_s), datum=datum,
                          datum_sigma=datum_sigma)
        inside = torch.all((q >= lo) & (q <= hi), dim=-1)
        return torch.where(inside, (lp + ll).to(q.dtype), -torch.inf)

    if not wrap_vjp:
        return logpost_fwdonly
    return reverse_differentiable(logpost_fwdonly)


class _FwdGrad(torch.autograd.Function):
    """Value and gradient by one forward pass carrying one tangent per
    coordinate (JAX's ``vmap`` of ``jvp`` over the basis, computed by
    ``ops/fwdgrad.value_and_fwd_grad``); the backward pass scales the
    stored gradient by the cotangent."""

    @staticmethod
    def forward(ctx, x, f, bad_value):
        lead = x.shape[:-1]
        xs = x.detach().reshape(-1, x.shape[-1])
        vals, grads = [], []
        for xi in xs:
            v, g = value_and_fwd_grad(f, xi)
            # a point where the value or gradient is non-finite is
            # outside the usable support: report the sentinel with a
            # zero gradient, never NaN (near-failure stiff solves can
            # give finite values with NaN tangents)
            bad = ~torch.isfinite(v) | ~torch.all(torch.isfinite(g))
            vals.append(torch.where(bad, torch.full_like(v, bad_value), v))
            grads.append(torch.where(bad, torch.zeros_like(g), g))
        grad = torch.stack(grads).reshape(x.shape)
        ctx.save_for_backward(grad)
        return torch.stack(vals).reshape(lead)

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return ct[..., None] * grad, None, None


def reverse_differentiable(f: Callable, *,
                           bad_value: float = -math.inf) -> Callable:
    """Route a scalar function's reverse-mode gradient through forward
    mode.

    The stiff integrator's adaptive loops are differentiated in forward
    mode; with 4 fitted parameters one primal solve carrying 4 tangents
    gives the exact gradient, which reverse-mode callers (the NUTS
    sampler, the LBFGS line search) receive through autograd.  ``x`` may
    carry leading batch axes; each row is its own solve.

    ``bad_value`` is the sentinel for points where the value or the
    gradient is non-finite: -inf (Stan rejection semantics) for
    maximized log densities, +inf for minimized losses
    (``map_fit.lbfgs_minimize``), where -inf would read to a line search
    as a perfect step.
    """

    def g(x: torch.Tensor) -> torch.Tensor:
        return _FwdGrad.apply(x, f, bad_value)

    return g
