"""Multistart MAP fitting (Sobol global stage + projected LBFGS).

Counterpart of ``gab1_shp2_tpu/inference/map_fit.py``, which replaces
the reference's ``TikTak(101) + NLopt.LD_LBFGS`` two-stage fit
(``param_fitting+inference_finitediff.jl:254-266``):

  * global stage: Sobol points over the log-space box, solved together
    as the lanes of one ``solve_stiff_batch`` call (the JAX package
    ``vmap``s the single-member solve; the lanes are the same
    independent adaptive solves),
  * local stage: LBFGS with a zoom line search from the best starts,
    gradients by forward mode through the stiff solve,
  * a refinement at a finer dr, as the reference's dr=0.2 -> dr=0.1.

The LBFGS is the algorithm of ``optax.lbfgs()`` with its defaults
(memory 10, the scaled initial inverse Hessian, the capped first step,
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")`` with optax's constants), so the iterates
track the JAX package's.  ``torch.optim.LBFGS`` runs inner iterations
and another line search and would not.  Bounds are +-``decades``
around the baseline in log space (``:180-184``), enforced by projection.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
from scipy.stats import qmc

from gab1_shp2_tpu_torch.inference.loss import (
    FIT_NAMES,
    chi2_loss,
    make_observable_fn,
    reverse_differentiable,
    set_fitted,
)
from gab1_shp2_tpu_torch.ops.fwdgrad import value_and_fwd_grad


class FitResult(NamedTuple):
    log_k4: np.ndarray      # best point (log space)
    values: dict            # name -> fitted value
    loss: float
    starts: np.ndarray      # global-stage points
    start_losses: np.ndarray


def fwd_value_and_grad(f: Callable) -> Callable:
    """value_and_grad by forward mode: one pass of ``f`` carrying one
    tangent per coordinate (the integrator's loops have no reverse
    rule, and with 4 parameters forward mode is cheaper anyway)."""

    def vg(x):
        return value_and_fwd_grad(f, x)

    return vg


# --- the zoom line search of optax.scale_by_zoom_linesearch ---------------

_MAX_LS_STEPS = 20
_SLOPE_RTOL = 1e-4        # sufficient decrease (Armijo) constant
_CURV_RTOL = 0.9          # curvature constant
_APPROX_DEC_RTOL = 1e-6   # approximate-decrease relative tolerance
_INTERVAL_THRESHOLD = 1e-5
_INCREASE_FACTOR = 2.0


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc**2 * r0 + (-(db**2)) * r1) / denom
    B = ((-(dc**3)) * r0 + db**3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
    err = np.minimum(np.maximum(approx, delta), err)
    err = np.maximum(err, 0.0)
    return np.inf if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init), 0.0)
    return np.inf if np.isnan(err) else err


def _zoom_linesearch(vg, x, u, value, grad):
    """Step size along ``u`` from ``x`` by optax's zoom line search
    (Nocedal & Wright, Algorithms 3.5-3.6, with Hager-Zhang's approximate
    decrease).  Scalars are float64 numpy values (IEEE semantics: a zero
    denominator gives inf/NaN, as in the JAX program).  Returns the
    accepted step size."""
    f64 = np.float64
    slope0 = f64(torch.sum(u * grad))
    value0 = f64(value)
    s = dict(count=0, stepsize=f64(0.0), value=value0, slope=slope0,
             dec=f64(np.inf), interval_found=False, done=False,
             failed=False, low=f64(0.0), value_low=value0,
             slope_low=slope0, high=f64(0.0), value_high=value0,
             slope_high=slope0, cubic_ref=f64(0.0),
             value_cubic_ref=value0, safe_stepsize=f64(0.0),
             safe_value=value0)

    def on_line(step):
        v, g = vg(x + float(step) * u)
        return f64(v), f64(torch.sum(g * u))

    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            it = s["count"]
            if not s["interval_found"]:
                # search an interval (Algorithm 3.5)
                new = f64(1.0) if it == 0 else \
                    _INCREASE_FACTOR * s["stepsize"]
                v, sl = on_line(new)
                dec = _decrease_error(new, v, sl, value0, slope0)
                curv = _curvature_error(sl, slope0)
                err = max(dec, curv)
                if dec <= 0.0:
                    s["safe_stepsize"], s["safe_value"] = new, v
                high_new = (dec > 0.0) or (v >= s["value"] and it > 0)
                low_new = (sl >= 0.0) and not high_new
                prev = (s["stepsize"], s["value"], s["slope"])
                if low_new:
                    lo, hi = (new, v, sl), prev
                else:
                    lo, hi = prev, (new, v, sl)
                s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                         high=hi[0], value_high=hi[1], slope_high=hi[2],
                         cubic_ref=lo[0], value_cubic_ref=lo[1])
                s["interval_found"] = high_new or low_new or err <= 0.0
                s["done"] = err <= 0.0
                s["failed"] = (it + 1 >= _MAX_LS_STEPS) and not s["done"]
            else:
                # zoom into the interval (Algorithm 3.6)
                low, high = s["low"], s["high"]
                delta = np.abs(high - low)
                left, right = min(high, low), max(high, low)
                mid_c = _cubicmin(low, s["value_low"], s["slope_low"], high,
                                  s["value_high"], s["cubic_ref"],
                                  s["value_cubic_ref"])
                mid_q = _quadmin(low, s["value_low"], s["slope_low"], high,
                                 s["value_high"])
                if left + 0.2 * delta < mid_c < right - 0.2 * delta:
                    mid = mid_c
                elif left + 0.1 * delta < mid_q < right - 0.1 * delta:
                    mid = mid_q
                else:
                    mid = (low + high) / 2.0
                v, sl = on_line(mid)
                dec = _decrease_error(mid, v, sl, value0, slope0)
                curv = _curvature_error(sl, slope0)
                err = max(dec, curv)
                if dec <= 0.0 and v < s["safe_value"]:
                    s["safe_stepsize"], s["safe_value"] = mid, v
                s["done"] = err <= 0.0
                high_mid = (dec > 0.0) or (v >= s["value_low"])
                high_low = (sl * (high - low) >= 0.0) and not high_mid
                lo = (low, s["value_low"], s["slope_low"])
                hi = (high, s["value_high"], s["slope_high"])
                new_hi = (mid, v, sl) if high_mid else hi
                new_hi = lo if high_low else new_hi
                new_lo = lo if high_mid else (mid, v, sl)
                cref = hi if (high_mid or high_low) else lo
                s.update(low=new_lo[0], value_low=new_lo[1],
                         slope_low=new_lo[2], high=new_hi[0],
                         value_high=new_hi[1], slope_high=new_hi[2],
                         cubic_ref=cref[0], value_cubic_ref=cref[1])
                too_small = delta <= _INTERVAL_THRESHOLD
                s["failed"] = (((it + 1 >= _MAX_LS_STEPS)
                                or (too_small and s["safe_stepsize"] > 0.0))
                               and not s["done"])
                new = mid
            s.update(count=it + 1, stepsize=new, value=v, slope=sl,
                     dec=dec)
            if s["failed"] and (s["safe_stepsize"] > 0.0
                                or np.isinf(s["dec"])):
                # fall back to the best step with sufficient decrease
                s["stepsize"] = s["safe_stepsize"]
    return s["stepsize"]


# --- LBFGS ------------------------------------------------------------------

_MEMORY = 10  # optax.lbfgs's memory_size

def _lbfgs_direction(grad, dw, du, rho, idx0, identity_scale):
    """The two-loop recursion: ``P_k grad`` from the memory buffers
    (Nocedal & Wright, Algorithm 7.4)."""
    m = rho.shape[0]
    order = [(idx0 + j) % m for j in range(m)]
    vec = grad
    alphas = {}
    for i in reversed(order):
        alphas[i] = rho[i] * torch.sum(dw[i] * vec)
        vec = vec + (-alphas[i]) * du[i]
    vec = identity_scale * vec
    for i in order:
        beta = rho[i] * torch.sum(du[i] * vec)
        vec = vec + (alphas[i] - beta) * dw[i]
    return vec


def lbfgs_minimize(f: Callable, x0: torch.Tensor, *, max_iters: int = 30,
                   lb=None, ub=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected LBFGS with optax's zoom line search; ``max_iters``
    iterations from ``x0``.  Returns ``(x, f(x))``; ``x`` is on ``x0``'s
    device and dtype.

    ``f`` is wrapped in :func:`reverse_differentiable` with a +inf
    sentinel: a failed solve must look like a rejected trial step to the
    line search, not a perfect one.
    """
    fr = reverse_differentiable(f, bad_value=math.inf)

    def vg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = fr(x)
            (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    x = x0.detach().clone()
    n = x.shape[-1]
    zeros = dict(dtype=x.dtype, device=x.device)
    dw = torch.zeros((_MEMORY, n), **zeros)
    du = torch.zeros((_MEMORY, n), **zeros)
    rho = torch.zeros((_MEMORY,), **zeros)
    prev_x, prev_g = torch.zeros_like(x), torch.zeros_like(x)
    lo = None if lb is None else torch.as_tensor(lb, **zeros)
    hi = None if ub is None else torch.as_tensor(ub, **zeros)
    for count in range(max_iters):
        val, grad = vg(x)
        # memory update with the newest differences (none at count 0)
        idx = count % _MEMORY
        prev = (count - 1) % _MEMORY
        if count > 0:
            d_w, d_u = x - prev_x, grad - prev_g
            vdot = torch.sum(d_u * d_w)
            dw[prev], du[prev] = d_w, d_u
            rho[prev] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            denom = torch.sum(d_u * d_u)
            scale = torch.where(denom > 0.0, vdot / denom, 1.0)
        else:
            # the first step's trust region: a capped reciprocal of the
            # gradient norm
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad),
                                max=1.0)
        direction = -_lbfgs_direction(grad, dw, du, rho, idx, scale)
        prev_x, prev_g = x, grad
        step = _zoom_linesearch(vg, x, direction, val, grad)
        x = x + float(step) * direction
        if lo is not None:
            x = torch.minimum(torch.maximum(x, lo), hi)
    return x, f(x)


def map_fit(
    *,
    base=None,
    Co=None,
    system=None,
    device=None,
    n_starts: int = 101,
    n_local: int = 8,
    decades: float = 2.0,
    max_iters: int = 30,
    dr_coarse: float = 0.2,
    dr_fine: float = 0.1,
    rtol: float = 1e-4,
    seed: int = 123,
) -> FitResult:
    """Two-stage multistart MAP fit of (kG1p, kG1dp, kSa, kSi).

    Stage 1: ``n_starts`` Sobol points at ``dr_coarse`` (the same
    scrambled sequence as the JAX package's: ``qmc.Sobol(4,
    scramble=True, rng=default_rng(seed))``), solved as one batch; LBFGS
    from the ``n_local`` best.  Stage 2: LBFGS refinement of the winner
    at ``dr_fine`` (reference structure, ``:254-266``).  ``device=None``
    runs on the CUDA card.
    """
    from gab1_shp2_tpu_torch.models.observables import pct_shp2_bound_gab1
    from gab1_shp2_tpu_torch.models.params import (
        Params,
        default_co,
        default_params,
        resolve_device,
    )
    from gab1_shp2_tpu_torch.models.system import base_system
    from gab1_shp2_tpu_torch.ops.batch_stiff import solve_stiff_batch

    dev = resolve_device(device)
    system = system or base_system()
    Co = default_co(device=dev) if Co is None else torch.as_tensor(
        Co, device=dev)
    base = (default_params(fit="prior", dtype=Co.dtype, device=dev)
            if base is None else base.to(dtype=Co.dtype, device=dev))
    center = torch.log(torch.stack([getattr(base, n) for n in FIT_NAMES]))
    lb = center - decades * math.log(10.0)
    ub = center + decades * math.log(10.0)
    lb_np, ub_np = lb.cpu().numpy(), ub.cpu().numpy()

    # global stage: every start a lane of one batched solve (the
    # observable's configuration: trbdf2, tf=5, atol 1e-7, Nts=2)
    sampler = qmc.Sobol(4, scramble=True, rng=np.random.default_rng(seed))
    u = sampler.random(n_starts)
    starts = lb_np + u * (ub_np - lb_np)
    S = torch.as_tensor(starts, dtype=Co.dtype, device=dev)
    pb = set_fitted(Params(D=base.D.expand(n_starts, -1),
                           k=base.k.expand(n_starts, -1)), S)
    sol = solve_stiff_batch(system, Co, pb, device=dev, dr=dr_coarse,
                            tf=5.0, Nts=2, rtol=rtol, atol=1e-7,
                            method="trbdf2")
    y = pct_shp2_bound_gab1(sol, Co, 10.0)
    start_losses = chi2_loss(lambda q: y, S).cpu().numpy()
    order = np.argsort(start_losses)

    # local stage from the best starts
    obs_c = make_observable_fn(system, Co, base, device=dev, dr=dr_coarse,
                               rtol=rtol)

    def f_c(x):
        return chi2_loss(obs_c, x)

    best_x, best_v = None, np.inf
    for i in order[:n_local]:
        x, v = lbfgs_minimize(f_c, S[i], max_iters=max_iters, lb=lb, ub=ub)
        if float(v) < best_v and np.isfinite(float(v)):
            best_x, best_v = x, float(v)

    # refinement at the finer resolution
    obs_f = make_observable_fn(system, Co, base, device=dev, dr=dr_fine,
                               rtol=rtol)

    def f_f(x):
        return chi2_loss(obs_f, x)

    x_fin, v_fin = lbfgs_minimize(f_f, best_x, max_iters=max_iters, lb=lb,
                                  ub=ub)
    if not np.isfinite(float(v_fin)) or float(v_fin) > best_v:
        x_fin, v_fin = best_x, best_v

    x_np = x_fin.detach().cpu().numpy()
    vals = {n: float(np.exp(x_np)[j]) for j, n in enumerate(FIT_NAMES)}
    return FitResult(log_k4=x_np, values=vals, loss=float(v_fin),
                     starts=np.asarray(starts), start_losses=start_losses)
