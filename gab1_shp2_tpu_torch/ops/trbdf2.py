"""The single-member adaptive stiff integrator, its constants and the
shared Rosenbrock (ROW) step.

Counterpart of ``gab1_shp2_tpu/ops/trbdf2.py`` (see it for the method
citations): adaptive TRBDF2 with a Newton loop, Rosenbrock23 and
RODAS3/RODAS4, all on W = I - c*h*J with the structure-aware Jacobian
bands and block cyclic reduction (``ops/cyclic_reduction.py``), a
standard step-size controller and cubic Hermite dense output.

The JAX ``while_loop``s are host loops here.  Their conditions read
primal values (``bool(...)``) while all arithmetic stays on tensors, so
``torch.func.jvp`` and ``vmap`` over tangents differentiate a solve
the way JAX's ``jvp`` of ``while_loop`` does: the tangents flow through
``y``, ``t`` and ``h`` (the controller's ``errn ** e`` and its clip,
the Hermite weights ``(ts - t) / h``).  Nothing on the value path
leaves the tensor world (no ``float(t)``, ``.item()`` or ``.detach()``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gab1_shp2_tpu_torch.models.params import Params, resolve_device
from gab1_shp2_tpu_torch.models.species import N_CYTO, N_MEMB
from gab1_shp2_tpu_torch.models.system import ReactionDiffusionSystem
from gab1_shp2_tpu_torch.ops import rhs as rhs_mod
from gab1_shp2_tpu_torch.ops.cyclic_reduction import cr_factor, cr_solve
from gab1_shp2_tpu_torch.ops.jacobian import (
    blocks_to_state,
    fast_block_jacobian_lanes,
    state_to_blocks,
)
from gab1_shp2_tpu_torch.ops.rhs import MolState, initial_state, kdict
from gab1_shp2_tpu_torch.ops.solution import Solution

GAMMA = 2.0 - math.sqrt(2.0)
A = GAMMA / 2.0  # shared implicit coefficient of both TRBDF2 stages
# BDF2-stage combination coefficients
_C_YG = 1.0 / (GAMMA * (2.0 - GAMMA))
_C_YN = (1.0 - GAMMA) ** 2 / (GAMMA * (2.0 - GAMMA))
# third-order embedded weights (order conditions at c = (0, gamma, 1))
_B2 = 1.0 / (6.0 * GAMMA * (1.0 - GAMMA))
_B3 = 0.5 - 1.0 / (6.0 * (1.0 - GAMMA))
_B1 = 1.0 - _B2 - _B3

# Rosenbrock23 (Shampine-Reichelt ode23s) W-method coefficients
_ROS_D = 1.0 / (2.0 + math.sqrt(2.0))
_ROS_E32 = 6.0 + math.sqrt(2.0)

# Transformed Hairer-Wanner Rosenbrock tableaus.  Stage i:
#   (I - h*g*J) u_i = h*g*f(y + sum_{j<i} A[i][j] u_j)
#                     + g*sum_{j<i} C[i][j] u_j
#   y1 = y + sum_i M[i] u_i;  err = sum_i E[i] u_i
_ROW_TABLEAUS = {
    "rodas3": dict(
        g=0.5,
        A=((), (0.0,), (2.0, 0.0), (2.0, 0.0, 1.0)),
        C=((), (4.0,), (1.0, -1.0), (1.0, -1.0, -8.0 / 3.0)),
        M=(2.0, 0.0, 1.0, 1.0),
        E=(0.0, 0.0, 0.0, 1.0),
        est_order=2,
    ),
    "rodas4": dict(
        g=0.25,
        A=((),
           (1.544000000000000,),
           (0.9466785280815826, 0.2557011698983284),
           (3.314825187068521, 2.896124015972201, 0.9986419139977817),
           (1.221224509226641, 6.019134481288629, 12.53708332932087,
            -0.6878860361058950),
           (1.221224509226641, 6.019134481288629, 12.53708332932087,
            -0.6878860361058950, 1.0)),
        C=((),
           (-5.668800000000000,),
           (-2.430093356833875, -0.2063599157091915),
           (-0.1073529058151375, -9.594562251023355, -20.47028614809616),
           (7.496443313967647, -10.24680431464352, -33.99990352819905,
            11.70890893206160),
           (8.083246795921522, -7.981132988064893, -31.52159432874371,
            16.31930543123136, -6.058818238834054)),
        M=(1.221224509226641, 6.019134481288629, 12.53708332932087,
           -0.6878860361058950, 1.0, 1.0),
        E=(0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
        est_order=3,
    ),
}


def _row_step(tab, factor, solve, f, y, f_n, h, Lj, Dj, Uj, eye, ls_dtype):
    """One transformed-Rosenbrock step: factor W = I - g*h*J once, then
    one back-solve per stage.  ``h`` is the pair ``(h_band, h_state)``
    broadcastable against the bands and the state.  Returns
    ``(y_1, est)``; f(y_1) is not computed (dense output does it lazily).
    """
    hb, hd = h
    g = tab["g"]
    fac = factor(-g * hb * Lj, eye - g * hb * Dj.to(ls_dtype), -g * hb * Uj)
    us = []
    # cache f by the stage-argument coefficient signature: RODAS3's
    # second stage argument is y itself, so its f is f_n
    f_cache = {(): f_n}
    for i in range(len(tab["M"])):
        sig = tuple(tab["A"][i])
        while sig and sig[-1] == 0.0:
            sig = sig[:-1]
        if sig not in f_cache:
            arg = y
            for j, a in enumerate(sig):
                if a != 0.0:
                    arg = arg + a * us[j]
            f_cache[sig] = f(arg)
        rhs_i = g * hd * f_cache[sig]
        for j, c in enumerate(tab["C"][i]):
            if c != 0.0:
                rhs_i = rhs_i + (g * c) * us[j]
        us.append(solve(fac, rhs_i))
    y_1 = y
    est = torch.zeros_like(y)
    for m_i, e_i, u_i in zip(tab["M"], tab["E"], us):
        if m_i != 0.0:
            y_1 = y_1 + m_i * u_i
        if e_i != 0.0:
            est = est + e_i * u_i
    return y_1, est


class StiffStats(NamedTuple):
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    failed: torch.Tensor


def _rhs_blocks_fn(system: ReactionDiffusionSystem, R: float, dr: float):
    """The MoL right-hand side on the (NB, 10) block layout, and the
    float64 radial grid."""
    rhs, r = rhs_mod.make_mol_rhs(system, R, dr)

    def f(y_blocks: torch.Tensor, params: Params) -> torch.Tensor:
        C_int, m = blocks_to_state(y_blocks)
        dy = rhs(MolState(C_int=C_int, m=m), params)
        return state_to_blocks(dy.C_int, dy.m)

    return f, r


def _solve_stiff_impl(system, Co, params, legs, R, dr, Nts, rtol, atol,
                      max_steps, h0, method, linsolve_dtype):
    if method not in ("trbdf2", "rosenbrock23", *_ROW_TABLEAUS):
        raise ValueError(f"unknown method {method!r}")
    dtype, dev = Co.dtype, Co.device
    Nr = int(round(R / dr))
    NB = Nr
    f_blocks, r = _rhs_blocks_fn(system, R, dr)
    tf_total = legs[-1][1]
    dt_save = tf_total / Nts
    eps = 1e-10 * tf_total

    y0_state = initial_state(Co, Nr)
    y0 = state_to_blocks(y0_state.C_int, y0_state.m)

    ls_dtype = linsolve_dtype if linsolve_dtype else dtype
    # W is formed in the state dtype from the (ls_dtype) bands and cast
    # by the factorization, as in the JAX package (whose f64 step size
    # promotes the bands' products)
    eye = torch.eye(N_CYTO, dtype=dtype, device=dev).expand(NB, N_CYTO,
                                                             N_CYTO)

    def factor(L, D, U):
        return cr_factor(L.to(ls_dtype), D.to(ls_dtype), U.to(ls_dtype))

    def solve(fac, b):
        # mixed precision: factor and solve in ls_dtype, state and
        # residuals in the trajectory dtype
        return cr_solve(fac, b.to(ls_dtype)).to(dtype)

    ntol = 0.03      # Newton tolerance in scaled-error units
    newton_iters = 6
    e_exp = -1.0 / 4.0 if method == "rodas4" else -1.0 / 3.0

    def snapshot(y_blocks, p: Params):
        C_int, m = blocks_to_state(y_blocks)
        C_full = rhs_mod.full_profile(
            system, MolState(C_int=C_int, m=m), kdict(p.k),
            rhs_mod.effective_diffusivities(system, p), dr)
        return C_full, m

    def scaled_norm(v, y_a, y_b):
        w = atol + rtol * torch.maximum(y_a.abs(), y_b.abs())
        return torch.sqrt(torch.mean((v / w) ** 2))

    def bands(y, p: Params):
        # the structure-aware builder with a unit lane axis, natively in
        # ls_dtype when the linear algebra runs narrower than the state
        p1 = Params(D=p.D[None].to(ls_dtype), k=p.k[None].to(ls_dtype))
        Lj, Dj, Uj = fast_block_jacobian_lanes(
            system, y[..., None].to(ls_dtype), p1, r, dr)
        return Lj[..., 0].to(dtype), Dj[..., 0].to(dtype), Uj[..., 0].to(dtype)

    C0, m0 = snapshot(y0, legs[0][2])
    nanC = torch.full_like(C0, float("nan"))
    nanm = torch.full_like(m0, float("nan"))
    out_C = [C0] + [nanC] * Nts
    out_m = [m0] + [nanm] * Nts

    t = torch.zeros((), dtype=dtype, device=dev)
    h = torch.full((), h0, dtype=dtype, device=dev)
    y = y0
    nts, nacc, nrej, failed = 1, 0, 0, False
    for (t0, t1, p) in legs:
        def f(yb, p=p):
            return f_blocks(yb, p)

        def newton(fac, y_init, rhs_const, h):
            yk, converged, it = y_init, False, 0
            while it < newton_iters and not converged:
                Gv = yk - A * h * f(yk) - rhs_const
                dy = solve(fac, -Gv)
                yk = yk + dy
                converged = bool(scaled_norm(dy, yk, yk) <= ntol)
                it += 1
            return yk, converged

        t = torch.maximum(t, torch.as_tensor(t0, dtype=dtype, device=dev))
        while (bool(t < t1 - eps) and not failed
               and nacc + nrej < max_steps):
            h = torch.minimum(h, t1 - t)
            f_n = f(y)
            Lj, Dj, Uj = bands(y, p)

            if method == "trbdf2":
                fac = factor(-A * h * Lj, eye - A * h * Dj, -A * h * Uj)
                # TR stage to t + gamma*h
                rc1 = y + A * h * f_n
                y_g, ok1 = newton(fac, y + GAMMA * h * f_n, rc1, h)
                f_g = (y_g - rc1) / (A * h)
                # BDF2 stage to t + h
                rc2 = _C_YG * y_g - _C_YN * y
                y_1, ok2 = newton(fac, y_g, rc2, h)
                f_1 = (y_1 - rc2) / (A * h)
                # embedded third-order estimate, stiffly filtered
                y_hat = y + h * (_B1 * f_n + _B2 * f_g + _B3 * f_1)
                est = solve(fac, y_1 - y_hat)
                errn = scaled_norm(est, y, y_1)
                ok = ok1 and ok2
            elif method == "rosenbrock23":
                d = _ROS_D
                fac = factor(-d * h * Lj, eye - d * h * Dj, -d * h * Uj)
                k1 = solve(fac, f_n)
                f_half = f(y + 0.5 * h * k1)
                k2 = solve(fac, f_half - k1) + k1
                y_1 = y + h * k2
                f_1 = f(y_1)
                k3 = solve(fac, f_1 - _ROS_E32 * (k2 - f_half)
                           - 2.0 * (k1 - f_n))
                est = (h / 6.0) * (k1 - 2.0 * k2 + k3)
                errn = scaled_norm(est, y, y_1)
                ok = bool(torch.isfinite(errn))
            else:
                # the bands are already in the state dtype, so the
                # step's Dj.to(...) is the identity, as in the JAX step
                y_1, est = _row_step(_ROW_TABLEAUS[method], factor, solve,
                                     f, y, f_n, (h, h), Lj, Dj, Uj, eye,
                                     dtype)
                errn = scaled_norm(est, y, y_1)
                ok = bool(torch.isfinite(errn))
                # RODAS never needs f(y_1); dense output evaluates it
                # lazily, only on steps that cross a save point
                f_1 = None

            accept = ok and bool(errn <= 1.0)
            t_new = t + h if accept else t

            # asymptotic controller, exponent -1/(q+1) for the embedded
            # estimator's order q
            if accept:
                fac_h = torch.clamp(0.9 * errn ** e_exp, 0.2, 4.0)
            elif ok:
                fac_h = torch.clamp(0.9 * errn ** e_exp, 0.1, 0.5)
            else:
                fac_h = torch.full_like(h, 0.3)
            h_new = h * fac_h
            if not bool(torch.isfinite(h_new)):
                h_new = h * 0.3
            failed = failed or bool(h_new < 1e-13 * tf_total)

            # dense-output snapshots for save points inside (t, t_new]
            if accept:
                def crosses(i):
                    # the save time in the state's dtype, as ``ts``
                    # below: a float32 t_new that stops at float32(tf)
                    # still reaches the last save
                    return (i <= Nts
                            and float(torch.as_tensor(i * dt_save,
                                                      dtype=dtype))
                            <= float(t_new) + eps)

                if crosses(nts):
                    f_end = f(y_1) if f_1 is None else f_1
                while crosses(nts):
                    ts = torch.as_tensor(nts * dt_save, dtype=dtype,
                                         device=dev)
                    th = ((ts - t) / h if bool(h > 0)
                          else torch.zeros_like(h))
                    h00 = 2 * th**3 - 3 * th**2 + 1
                    h10 = th**3 - 2 * th**2 + th
                    h01 = -2 * th**3 + 3 * th**2
                    h11 = th**3 - th**2
                    y_s = (h00 * y + h10 * h * f_n + h01 * y_1
                           + h11 * h * f_end)
                    out_C[nts], out_m[nts] = snapshot(y_s, p)
                    nts += 1
                y = y_1
                nacc += 1
            else:
                nrej += 1
            t, h = t_new, h_new
    failed = failed or nts <= Nts  # not every snapshot written

    t_save = torch.linspace(0.0, tf_total, Nts + 1,
                            dtype=torch.float64).to(dtype=dtype, device=dev)
    sol = Solution(C=torch.stack(out_C), m=torch.stack(out_m), t=t_save,
                   r=r.to(dtype=dtype, device=dev), CoEGFR=Co[4])
    i32 = dict(dtype=torch.int32, device=dev)
    stats = StiffStats(n_accepted=torch.tensor(nacc, **i32),
                       n_rejected=torch.tensor(nrej, **i32),
                       failed=torch.tensor(failed, device=dev))
    return sol, stats


def solve_stiff(
    system: ReactionDiffusionSystem,
    Co,
    params: Params,
    *,
    device=None,
    R: float = 10.0,
    dr: float = 0.1,
    tf: float = 5.0,
    Nts: int = 100,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    max_steps: int = 20_000,
    h0: float = 1e-5,
    t_prechase: Optional[float] = None,
    return_stats: bool = False,
    method: str = "trbdf2",
    linsolve_dtype=None,
):
    """Stiff MoL solve of one member: adaptive TRBDF2 (default),
    Rosenbrock23, or RODAS3/RODAS4.

    ``method="rosenbrock23"`` is the linearly implicit W-method (no
    Newton iteration); ``"rodas3"``/``"rodas4"`` the order-3/4
    L-stable Rosenbrock tableaus; ``"trbdf2"`` the Newton-based
    L-stable method.  ``linsolve_dtype=torch.float32`` runs the
    Jacobian bands, factorizations and back-solves in float32 with the
    state and residuals in ``Co``'s dtype.  ``t_prechase`` runs the
    gefitinib pulse-chase as two integration legs with ``kp`` zeroed in
    the second.  ``device=None`` runs on the CUDA card (and raises if
    there is none).

    Differentiable by ``torch.func.jvp``/``jacfwd`` in ``params`` (not
    by reverse mode through the step loop).  Returns a
    :class:`Solution` (and :class:`StiffStats` when ``return_stats``);
    a failed solve carries NaN snapshots and ``stats.failed``.
    """
    dev = resolve_device(device)
    Co = torch.as_tensor(Co, device=dev)
    params = params.to(dtype=Co.dtype, device=dev)
    if t_prechase is None:
        legs = ((0.0, float(tf), params),)
    else:
        legs = ((0.0, float(t_prechase), params),
                (float(t_prechase), float(tf), params.replace(kp=0.0)))
    sol, stats = _solve_stiff_impl(system, Co, params, legs, float(R),
                                   float(dr), int(Nts), rtol, atol,
                                   int(max_steps), float(h0), method,
                                   linsolve_dtype)
    if return_stats:
        return sol, stats
    return sol
