"""Explicit FTCS stepper with semi-implicit membrane coupling.

Counterpart of ``gab1_shp2_tpu/ops/explicit.py``: the *parity* path that
reproduces the reference's hand-rolled explicit scheme
(``basepdesolver.jl:25-312``) step for step —

  1. forward-Euler update of all bulk species at interior nodes from the
     previous step's profile (``basepdesolver.jl:150-180``),
  2. zero-flux copy at r = 0 (``:182-192``),
  3. a fixed-point loop coupling the Robin boundary values at r = R with
     an explicit-Euler update of the 8 membrane ODEs, iterated until the
     max relative change drops below ``tol`` or ``maxiters`` is reached
     (``:197-242``; NaN relative errors keep iterating, as in the
     reference where ``error <= tol`` is false for NaN),
  4. state rotation and snapshot capture whenever accumulated time
     crosses the next save threshold (``:244-295``).

The JAX package batches this solver with ``jax.vmap``; here the batch is
written out: every array carries a leading member axis (B,), ``dt`` and
``nt_active`` are (B,) tensors, and the step count ``n_steps`` is shared.
Members whose own step count is exhausted stop evolving, and a member
whose fixed point has converged is frozen while the others iterate (what
``vmap`` of a ``while_loop`` does), so a member's result does not depend
on who shares its batch.

The time loop is a host loop of small eager ops; the fixed-point loop
reads one device-side reduction per iteration.  The fused final-state
solve in one kernel launch is ``ops/explicit_cuda.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gab1_shp2_tpu_torch.models.params import (
    Params,
    resolve_device,
    stability_dt,
)
from gab1_shp2_tpu_torch.models.species import K_NAMES, N_CYTO, N_MEMB
from gab1_shp2_tpu_torch.models.system import ReactionDiffusionSystem
from gab1_shp2_tpu_torch.ops.rhs import (
    bc_closure,
    bulk_rates,
    effective_diffusivities,
    initial_state,
    kdict,
    laplacian,
    memb_rates,
)
from gab1_shp2_tpu_torch.ops.solution import Solution

_KP_IDX = K_NAMES.index("kp")


def uniform_initial_profile(Co: torch.Tensor, Nr: int, B: int):
    """The initial state of ``B`` members: ``C`` (B, 10, Nr+1) uniform in
    r, and ``m`` (B, 8) (``basepdesolver.jl:94-97,137-141``)."""
    y0 = initial_state(Co, Nr)
    C0 = torch.cat([y0.C_int[:, :1], y0.C_int, y0.C_int[:, -1:]], dim=1)
    return (C0[None].repeat(B, 1, 1), y0.m[None].repeat(B, 1))


def _membrane_fixed_point(system, C_near, m_prev, guess_CR, guess_m, k,
                          d_eff, dr, dt, maxiters, tol):
    """The semi-implicit membrane/boundary fixed point of one time step,
    for all members: (B, 10) boundary values and (B, 8) membrane states.
    A member stops iterating once its own relative change is <= tol."""
    C_R, m_it = guess_CR, guess_m
    err = torch.full_like(dt, float("inf"))
    for _ in range(maxiters):
        # NaN err (0/0 relative change) must keep iterating, as in the
        # reference's `if error <= tol break` (basepdesolver.jl:239)
        todo = ~(err <= tol)
        if not bool(todo.any()):
            break
        C_R_new = bc_closure(system, C_near, m_it, k, d_eff, dr)
        m_new = m_prev + dt[:, None] * memb_rates(system, m_prev, C_R_new, k)
        new = torch.cat([C_R_new, m_new], dim=-1)
        old = torch.cat([C_R, m_it], dim=-1)
        err_new = torch.amax(torch.abs(1.0 - new / old), dim=-1)
        C_R = torch.where(todo[:, None], C_R_new, C_R)
        m_it = torch.where(todo[:, None], m_new, m_it)
        err = torch.where(todo, err_new, err)
    return C_R, m_it


def _solve_explicit_impl(system, Co, params, dt, nt_active, R, dr, tf, Nts,
                         n_steps, maxiters, tol, t_prechase):
    dtype, dev = Co.dtype, Co.device
    B = params.k.shape[0]
    Nr = int(round(R / dr))
    r = torch.arange(Nr + 1, dtype=dtype, device=dev) * dr
    dt_save = tf / Nts

    k_vec = params.k
    d_eff = effective_diffusivities(system, params)          # (B, 10)
    k_memb = kdict(k_vec)                                     # name -> (B,)
    k_bulk = kdict(k_vec[:, None, :])                         # name -> (B, 1)

    C, m = uniform_initial_profile(Co, Nr, B)
    out_C = torch.zeros((B, Nts + 1, N_CYTO, Nr + 1), dtype=dtype, device=dev)
    out_m = torch.zeros((B, Nts + 1, N_MEMB), dtype=dtype, device=dev)
    t_out = torch.zeros((B, Nts + 1), dtype=dtype, device=dev)
    out_C[:, 0], out_m[:, 0] = C, m

    gCR = torch.zeros((B, N_CYTO), dtype=dtype, device=dev)
    gm = torch.zeros((B, N_MEMB), dtype=dtype, device=dev)
    t = torch.zeros(B, dtype=dtype, device=dev)
    t_save = torch.full((B,), dt_save, dtype=dtype, device=dev)
    nts = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    nt_host = nt_active.cpu().numpy()
    dt3 = dt[:, None, None]

    for i in range(n_steps):
        # members whose own step count is exhausted stop evolving
        if i >= nt_host.max():
            break
        all_active = i < nt_host.min()
        active = None if all_active else (i < nt_active)

        # gefitinib pulse-chase event: zero kp from the first step whose
        # start time has crossed t_prechase (pulsechase_solver.jl:156-158)
        if t_prechase is not None:
            kp_on = (t < t_prechase).to(dtype)
            k_eff = torch.cat(
                [k_vec[:, :_KP_IDX], (k_vec[:, _KP_IDX] * kp_on)[:, None],
                 k_vec[:, _KP_IDX + 1:]], dim=1)
            k_memb, k_bulk = kdict(k_eff), kdict(k_eff[:, None, :])

        lap = laplacian(system, C, r, dr)
        C_int_old = C[:, :, 1:-1]
        rates = bulk_rates(system, C_int_old.movedim(1, 0), k_bulk)
        Cn_int = C_int_old + dt3 * (d_eff[:, :, None] * lap
                                    + rates.movedim(0, 1))
        C_near = Cn_int[:, :, -1]

        C_R, m_new = _membrane_fixed_point(
            system, C_near, m, gCR, gm, k_memb, d_eff, dr, dt, maxiters, tol)

        C_new = torch.cat([Cn_int[:, :, :1], Cn_int, C_R[:, :, None]], dim=2)
        t_new = t + dt

        # snapshot capture (basepdesolver.jl:268-295)
        pred = t_new >= t_save
        if active is not None:
            pred = pred & active
        idx = nts + pred.to(torch.int64)
        slot = idx.clamp(max=Nts)
        out_C[rows, slot] = torch.where(pred[:, None, None], C_new,
                                        out_C[rows, slot])
        out_m[rows, slot] = torch.where(pred[:, None], m_new,
                                        out_m[rows, slot])
        t_out[rows, slot] = torch.where(pred, t_new, t_out[rows, slot])
        t_save = t_save + pred.to(dtype) * dt_save
        nts = idx

        if active is None:
            C, m, gCR, gm, t = C_new, m_new, C_R, m_new, t_new
        else:
            a1, a2 = active[:, None], active[:, None, None]
            C = torch.where(a2, C_new, C)
            m = torch.where(a1, m_new, m)
            gCR = torch.where(a1, C_R, gCR)
            gm = torch.where(a1, m_new, gm)
            t = torch.where(active, t_new, t)

    return out_C, out_m, t_out, r


def solve_explicit(
    system: ReactionDiffusionSystem,
    Co,
    params: Params,
    *,
    device=None,
    R: float = 10.0,
    dr: float = 0.1,
    tf: float = 5.0,
    Nts: int = 100,
    dt=None,
    n_steps: Optional[int] = None,
    nt_active=None,
    maxiters: int = 100,
    tol: float = 1e-6,
    t_prechase: Optional[float] = None,
) -> Solution:
    """Run the explicit reference-parity solve.

    Defaults mirror ``pdesolver`` (``basepdesolver.jl:25-33``): stability
    step ``dt = 0.99/(2(max(D)/dr^2 + sum(k)/4))``, ``Nts`` snapshots.
    ``device=None`` runs on the CUDA card (and raises if there is none).

    ``params`` is one member or carries a leading batch axis (B,); the
    returned :class:`Solution` then has leading (B,) axes on ``C``, ``m``,
    ``t`` and ``CoEGFR`` (``r`` is shared).  For a batch, ``dt`` and
    ``nt_active`` are (B,) (default: each member's stability step and its
    own ``ceil(tf/dt)``) and ``n_steps`` is the shared loop length
    (default: the largest member count); a member beyond its own
    ``nt_active`` stops evolving.  ``t_prechase`` enables the gefitinib
    pulse-chase event.  The compute dtype follows ``Co`` (a float32
    ``Co`` selects the single-precision path).
    """
    dev = resolve_device(device)
    Co = torch.as_tensor(Co, device=dev)
    if Co.shape != (5,):
        raise ValueError(f"Co must have shape (5,), got {tuple(Co.shape)}")
    params = params.to(device=dev)
    batched = params.k.ndim == 2
    if params.k.ndim not in (1, 2):
        raise ValueError("params must be one member or a (B, ...) batch")
    if not batched:
        params = Params(D=params.D[None], k=params.k[None])
    B = params.k.shape[0]

    def per_member(x, dtype):
        # (a Python float would pass through float32 without the dtype)
        x = (x.to(device=dev, dtype=dtype) if torch.is_tensor(x)
             else torch.as_tensor(x, dtype=dtype, device=dev))
        return x.expand(B).contiguous() if x.ndim == 0 else x

    # dt comes from the parameters as given, before they are cast to the
    # compute dtype
    dt_own = stability_dt(params, dr) if dt is None else per_member(
        dt, torch.float64)
    own_counts = torch.ceil(tf / dt_own.double()).to(torch.int64)
    given_steps = n_steps is not None
    if not given_steps:
        n_steps = int(math.ceil(tf / float(dt_own.min())))
    if nt_active is None:
        nt_active = (torch.full((B,), n_steps, dtype=torch.int64, device=dev)
                     if given_steps else own_counts)
    else:
        nt_active = per_member(nt_active, torch.int64)

    out_C, out_m, t_out, r = _solve_explicit_impl(
        system, Co, params.to(dtype=Co.dtype), dt_own.to(Co.dtype), nt_active,
        float(R), float(dr), float(tf), int(Nts), int(n_steps),
        int(maxiters), tol, t_prechase)
    if batched:
        return Solution(C=out_C, m=out_m, t=t_out, r=r,
                        CoEGFR=Co[4].expand(B))
    return Solution(C=out_C[0], m=out_m[0], t=t_out[0], r=r, CoEGFR=Co[4])
