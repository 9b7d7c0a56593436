"""Batch-aware stiff ensemble integrator with lane-minor block linear algebra.

Counterpart of ``gab1_shp2_tpu/ops/batch_stiff.py``.  The ensemble (lane)
axis is the minor dimension of every array:

  * state ``y``: (NB, 10, B); Jacobian bands: (NB, 10, 10, B),
  * 10x10 block products, pivot-free Gauss-Jordan inverses and block
    cyclic reduction over the block-row axis,
  * per-lane adaptive control (step size, acceptance, failure flags) as
    (B,) vectors and ``torch.where`` masks.

The JAX ``while_loop``/``cond`` constructs become host loops whose
conditions are device-side reductions read by the host once per
iteration, each through ``utils.progress.host_read``.  Both schedulers
— the chunked :func:`solve_stiff_batch` and the lane-refill
:func:`solve_stiff_refill` — share one copy of the step arithmetic
(:class:`_SolverCtx`), so a member's step sequence does not depend on
the scheduler that runs it.

``step_impl`` names map onto the JAX package's: ``"torch"`` is JAX's
``"xla"`` (the unfused eager step) and ``"fused"`` is JAX's ``"pallas"``
(one launch of the hand-written CUDA kernel of ``ops/ros23_cuda.py`` per
step; on a CPU tensor its plain torch version).

``rhs_mixed`` (float64 states only) evaluates the right-hand side in
float32 pairs: ``"df32"`` with the compensated arithmetic of
``ops/rhs_df32.py`` (~2^-48 of the float64 RHS), ``True`` as a
jvp-corrected hi/lo split (~1e-7 floor).  The JAX package added both
because the TPU emulates float64; native float64 stays the default.

A solve started while ``utils.progress``'s recorder is on records, in
layers: the refill loop's ``iteration`` and ``harvest`` spans and its
counters, the ``step`` and its ``dense_output``, and the kernel-layer
pieces ``rhs``, ``bands``, ``factor`` and ``solve``.  Whether to record
is decided when the solve's :class:`_SolverCtx` is made; a solve that
is not recorded runs the plain methods and closures.

On a card, the RODAS and unfused Rosenbrock23 steps replay their body
(everything before the dense output's first host read) from a CUDA
graph (:class:`_StepGraph`), captured once per lane count, grid, dtypes,
method and tolerances and reused by later solves of that key; the
kernels, their order and their arithmetic are the eager step's.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from gab1_shp2_tpu_torch.models.params import Params, resolve_device
from gab1_shp2_tpu_torch.models.species import CYTO, MEMB, N_CYTO, N_MEMB
from gab1_shp2_tpu_torch.models.system import (
    Geometry,
    ReactionDiffusionSystem,
)
from gab1_shp2_tpu_torch.ops import fwdgrad
from gab1_shp2_tpu_torch.ops import rhs as rhs_mod
from gab1_shp2_tpu_torch.ops.jacobian import (
    BLK,
    interior_radii,
    lane_bands,
)
from gab1_shp2_tpu_torch.ops.rhs import kdict
from gab1_shp2_tpu_torch.ops.solution import Solution
from gab1_shp2_tpu_torch.ops.trbdf2 import (
    A,
    GAMMA,
    StiffStats,
    _B1,
    _B2,
    _B3,
    _C_YG,
    _C_YN,
    _ROS_D,
    _ROS_E32,
    _ROW_TABLEAUS,
    _row_step,
)
from gab1_shp2_tpu_torch.utils import progress
from gab1_shp2_tpu_torch.utils.progress import host_read

# ---------------------------------------------------------------------------
# lane-minor small linear algebra
# ---------------------------------------------------------------------------


def mm_lanes(Am: torch.Tensor, Bm: torch.Tensor) -> torch.Tensor:
    """Block matmul ``(..., i, j, B) @ (..., j, k, B) -> (..., i, k, B)``."""
    return torch.einsum("...ijb,...jkb->...ikb", Am, Bm)


def mv_lanes(Am: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block matvec ``(..., i, j, B) @ (..., j, B) -> (..., i, B)``."""
    return torch.sum(Am * x[..., None, :, :], dim=-2)


def gj_inv_lanes(Am: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan inverse of (..., n, n, B) stacks, lane-minor.

    Pivot-free with pivots clamped to +-1e-20 (f32) or +-1e-30 (f64): the
    matrices are diagonally dominant W matrices, and a garbage solve
    surfaces as a rejected step.
    """
    n = Am.shape[-3]
    eye = torch.eye(n, dtype=Am.dtype, device=Am.device)[:, :, None]
    M = torch.cat([Am, eye.expand(Am.shape)], dim=-2)   # (..., n, 2n, B)
    tiny = 1e-30 if Am.dtype == torch.float64 else 1e-20
    for k in range(n):
        piv = M[..., k:k + 1, k:k + 1, :]
        tiny_p = torch.full_like(piv, tiny)
        piv = torch.where(piv.abs() < tiny,
                          torch.where(piv < 0, -tiny_p, tiny_p), piv)
        row_k = M[..., k:k + 1, :, :] / piv
        factors = M[..., :, k:k + 1, :]
        M = M - factors * row_k
        M[..., k:k + 1, :, :] = row_k
    return M[..., :, n:, :]


# ---------------------------------------------------------------------------
# lane-minor block cyclic reduction
# ---------------------------------------------------------------------------


class CRLanesLevel(NamedTuple):
    Dinv_odd: torch.Tensor
    L_odd: torch.Tensor
    U_odd: torch.Tensor
    LDinv: torch.Tensor
    UDinv: torch.Tensor


class CRLanesFactors(NamedTuple):
    levels: tuple
    root_inv: torch.Tensor


def _shift_down(a: torch.Tensor) -> torch.Tensor:
    """``out[i] = a[i-1]``, ``out[0] = 0`` along the block axis."""
    return torch.cat([torch.zeros_like(a[:1]), a[:-1]], dim=0)


def _shift_up(a: torch.Tensor) -> torch.Tensor:
    """``out[i] = a[i+1]``, ``out[-1] = 0`` along the block axis."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])], dim=0)


def cr_factor_lanes(L: torch.Tensor, D: torch.Tensor, U: torch.Tensor
                    ) -> CRLanesFactors:
    """Factor block-tridiagonal stacks of shape (NB, n, n, B).

    NB is padded to the next power of two with identity diagonal blocks;
    ``L[0]`` and ``U[-1]`` are ignored (treated as zero).
    """
    nb0, n, B = D.shape[0], D.shape[1], D.shape[-1]
    L = torch.cat([torch.zeros_like(L[:1]), L[1:]], dim=0)
    U = torch.cat([U[:-1], torch.zeros_like(U[:1])], dim=0)
    m = 1
    while m < nb0:
        m *= 2
    pad = m - nb0
    if pad:
        eye = torch.eye(n, dtype=D.dtype, device=D.device)[None, :, :, None]
        zpad = torch.zeros((pad, n, n, B), dtype=D.dtype, device=D.device)
        L = torch.cat([L, zpad], dim=0)
        D = torch.cat([D, eye.expand(pad, n, n, B)], dim=0)
        U = torch.cat([U, zpad], dim=0)

    levels = []
    while D.shape[0] > 1:
        De, Do = D[0::2], D[1::2]
        Le, Lo = L[0::2], L[1::2]
        Ue, Uo = U[0::2], U[1::2]
        Dinv_odd = gj_inv_lanes(Do)
        LDinv = mm_lanes(Le, _shift_down(Dinv_odd))
        UDinv = mm_lanes(Ue, Dinv_odd)
        D_new = De - mm_lanes(LDinv, _shift_down(Uo)) - mm_lanes(UDinv, Lo)
        L_new = -mm_lanes(LDinv, _shift_down(Lo))
        U_new = -mm_lanes(UDinv, Uo)
        levels.append(CRLanesLevel(Dinv_odd=Dinv_odd, L_odd=Lo, U_odd=Uo,
                                   LDinv=LDinv, UDinv=UDinv))
        L, D, U = L_new, D_new, U_new
    return CRLanesFactors(levels=tuple(levels), root_inv=gj_inv_lanes(D))


def cr_solve_lanes(fac: CRLanesFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve for the right-hand side ``b`` of shape (NB, n, B)."""
    nb0, n, B = b.shape
    m = 2 * fac.levels[0].Dinv_odd.shape[0] if fac.levels else 1
    if m > nb0:
        b = torch.cat([b, b.new_zeros((m - nb0, n, B))], dim=0)
    bs = [b]
    for lv in fac.levels:
        be, bo = b[0::2], b[1::2]
        b = be - mv_lanes(lv.LDinv, _shift_down(bo)) - mv_lanes(lv.UDinv, bo)
        bs.append(b)
    x = mv_lanes(fac.root_inv, b)
    for lv, b_lvl in zip(reversed(fac.levels), reversed(bs[:-1])):
        bo = b_lvl[1::2]
        rhs_o = (bo - mv_lanes(lv.L_odd, x)
                 - mv_lanes(lv.U_odd, _shift_up(x)))
        x_odd = mv_lanes(lv.Dinv_odd, rhs_o)
        x = torch.stack([x, x_odd], dim=1).reshape((-1,) + x.shape[1:])
    return x[:nb0]


# ---------------------------------------------------------------------------
# lane-minor MoL right-hand side
# ---------------------------------------------------------------------------


def lane_rhs(system: ReactionDiffusionSystem, y: torch.Tensor, k, d_eff,
             rj: torch.Tensor, dr: float) -> torch.Tensor:
    """The MoL right-hand side at ``y`` (NB, 10, B) for per-lane
    kinetics ``k`` (name -> (B,)) and diffusivities ``d_eff`` (B, 10);
    ``rj`` (M,) is the interior radii in ``y``'s dtype."""
    B = y.shape[-1]
    C_int = y[:-1].movedim(0, 1)                          # (10, M, B)
    m_t = y[-1, :N_MEMB, :].T                             # (B, 8)
    C_near_t = C_int[:, -1, :].T                          # (B, 10)
    C_R = rhs_mod.bc_closure(system, C_near_t, m_t, k, d_eff, dr)
    C_full = torch.cat([C_int[:, :1], C_int, C_R.T[:, None]], dim=1)

    um, uc, up = C_full[:, :-2], C_full[:, 1:-1], C_full[:, 2:]
    # cancellation-friendly ordering (the JAX package's production form)
    lap = ((up - uc) - (uc - um)) / dr**2
    if system.geometry is Geometry.SPHERICAL:
        lap = lap + (up - um) / (rj[None, :, None] * dr)

    dC = d_eff.T[:, None, :] * lap + rhs_mod.bulk_rates(system, C_int, k)
    dm = rhs_mod.memb_rates(system, m_t, C_R, k)          # (B, 8)
    dm_pad = torch.cat([dm.T, y.new_zeros((BLK - N_MEMB, B))], dim=0)
    return torch.cat([dC.movedim(1, 0), dm_pad[None]], dim=0)


def make_mol_rhs_lanes(system: ReactionDiffusionSystem, R: float, dr: float):
    """Lane-minor MoL RHS ``f(y (NB, 10, B), params (B,)-batched)`` and
    the (Nr+1,) float64 radial grid."""
    Nr = int(round(R / dr))
    r = torch.arange(Nr + 1, dtype=torch.float64) * dr

    def rhs(y: torch.Tensor, params: Params) -> torch.Tensor:
        k = kdict(params.k)
        d_eff = rhs_mod.effective_diffusivities(system, params)
        return lane_rhs(system, y, k, d_eff, interior_radii(r, y), dr)

    return rhs, r


# ---------------------------------------------------------------------------
# the batched adaptive stepper
# ---------------------------------------------------------------------------


def _lanes_y0(CoT: torch.Tensor, M: int, dtype) -> torch.Tensor:
    """Lane-minor initial state (NB, 10, B) from per-lane concentration
    rows ``CoT`` (5, B) (``basepdesolver.jl:94-97,137-141``)."""
    B = CoT.shape[-1]
    C0 = CoT.new_zeros((N_CYTO, M, B), dtype=dtype)
    for name, i in (("iSFK", 0), ("GRB2", 1), ("GAB1", 2), ("SHP2", 3)):
        C0[CYTO[name]] = CoT[i][None, :]
    m0 = CoT.new_zeros((BLK, B), dtype=dtype)
    m0[MEMB["mE"]] = CoT[4]
    return torch.cat([C0.movedim(1, 0), m0[None]], dim=0)


class LaneState(NamedTuple):
    """Per-lane integrator state (the JAX package's 9-tuple)."""

    t: torch.Tensor        # (B,)
    h: torch.Tensor        # (B,) carried step size
    y: torch.Tensor        # (NB, 10, B)
    nts: torch.Tensor      # (B,) int32 next save slot
    out_C: torch.Tensor    # (Nts+1, 10, Nr+1, B)
    out_m: torch.Tensor    # (Nts+1, 8, B)
    nacc: torch.Tensor     # (B,) int32
    nrej: torch.Tensor     # (B,) int32
    failed: torch.Tensor   # (B,) bool


class _LaneParams(NamedTuple):
    """Per-lane parameters prepared once for the step arithmetic."""

    k: dict                # name -> (B,), state dtype
    d_eff: torch.Tensor    # (B, 10), state dtype
    k_ls: dict             # the same in the linear-solve dtype
    d_eff_ls: torch.Tensor
    k_packed: torch.Tensor  # (B, 17) contiguous, for the fused kernel
    p: Params              # the parameters themselves, state dtype


class _Advance(NamedTuple):
    """What a step computes before its first host read (the dense
    output's): :meth:`_SolverCtx.advance`'s outputs, a graph's outputs
    where the step replays one."""

    h: torch.Tensor        # (B,) the step tried, truncated to the leg end
    accept: torch.Tensor   # (B,) bool
    t_new: torch.Tensor
    y_new: torch.Tensor
    h_new: torch.Tensor    # the carried step size
    failed: torch.Tensor
    nacc: torch.Tensor
    nrej: torch.Tensor
    f_n: torch.Tensor      # f(y)
    y_1: torch.Tensor      # the step's end, accepted or not
    f_1: Optional[torch.Tensor]  # f(y_1), or None where not computed
    ok: torch.Tensor       # (B,) bool, the step's success flags


def step_graphed(device: torch.device, method: str, step_impl: str) -> bool:
    """Whether :meth:`_SolverCtx.step` replays its body from a CUDA graph:
    the ROW tableaus and the unfused Rosenbrock23 on a card, whose bodies
    make no host read."""
    if device.type != "cuda":
        return False    # no graphs on the CPU, where the parity tests run
    if method == "trbdf2":
        return False    # its Newton loop reads the host every iteration
    if step_impl == "fused":
        return False    # B1: one launch a step already
    return True


class _SolverCtx:
    """Shared per-step machinery of the lane-minor stiff integrator.

    Used by both the chunked leg integrator and the lane-refill
    scheduler, so a lane's trajectory is controller-identical whichever
    scheduler runs it: all lane ops are elementwise in the lane axis,
    cross-lane reductions only gate iteration counts, and frozen lanes
    never change value.
    """

    ntol = 0.03
    newton_iters = 6
    # the methods recorded as spans of their names when the recorder is on
    RECORDED = ("step", "dense_output", "bands", "factor", "solve")

    def __init__(self, system, R, dr, Nts, rtol, atol, tf_total, dtype,
                 device, linsolve_dtype, method, step_impl, rhs_mixed=False):
        if method not in ("trbdf2", "rosenbrock23", *_ROW_TABLEAUS):
            raise ValueError(f"unknown method {method!r}")
        self.system, self.dr, self.Nts = system, dr, Nts
        self.rhs_mixed = rhs_mixed
        self.device = torch.device(device)
        self.graphed = step_graphed(self.device, method, step_impl)
        self._graph = None      # the _StepGraph this solve holds
        self.rtol, self.atol, self.tf_total = rtol, atol, tf_total
        self.dtype, self.method, self.step_impl = dtype, method, step_impl
        self.Nr = int(round(R / dr))
        self.M = self.Nr - 1
        r64 = torch.arange(self.Nr + 1, dtype=torch.float64) * dr
        self.r = r64.to(dtype=dtype, device=device)
        self.dt_save = tf_total / Nts
        self.eps = 1e-10 * tf_total
        self.h_min = 1e-13 * tf_total     # a smaller step fails the lane
        self.ls_dtype = linsolve_dtype if linsolve_dtype else dtype
        self.rj = r64[1:-1].to(dtype=dtype, device=device)
        self.rj_ls = r64[1:-1].to(dtype=self.ls_dtype, device=device)
        if rhs_mixed == "df32":
            from gab1_shp2_tpu_torch.ops.rhs_df32 import (
                make_mol_rhs_lanes_df32,
            )
            self._f_df32, _ = make_mol_rhs_lanes_df32(system, R, dr)
        self.eye_l = torch.eye(BLK, dtype=self.ls_dtype,
                               device=device)[None, :, :, None]
        self.slot_ids = torch.arange(Nts + 1, dtype=torch.int32,
                                     device=device)
        if step_impl == "fused":
            from gab1_shp2_tpu_torch.ops.ros23_cuda import ros23_step_fused
            self._fused = ros23_step_fused
        # the recorder switched on when the solve starts records all of it
        self.rec = progress.RECORDER
        if self.rec is not None:
            for name in self.RECORDED:
                setattr(self, name, self.rec.wrap(name, getattr(self, name)))

    def span(self, name: str):
        """The block as the recorder's span ``name``, or nothing when the
        solve is not recorded."""
        return progress.NULL if self.rec is None else self.rec.span(name)

    # --- per-lane parameter views -------------------------------------
    def lane_params(self, p: Params) -> _LaneParams:
        k = kdict(p.k)
        d_eff = rhs_mod.effective_diffusivities(self.system, p)
        if self.ls_dtype != self.dtype:
            p_ls = p.to(dtype=self.ls_dtype)
            k_ls = kdict(p_ls.k)
            d_eff_ls = rhs_mod.effective_diffusivities(self.system, p_ls)
        else:
            k_ls, d_eff_ls = k, d_eff
        return _LaneParams(k=k, d_eff=d_eff, k_ls=k_ls, d_eff_ls=d_eff_ls,
                           k_packed=p.k.contiguous(), p=p)

    def make_f(self, lp: _LaneParams):
        """The lane-batched RHS closed over the lane parameters (each
        call an ``rhs`` span when the solve is recorded)."""
        system, rj, dr = self.system, self.rj, self.dr
        if self.rhs_mixed == "df32":
            def f(y):
                return self._f_df32(y, lp.p)
        elif self.rhs_mixed:
            f = self._jvp_split_f(lp)
        else:
            def f(y):
                return lane_rhs(system, y, lp.k, lp.d_eff, rj, dr)
        return f if self.rec is None else self.rec.wrap("rhs", f)

    def _jvp_split_f(self, lp: _LaneParams):
        """The double-single RHS: y splits into an f32 hi part and an f32
        lo remainder; the f32 lane RHS at y_hi and its tangent along y_lo
        (one dual-number evaluation: the value path is the plain f32 RHS)
        are added in the state dtype.  The tangent restores the bits the
        truncation dropped; the f32 rounding of f(y_hi) itself (~1e-7
        relative) is not recoverable this way."""
        system, dr, dtype = self.system, self.dr, self.dtype
        rj32 = self.rj.to(torch.float32)
        p32 = lp.p.to(dtype=torch.float32)
        k32 = kdict(p32.k)
        d_eff32 = rhs_mod.effective_diffusivities(system, p32)

        def f(y):
            y_hi = y.to(torch.float32)
            y_lo = (y - y_hi.to(dtype)).to(torch.float32)
            out = lane_rhs(system, fwdgrad.seed(y_hi, y_lo[None]), k32,
                           d_eff32, rj32, dr)
            return out.v.to(dtype) + out.d[0].to(dtype)

        return f

    # --- pieces -----------------------------------------------------------
    def factor(self, L, D, U):
        ls = self.ls_dtype
        return cr_factor_lanes(L.to(ls), D.to(ls), U.to(ls))

    def solve(self, fac, b):
        return cr_solve_lanes(fac, b.to(self.ls_dtype)).to(self.dtype)

    def bands(self, y, lp: _LaneParams):
        """Jacobian bands in the linear-algebra dtype: when the linear
        solve runs narrower than the state, the band derivatives run on
        cast inputs (W is factored in that dtype anyway)."""
        return lane_bands(self.system, y.to(self.ls_dtype), lp.k_ls,
                          lp.d_eff_ls, self.rj_ls, self.dr)

    def snapshot(self, y, lp: _LaneParams):
        """(10, Nr+1, B) full profile + (8, B) membrane state."""
        C_int = y[:-1].movedim(0, 1)
        m_t = y[-1, :N_MEMB, :].T
        C_R = rhs_mod.bc_closure(self.system, C_int[:, -1, :].T, m_t,
                                 lp.k, lp.d_eff, self.dr)
        C_full = torch.cat([C_int[:, :1], C_int, C_R.T[:, None]], dim=1)
        return C_full, y[-1, :N_MEMB, :]

    def scaled_norm(self, v, y_a, y_b):
        """Per-lane weighted RMS norm: (NB, 10, B) -> (B,)."""
        w = self.atol + self.rtol * torch.maximum(y_a.abs(), y_b.abs())
        return torch.sqrt(torch.mean((v / w) ** 2, dim=(0, 1)))

    def newton(self, f, fac, y_init, rhs_const, h):
        """Per-lane Newton iteration (h is (1, 1, B)); converged lanes
        are frozen.  Returns (y, converged)."""
        y = y_init
        dn = torch.full((y.shape[-1],), float("inf"), dtype=self.dtype,
                        device=y.device)
        it = 0
        while (it < self.newton_iters
               and host_read((dn > self.ntol).any())):
            Gv = y - A * h * f(y) - rhs_const
            dy = self.solve(fac, -Gv)
            ynew = y + dy
            dn_new = self.scaled_norm(dy, ynew, ynew)
            upd = dn > self.ntol
            y = torch.where(upd, ynew, y)
            dn = torch.where(upd, dn_new, dn)
            it += 1
        return y, dn <= self.ntol

    def step(self, f, lp: _LaneParams, t1, active, st: LaneState,
             jac=None):
        """One adaptive step for every lane; ``active`` masks the lanes
        allowed to advance (inactive lanes keep their state bit for bit).
        ``t1`` is the leg end, a float or a (B,) tensor; ``jac``
        optionally supplies cached bands (the TRBDF2 ``jac_reuse`` path),
        otherwise they are rebuilt from ``y``.  Returns ``(updated state,
        per-lane step-success flags)``.

        Where :func:`step_graphed` holds, everything up to the dense
        output (:meth:`advance`) is one replay of a CUDA graph: the
        inputs are copied into the graph's static buffers, and the
        returned state holds the graph's output buffers, which the
        solve's next step overwrites.  A replay runs no Python, so the
        ``rhs``, ``bands``, ``factor`` and ``solve`` spans are recorded
        only while the graph is captured; the recorder counts
        ``graph_replays`` and ``graph_captures``."""
        # jac_reuse's cached bands are refreshed on the host's votes
        if self.graphed and jac is None:
            adv, start = self._replay(lp, t1, active, st)
        else:
            adv = self.advance(f, lp, t1, active, st.t, st.h, st.y, st.nacc,
                               st.nrej, st.failed, self.h_min, jac=jac)
            start = st
        nts, out_C, out_m = self.dense_output(f, lp, start, adv.h, adv.accept,
                                              adv.t_new, adv.f_n, adv.y_1,
                                              adv.f_1)
        return LaneState(adv.t_new, adv.h_new, adv.y_new, nts, out_C, out_m,
                         adv.nacc, adv.nrej, adv.failed), adv.ok

    def _replay(self, lp: _LaneParams, t1, active, st: LaneState):
        """The step's :meth:`advance` as one replay of the graph this
        solve holds (taken at its first step); returns its outputs and
        ``st`` with the step's start (``t``, ``y``) read from the static
        inputs, which still hold it."""
        g = self._graph
        if g is None:
            g = self._graph = self._take_graph(t1, active, st, lp)
        ins = g.inputs
        for name, v in (("y", st.y), ("t", st.t), ("h", st.h),
                        ("active", active), ("nacc", st.nacc),
                        ("nrej", st.nrej), ("failed", st.failed),
                        ("D", lp.p.D), ("k", lp.p.k)):
            ins[name].copy_(v)
        if isinstance(t1, torch.Tensor):
            ins["t1"].copy_(t1)
        else:
            ins["t1"].fill_(t1)
        adv = g.replay()
        if self.rec is not None:
            self.rec.count(graph_replays=1)
        return adv, st._replace(t=ins["t"], y=ins["y"])

    def graph_key(self, B: int) -> tuple:
        """Everything a captured step body bakes in."""
        return (self.device, B, self.Nr + 1, self.dtype, self.ls_dtype,
                self.method, self.rhs_mixed, self.system, self.dr,
                self.rtol, self.atol)

    def _take_graph(self, t1, active, st: LaneState,
                    lp: _LaneParams) -> "_StepGraph":
        """An idle graph of this solve's key, or one captured on this
        step's inputs; its failure threshold is set to this solve's."""
        B = st.t.shape[0]
        key = self.graph_key(B)
        with _GRAPHS_LOCK:
            idle = _IDLE_GRAPHS.get(key)
            g = idle.pop() if idle else None
        if g is None:
            t1_b = (t1 if isinstance(t1, torch.Tensor)
                    else torch.full_like(st.t, t1))
            inputs = dict(y=st.y, t=st.t, h=st.h, active=active, t1=t1_b,
                          nacc=st.nacc, nrej=st.nrej, failed=st.failed,
                          D=lp.p.D, k=lp.p.k,
                          h_min=torch.full((), self.h_min,
                                           dtype=self.dtype,
                                           device=self.device))
            # one capture at a time: torch's pool of side streams may hand
            # two threads the same one
            with _CAPTURE_LOCK:
                g = _StepGraph(self, key, inputs)
            if self.rec is not None:
                self.rec.count(graph_captures=1)
        else:
            if g.done is not None:
                torch.cuda.current_stream(self.device).wait_event(g.done)
            g.inputs["h_min"].fill_(self.h_min)
        return g

    def release_graph(self) -> None:
        """Give the graph this solve holds back to the idle ones, for the
        next solve of its key; call it once the solve's last read of a
        step output is queued."""
        g, self._graph = self._graph, None
        if g is None:
            return
        if g.graph is not None:
            g.done = torch.cuda.Event()
            g.done.record(torch.cuda.current_stream(self.device))
        with _GRAPHS_LOCK:
            _IDLE_GRAPHS.setdefault(g.key, []).append(g)
            _IDLE_GRAPHS.move_to_end(g.key)
            while sum(map(len, _IDLE_GRAPHS.values())) > MAX_IDLE_GRAPHS:
                oldest = next(iter(_IDLE_GRAPHS))
                gone = _IDLE_GRAPHS[oldest].pop(0)
                if not _IDLE_GRAPHS[oldest]:
                    del _IDLE_GRAPHS[oldest]
                if gone.done is not None:
                    gone.done.synchronize()

    def advance(self, f, lp: _LaneParams, t1, active, t, h_carry, y, nacc,
                nrej, failed, h_min, jac=None) -> "_Advance":
        """The step up to its first host read: the stages, the error
        norm and the controller, with ``h_min`` the failure threshold
        (``self.h_min``, as a float or as a graph's device scalar)."""
        method, ls = self.method, self.ls_dtype
        # step size: truncated to the leg end for active lanes, a
        # harmless dummy for finished lanes (their carried h is kept)
        h = torch.where(active, torch.minimum(h_carry, t1 - t),
                        torch.ones_like(h_carry))

        f_n = f(y)
        if jac is not None:
            Lj, Dj, Uj = jac
        elif not (method == "rosenbrock23" and self.step_impl == "fused"):
            Lj, Dj, Uj = self.bands(y, lp)
        hb = h[None, None, None, :].to(ls)
        hd = h[None, None, :]
        eye_l = self.eye_l

        if method == "trbdf2":
            fac = self.factor(-A * hb * Lj, eye_l - A * hb * Dj.to(ls),
                              -A * hb * Uj)
            rc1 = y + A * hd * f_n
            y_g, ok1 = self.newton(f, fac, y + GAMMA * hd * f_n, rc1, hd)
            f_g = (y_g - rc1) / (A * hd)
            rc2 = _C_YG * y_g - _C_YN * y
            y_1, ok2 = self.newton(f, fac, y_g, rc2, hd)
            f_1 = (y_1 - rc2) / (A * hd)
            y_hat = y + hd * (_B1 * f_n + _B2 * f_g + _B3 * f_1)
            est = self.solve(fac, y_1 - y_hat)
            errn = self.scaled_norm(est, y, y_1)
            ok = ok1 & ok2
        elif method == "rosenbrock23" and self.step_impl == "fused":
            y_1, f_1, est = self._fused(self.system, y, f_n, h,
                                        lp.k_packed, lp.d_eff, self.Nr,
                                        self.dr)
            errn = self.scaled_norm(est, y, y_1)
            ok = torch.isfinite(errn)
        elif method == "rosenbrock23":
            d = _ROS_D
            fac = self.factor(-d * hb * Lj, eye_l - d * hb * Dj.to(ls),
                              -d * hb * Uj)
            k1 = self.solve(fac, f_n)
            f_half = f(y + 0.5 * hd * k1)
            k2 = self.solve(fac, f_half - k1) + k1
            y_1 = y + hd * k2
            f_1 = f(y_1)
            k3 = self.solve(fac, f_1 - _ROS_E32 * (k2 - f_half)
                            - 2.0 * (k1 - f_n))
            est = (hd / 6.0) * (k1 - 2.0 * k2 + k3)
            errn = self.scaled_norm(est, y, y_1)
            ok = torch.isfinite(errn)
        else:
            y_1, est = _row_step(_ROW_TABLEAUS[method], self.factor,
                                 self.solve, f, y, f_n, (hb, hd), Lj, Dj,
                                 Uj, eye_l, ls)
            errn = self.scaled_norm(est, y, y_1)
            ok = torch.isfinite(errn)
            # RODAS never evaluates f(y_1): dense output computes it
            # lazily, only on steps that cross a save point
            f_1 = None

        accept = ok & (errn <= 1.0) & active
        t_new = torch.where(accept, t + h, t)
        y_new = torch.where(accept[None, None, :], y_1, y)

        # asymptotic controller, exponent -1/(q+1) for the embedded
        # estimator's order q: O(h^4) for rodas4, O(h^3) otherwise
        e_exp = -1.0 / 4.0 if method == "rodas4" else -1.0 / 3.0
        fac_ok = torch.clamp(0.9 * errn ** e_exp, 0.2, 4.0)
        fac_rej = torch.where(ok, torch.clamp(0.9 * errn ** e_exp, 0.1, 0.5),
                              0.3)
        h_prop = h * torch.where(accept, fac_ok, fac_rej)
        h_prop = torch.where(torch.isfinite(h_prop), h_prop, h * 0.3)
        h_new = torch.where(active, h_prop, h_carry)
        failed = failed | (active & (h_new < h_min))
        nacc = nacc + accept.to(torch.int32)
        nrej = nrej + (active & ~accept).to(torch.int32)
        return _Advance(h, accept, t_new, y_new, h_new, failed, nacc, nrej,
                        f_n, y_1, f_1, ok)

    def dense_output(self, f, lp: _LaneParams, st: LaneState, h, accept,
                     t_new, f_n, y_1, f_1):
        """The save points the accepted steps crossed, written by Hermite
        interpolation from ``st`` (at ``st.t``, step ``h``) to ``y_1``:
        per-lane save slots by masked one-hot writes.  ``f_1`` is
        f(y_1), or None to evaluate it only if some save is due.
        Returns ``(nts, out_C, out_m)``.  With the recorder on, each
        pass of the write loop counts ``save_passes``."""
        Nts, dt_save, eps, dtype = self.Nts, self.dt_save, self.eps, self.dtype
        t, y = st.t, st.y

        def writes(nts_i):
            # the save time in the state's dtype, as the loop below
            # computes it: a float32 t_new that stops at float32(tf)
            # still reaches the last save
            return (accept & (nts_i <= Nts)
                    & (nts_i.to(dtype) * dt_save <= t_new + eps))

        nts, out_C, out_m = st.nts, st.out_C, st.out_m
        write = writes(nts)
        if not host_read(write.any()):
            return nts, out_C, out_m
        f_end = f(y_1) if f_1 is None else f_1
        while True:
            ts = nts.to(dtype) * dt_save
            th = torch.where(h > 0, (ts - t) / h, 0.0)
            h00 = 2 * th**3 - 3 * th**2 + 1
            h10 = th**3 - 2 * th**2 + th
            h01 = -2 * th**3 + 3 * th**2
            h11 = th**3 - th**2
            y_s = (h00 * y + (h10 * h) * f_n + h01 * y_1
                   + (h11 * h) * f_end)
            Cs, ms = self.snapshot(y_s, lp)
            wmask = (self.slot_ids[:, None] == nts[None, :]) \
                & write[None, :]
            out_C = torch.where(wmask[:, None, None, :], Cs[None], out_C)
            out_m = torch.where(wmask[:, None, :], ms[None], out_m)
            if self.rec is not None:
                self.rec.count(save_passes=1)
            nts = nts + write.to(torch.int32)
            write = writes(nts)
            if not host_read(write.any()):
                return nts, out_C, out_m


class _StepGraph:
    """:meth:`_SolverCtx.advance` captured once as a CUDA graph over
    static input buffers (``inputs``: the step's state, its leg ends, the
    lane parameters ``D`` and ``k``, the failure threshold ``h_min``).
    Each replay overwrites the same output buffers.  The lane parameters'
    derived forms (``kdict``, the diffusivities, their linear-solve-dtype
    copies) are built inside the graph.  On the CPU nothing is captured:
    each replay runs the body again and copies its results into the
    first replay's outputs, the same aliasing without a card."""

    def __init__(self, ctx: _SolverCtx, key: tuple, inputs: dict):
        self.ctx = ctx          # holds every tensor the body reads
        self.key = key
        self.inputs = {name: v.clone() for name, v in inputs.items()}
        self.outputs: Optional[_Advance] = None
        self.graph = None
        self.done = None        # an event after the last holder's reads
        if ctx.device.type == "cuda":
            self._capture()

    def _body(self) -> _Advance:
        ctx, ins = self.ctx, self.inputs
        lp = ctx.lane_params(Params(D=ins["D"], k=ins["k"]))
        return ctx.advance(ctx.make_f(lp), lp, ins["t1"], ins["active"],
                           ins["t"], ins["h"], ins["y"], ins["nacc"],
                           ins["nrej"], ins["failed"], ins["h_min"])

    def _capture(self):
        dev = self.ctx.device
        side = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            # one eager run on the capture stream first, as
            # torch.cuda.graphs asks (its workspaces exist before capture)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread-local: the mesh's other slots keep working eagerly
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.outputs = self._body()

    def replay(self) -> _Advance:
        if self.graph is not None:
            with torch.cuda.device(self.ctx.device):
                self.graph.replay()
        elif self.outputs is None:
            self.outputs = self._body()
        else:
            for out, new in zip(self.outputs, self._body()):
                if out is not None:
                    out.copy_(new)
        return self.outputs


# captured step graphs that no solve holds, by _SolverCtx.graph_key, the
# key given back last at the end; each holds a memory pool of its own
_IDLE_GRAPHS: "OrderedDict[tuple, List[_StepGraph]]" = OrderedDict()
MAX_IDLE_GRAPHS = 8
_GRAPHS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()


# band age (accepted or rejected steps) that forces a refresh under
# jac_reuse
JAC_MAX_AGE = 20


def _solve_batch_impl(system, Co, params, legs, R, dr, Nts, rtol, atol,
                      max_steps, h0, method, linsolve_dtype, step_impl,
                      jac_reuse=False, rhs_mixed=False):
    dtype, dev = Co.dtype, Co.device
    B = params.k.shape[0]
    tf_total = legs[-1][1]
    ctx = _SolverCtx(system, R, dr, Nts, rtol, atol, tf_total, dtype, dev,
                     linsolve_dtype, method, step_impl, rhs_mixed)
    Nr, M, eps = ctx.Nr, ctx.M, ctx.eps

    if Co.ndim == 2:
        y0 = _lanes_y0(Co.T, M, dtype)
        CoEGFR = Co[:, 4]
    else:
        y0 = _lanes_y0(Co[:, None].expand(5, B), M, dtype)
        CoEGFR = Co[4].expand(B)

    out_C = torch.full((Nts + 1, N_CYTO, Nr + 1, B), float("nan"),
                       dtype=dtype, device=dev)
    out_m = torch.full((Nts + 1, N_MEMB, B), float("nan"), dtype=dtype,
                       device=dev)
    out_C[0], out_m[0] = ctx.snapshot(y0, ctx.lane_params(legs[0][2]))

    i32 = dict(dtype=torch.int32, device=dev)
    st = LaneState(t=torch.zeros(B, dtype=dtype, device=dev),
                   h=torch.full((B,), h0, dtype=dtype, device=dev),
                   y=y0, nts=torch.ones(B, **i32), out_C=out_C, out_m=out_m,
                   nacc=torch.zeros(B, **i32), nrej=torch.zeros(B, **i32),
                   failed=torch.zeros(B, dtype=torch.bool, device=dev))
    # Jacobian reuse (TRBDF2 only; for a Newton method a stale J slows
    # convergence but never moves the converged solution): the bands
    # are refreshed at leg entry, after a step on which some lane's
    # Newton iteration failed, and at age JAC_MAX_AGE; W is refactored
    # from the cached bands every step.  The refresh is collective over
    # the batch, so results depend on the batch's membership.
    reuse = bool(jac_reuse) and method == "trbdf2"
    for (t0, t1, p) in legs:
        lp = ctx.lane_params(p)
        f = ctx.make_f(lp)
        st = st._replace(t=torch.clamp(st.t, min=t0))
        jac, j_age, want_refresh = None, 0, False
        if reuse:
            jac = ctx.bands(st.y, lp)
        while True:
            running = ((st.t < t1 - eps) & ~st.failed
                       & (st.nacc + st.nrej < max_steps))
            if not host_read(running.any()):
                break
            active = st.t < t1 - eps
            if reuse and (want_refresh or j_age >= JAC_MAX_AGE):
                jac, j_age = ctx.bands(st.y, lp), 0
            st, ok = ctx.step(f, lp, t1, active, st, jac=jac)
            if reuse:
                # a Newton failure invalidates the (possibly stale) J
                want_refresh = host_read((active & ~ok).any())
                j_age += 1
    failed = st.failed | (st.nts <= Nts)
    # the step counts are a graph's outputs where the step replays one:
    # copied before the graph goes to the next solve
    nacc, nrej = st.nacc.clone(), st.nrej.clone()
    ctx.release_graph()

    t_save = torch.linspace(0.0, tf_total, Nts + 1,
                            dtype=torch.float64).to(dtype=dtype, device=dev)
    sol = Solution(C=st.out_C.movedim(-1, 0), m=st.out_m.movedim(-1, 0),
                   t=t_save, r=ctx.r, CoEGFR=CoEGFR)
    return sol, StiffStats(n_accepted=nacc, n_rejected=nrej, failed=failed)


def _solve_refill_impl(system, Co_all, params, R, dr, tf, Nts, rtol, atol,
                       max_steps, h0, method, linsolve_dtype, lanes,
                       harvest_every, extract, t_prechase=None, params2=None,
                       rhs_mixed=False):
    """Continuation-batched stiff ensemble solve with lane refill.

    ``lanes`` lanes integrate continuously; every ``harvest_every``
    iterations (and at once when no lane can advance) finished lanes are
    harvested — their extracted outputs scattered to the (N, ...) result
    buffers at their member index — and refilled with the next queued
    members.  Two-leg pulse-chase solves switch params per lane on the
    lane's own clock (``t < t_prechase``: leg-1 params, leg end
    ``t_prechase``; after: ``params2``, leg end ``tf``), so each lane's
    trajectory is controller-identical to the chunked scheduler's.
    """
    dtype, dev = Co_all.dtype, Co_all.device
    N = params.k.shape[0]
    B, K = int(lanes), int(harvest_every)
    ctx = _SolverCtx(system, R, dr, Nts, rtol, atol, tf, dtype, dev,
                     linsolve_dtype, method, "torch", rhs_mixed)
    M, Nr, eps = ctx.M, ctx.Nr, ctx.eps
    t_save = torch.linspace(0.0, tf, Nts + 1,
                            dtype=torch.float64).to(dtype=dtype, device=dev)
    if Co_all.ndim == 1:
        Co_all = Co_all.expand(N, 5)
    i32 = dict(dtype=torch.int32, device=dev)

    def take(p, idx):
        return None if p is None else Params(D=p.D[idx], k=p.k[idx])

    def fresh(member):
        """Initial lane state for (possibly out-of-queue) member indices."""
        live = member < N
        midx = member.clamp(0, N - 1)
        Co_l = Co_all[midx]                                  # (B, 5)
        p_l, p2_l = take(params, midx), take(params2, midx)
        y0 = _lanes_y0(Co_l.T, M, dtype)
        out_C = torch.full((Nts + 1, N_CYTO, Nr + 1, B), float("nan"),
                           dtype=dtype, device=dev)
        out_m = torch.full((Nts + 1, N_MEMB, B), float("nan"), dtype=dtype,
                           device=dev)
        out_C[0], out_m[0] = ctx.snapshot(y0, ctx.lane_params(p_l))
        st = LaneState(t=torch.zeros(B, dtype=dtype, device=dev),
                       h=torch.full((B,), h0, dtype=dtype, device=dev),
                       y=y0, nts=torch.ones(B, **i32), out_C=out_C,
                       out_m=out_m, nacc=torch.zeros(B, **i32),
                       nrej=torch.zeros(B, **i32),
                       failed=torch.zeros(B, dtype=torch.bool, device=dev))
        return live, Co_l, p_l, p2_l, st

    def extract_lanes(out_C, out_m, Co_l):
        sol = Solution(C=out_C.movedim(-1, 0), m=out_m.movedim(-1, 0),
                       t=t_save.expand(B, Nts + 1),
                       r=ctx.r.expand(B, Nr + 1), CoEGFR=Co_l[:, 4])
        return torch.func.vmap(extract)(sol), sol

    def lane_pending(live, st):
        return (live & (st.t < tf - eps) & ~st.failed
                & (st.nacc + st.nrej < max_steps))

    def where_lanes(sel, a, b):
        return torch.where(sel.reshape((1,) * (a.ndim - 1) + (B,)), a, b)

    member = torch.arange(B, device=dev)
    live, Co_l, p_l, p2_l, st = fresh(member)
    vals0, _ = extract_lanes(st.out_C, st.out_m, Co_l)
    out_all = pytree.tree_map(
        lambda v: v.new_zeros((N,) + tuple(v.shape[1:])), vals0)
    ok_all = torch.zeros(N, dtype=torch.bool, device=dev)
    steps_all = torch.zeros(N, **i32)

    # with the recorder on: the accepted steps of the harvested lanes,
    # summed on the device and read with the step counts after the loop
    rec = ctx.rec
    accepted = None if rec is None else torch.zeros((), dtype=torch.int64,
                                                    device=dev)
    it, n_done, next_ptr = 0, 0, B
    while n_done < N:
        with ctx.span(progress.ITERATION):
            if rec is not None:
                rec.count(iterations=1, lane_slots=B)
            active = lane_pending(live, st)
            if t_prechase is None:
                p_eff, t1 = p_l, tf
            else:
                in2 = st.t >= t_prechase - eps
                p_eff = Params(D=torch.where(in2[:, None], p2_l.D, p_l.D),
                               k=torch.where(in2[:, None], p2_l.k, p_l.k))
                t1 = torch.where(in2, torch.full_like(st.t, tf),
                                 torch.full_like(st.t, t_prechase))
            lp = ctx.lane_params(p_eff)
            st, _ = ctx.step(ctx.make_f(lp), lp, t1, active, st)
            still = lane_pending(live, st)
            finished = live & ~still
            if host_read(finished.any()) and (
                    it % K == K - 1 or not host_read(still.any())):
                with ctx.span("harvest"):
                    vals, sol = extract_lanes(st.out_C, st.out_m, Co_l)
                    # incomplete saves count as failure (chunked-path
                    # semantics)
                    failed_h = st.failed | (st.nts <= Nts)
                    okl = ~failed_h & torch.isfinite(
                        sol.C[:, -1]).all(dim=-1).all(dim=-1)
                    idx = member[finished]
                    for buf, v in zip(pytree.tree_leaves(out_all),
                                      pytree.tree_leaves(vals)):
                        buf[idx] = v[finished].to(buf.dtype)
                    ok_all[idx] = okl[finished]
                    steps_all[idx] = (st.nacc + st.nrej)[finished]
                    if rec is not None:
                        rec.count(harvests=1)
                        accepted = accepted + torch.where(
                            finished, st.nacc, 0).sum()
                    nf = host_read(finished.sum(), int)
                    ranks = torch.cumsum(finished.to(torch.int64), 0) - 1
                    member = torch.where(finished, next_ptr + ranks, member)
                    live_f, Co_f, p_f, p2_f, st_f = fresh(member)
                    sel_r = finished[:, None]
                    Co_l = torch.where(sel_r, Co_f, Co_l)
                    p_l = Params(D=torch.where(sel_r, p_f.D, p_l.D),
                                 k=torch.where(sel_r, p_f.k, p_l.k))
                    if p2_l is not None:
                        p2_l = Params(D=torch.where(sel_r, p2_f.D, p2_l.D),
                                      k=torch.where(sel_r, p2_f.k, p2_l.k))
                    st = LaneState(*(where_lanes(finished, a_f, a)
                                     for a_f, a in zip(st_f, st)))
                    live = torch.where(finished, live_f, live)
                    n_done += nf
                    next_ptr += nf
            it += 1
    # every read of a step's outputs (the harvests') is queued
    ctx.release_graph()
    if rec is not None:
        steps, acc = torch.stack([steps_all.sum(), accepted]).tolist()
        rec.count(active_lane_steps=steps, accepted_steps=acc)
    return out_all, ok_all, steps_all


def _norm_rhs_mixed(rhs_mixed):
    """The rhs_mixed flag as False (the RHS in the state dtype), True
    (jvp-split double-f32, ~1e-7 floor) or ``"df32"`` (compensated EFT
    double-f32, ~2^-48; :mod:`gab1_shp2_tpu_torch.ops.rhs_df32`)."""
    if rhs_mixed == "df32":
        return "df32"
    return bool(rhs_mixed)


def _prepare(Co, params, device, rhs_mixed):
    """Shared argument handling of the two entry points."""
    dev = resolve_device(device)
    Co = torch.as_tensor(Co, device=dev)
    params = params.to(dtype=Co.dtype, device=dev)
    if params.k.ndim != 2:
        raise ValueError("batched params (B, ...) are required")
    rhs_mixed = _norm_rhs_mixed(rhs_mixed)
    if rhs_mixed and Co.dtype == torch.float32:
        raise ValueError("rhs_mixed splits a wide state into an f32 hi/lo "
                         "pair; it requires a float64 state")
    return Co, params, rhs_mixed


def solve_stiff_refill(
    system: ReactionDiffusionSystem,
    Co,
    params: Params,
    *,
    extract: Callable = lambda sol: sol,
    device=None,
    R: float = 10.0,
    dr: float = 0.1,
    tf: float = 5.0,
    Nts: int = 100,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    max_steps: int = 20_000,
    h0: float = 1e-5,
    method: str = "trbdf2",
    linsolve_dtype=None,
    rhs_mixed: Optional[bool] = None,
    lanes: int = 256,
    harvest_every: int = 4,
    t_prechase: Optional[float] = None,
):
    """Lane-refill stiff ensemble solve (see :func:`_solve_refill_impl`).

    ``device=None`` runs on the CUDA card (and raises if there is none).
    ``t_prechase`` enables the two-leg pulse-chase protocol (``kp -> 0``
    at ``t_prechase``; ``gefitinib_pulse_chase.jl:104-106``) with per-lane
    leg switching.  ``extract`` maps one member's :class:`Solution` to
    what is kept; it is applied over lanes with ``torch.func.vmap``.

    ``rhs_mixed`` (float64 state only; see the module docstring):
    ``"df32"`` or ``True``.

    Returns ``(out, ok, steps)``: the per-member extracted outputs with a
    leading (N,) axis, a success mask, and per-member step counts.
    """
    Co, params, rhs_mixed = _prepare(Co, params, device, rhs_mixed)
    params2 = None
    if t_prechase is not None:
        params2 = params.replace(kp=0.0)
        t_prechase = float(t_prechase)
    return _solve_refill_impl(system, Co, params, float(R), float(dr),
                              float(tf), int(Nts), rtol, atol,
                              int(max_steps), float(h0), method,
                              linsolve_dtype, int(lanes), int(harvest_every),
                              extract, t_prechase=t_prechase,
                              params2=params2, rhs_mixed=rhs_mixed)


def solve_stiff_batch(
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
    jac_reuse: Optional[bool] = None,
    step_impl: Optional[str] = None,
    rhs_mixed: Optional[bool] = None,
):
    """Batched stiff MoL solve over a parameter ensemble.

    ``params`` carries a leading batch axis (B,); ``Co`` is (5,) shared or
    (B, 5) per lane.  The returned :class:`Solution` and
    :class:`StiffStats` have a leading batch axis.  ``device=None`` runs
    on the CUDA card (and raises if there is none).

    ``method``: ``"trbdf2"`` (default), ``"rosenbrock23"``, ``"rodas3"``
    or ``"rodas4"``.  ``linsolve_dtype`` runs the bands, factor and stage
    solves narrower than the state (e.g. float64 state, float32 linear
    algebra).  ``step_impl``: ``"torch"`` (default, the unfused step) or
    ``"fused"`` (the fused Rosenbrock23 kernel; float32 rosenbrock23
    with float32 linear algebra only).

    ``jac_reuse=True`` (trbdf2 only; ignored for the other methods)
    amortizes the Jacobian band refresh across steps (refreshed by age,
    Newton failure or a leg change; W is refactored every step), so
    solutions agree with the default to the integration tolerance, not
    bit for bit.

    ``rhs_mixed`` (float64 state only) evaluates the RHS in float32
    pairs: ``"df32"`` compensated (~2^-48 of the float64 RHS, fit for the
    rtol 1e-6 north star), ``True`` jvp-split (~1e-7 floor, ~1e-5
    end to end at rtol 1e-6).  Both exist because the JAX package's
    accelerator emulates float64; native float64 is the default.
    """
    Co, params, rhs_mixed = _prepare(Co, params, device, rhs_mixed)
    if t_prechase is None:
        legs = ((0.0, float(tf), params),)
    else:
        legs = ((0.0, float(t_prechase), params),
                (float(t_prechase), float(tf), params.replace(kp=0.0)))
    if step_impl is None:
        step_impl = "torch"
    if step_impl not in ("torch", "fused"):
        raise ValueError(f"unknown step_impl {step_impl!r}")
    if step_impl == "fused" and (Co.dtype != torch.float32
                                 or linsolve_dtype not in (None,
                                                           torch.float32)
                                 or method != "rosenbrock23"):
        raise ValueError("step_impl='fused' supports only float32 "
                         "rosenbrock23 with float32 linear algebra")
    sol, stats = _solve_batch_impl(system, Co, params, legs, float(R),
                                   float(dr), int(Nts), rtol, atol,
                                   int(max_steps), float(h0), method,
                                   linsolve_dtype, step_impl,
                                   jac_reuse=bool(jac_reuse),
                                   rhs_mixed=rhs_mixed)
    if return_stats:
        return sol, stats
    return sol
