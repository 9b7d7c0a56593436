"""Fused explicit ensemble solve: the hand-written CUDA kernel and its
plain twin.

Counterpart of ``gab1_shp2_tpu/ops/explicit_pallas.py``.  One launch of
``csrc/explicit_solve.cu`` advances every member of a parameter ensemble
through all of its FTCS time steps and returns only the final-time state
(the history-free solver of the sensitivity sweeps,
``sapdesolver.jl:55-280``).  Trajectories come from ``ops/explicit.py``.

* :func:`solve_explicit_fused` is the wrapper.  With ``device="cpu"`` it
  runs :func:`solve_explicit_plain`; on a CUDA device it launches the
  kernel or raises.  ``LAUNCHES`` counts kernel launches.
* :func:`solve_explicit_plain` is the same function in eager torch, step
  by step: a fixed ``maxiters`` of the membrane fixed point, float32,
  per-member step counts by masking.  The kernel reorders its arithmetic
  (reciprocals hoisted out of the step loop, quotients by a reciprocal and
  one correction).  The CPU tests use the twin, and ``chip_smoke.py``
  holds the kernel against it.
* :func:`launch_plan` is the kernel's layout for a grid, and
  :func:`member_order` the order in which the kernel takes the members
  (by step count, descending); :func:`kernel_info` reads registers and
  occupancy of a layout from the card.
* :func:`explicit_flops` counts the floating-point operations of one
  member-step in the kernel's hoisted form.

Differences from the TPU kernel, all deliberate: the Laplacian is the
production form of ``ops/rhs.laplacian`` (not ``up - 2C + um``); the grid
may have up to ``MAX_NODES`` nodes (not 128); each member runs its own
``nt`` steps instead of a shared masked loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional, Tuple

import torch

from gab1_shp2_tpu_torch.models.params import (
    Params,
    resolve_device,
    stability_dt,
)
from gab1_shp2_tpu_torch.models.species import CYTO, N_CYTO, N_MEMB
from gab1_shp2_tpu_torch.models.system import (
    ETOT_MEMBERS,
    Geometry,
    ReactionDiffusionSystem,
)
from gab1_shp2_tpu_torch.ops import _build
from gab1_shp2_tpu_torch.ops.explicit import uniform_initial_profile
from gab1_shp2_tpu_torch.ops.rates_codegen import (
    lane_closure_header,
    rates_header,
)
from gab1_shp2_tpu_torch.ops.rhs import (
    bc_closure,
    bulk_rates,
    effective_diffusivities,
    kdict,
    laplacian,
    memb_rates,
)

# kernel launches since import (or since a caller reset it to 0); the
# wrapper may run on several threads at once (parallel/mesh.py), so it
# counts under a lock
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()


def count_launch() -> None:
    """Add one to ``LAUNCHES`` (the wrapper calls it after each launch)."""
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES += 1

# a lane holds up to 4 nodes, a member up to 8 warps: 1024 interior nodes
MAX_NODES = 4 * 32 * 8 + 2

def _prepare(Co, params, R, dr, tf, maxiters, dev):
    """Shared argument handling: float32 tensors on ``dev`` and the
    per-member step sizes and counts."""
    Nr = int(round(R / dr))
    if Nr < 2:
        raise ValueError(f"the grid needs at least 3 nodes, got {Nr + 1}")
    if Nr + 1 > MAX_NODES:
        raise ValueError(
            f"grid {Nr + 1} nodes exceeds the kernel's {MAX_NODES}-node "
            f"limit (4 interior nodes a thread, 256 threads a block; "
            f"needs dr >= R/{MAX_NODES - 1}); use solve_explicit or "
            f"solve_stiff_batch for finer grids")
    if int(maxiters) < 1:
        raise ValueError("maxiters must be at least 1")
    f32 = torch.float32
    Co = torch.as_tensor(Co, device=dev).to(f32)
    if Co.shape != (5,):
        raise ValueError(f"Co must have shape (5,), got {tuple(Co.shape)}")
    if params.k.ndim != 2:
        raise ValueError("batched params (B, ...) are required")
    pb = params.to(dtype=f32, device=dev)
    dts = stability_dt(pb, dr)                                   # (B,)
    nt = torch.ceil(tf / dts).to(torch.int32)                    # (B,)
    return Nr, Co, pb, dts, nt


def solve_explicit_plain(
    system: ReactionDiffusionSystem,
    Co,
    params: Params,
    *,
    R: float = 10.0,
    dr: float = 0.2,
    tf: float = 5.0,
    maxiters: int = 4,
    block: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused solve's arithmetic in eager torch (same signature and
    result as :func:`solve_explicit_fused`)."""
    dev = resolve_device(device)
    Nr, Co, pb, dts, nt = _prepare(Co, params, R, dr, tf, maxiters, dev)
    B = pb.k.shape[0]
    step = B if block is None else int(block)
    outs = [_plain_block(system, Co, Params(D=pb.D[s:s + step],
                                            k=pb.k[s:s + step]),
                         dts[s:s + step], nt[s:s + step], Nr, dr, maxiters)
            for s in range(0, B, step)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _plain_block(system, Co, pb, dts, nt, Nr, dr, maxiters):
    dev = Co.device
    B = pb.k.shape[0]
    r = torch.arange(Nr + 1, dtype=torch.float32, device=dev) * dr
    d_eff = effective_diffusivities(system, pb)                  # (B, 10)
    k_memb = kdict(pb.k)
    k_bulk = kdict(pb.k[:, None, :])
    C, m = uniform_initial_profile(Co, Nr, B)
    gm = torch.zeros_like(m)
    dt1, dt3 = dts[:, None], dts[:, None, None]
    nt_host = nt.cpu().numpy()
    for i in range(int(nt_host.max())):
        lap = laplacian(system, C, r, dr)
        C_int = C[:, :, 1:-1]
        rates = bulk_rates(system, C_int.movedim(1, 0), k_bulk)
        Cn_int = C_int + dt3 * (d_eff[:, :, None] * lap
                                + rates.movedim(0, 1))
        C_near = Cn_int[:, :, -1]
        mm = gm
        for _ in range(maxiters):
            CR = bc_closure(system, C_near, mm, k_memb, d_eff, dr)
            mm = m + dt1 * memb_rates(system, m, CR, k_memb)
        C_new = torch.cat([Cn_int[:, :, :1], Cn_int, CR[:, :, None]], dim=2)
        if i < nt_host.min():
            C, m, gm = C_new, mm, mm
        else:
            active = i < nt
            C = torch.where(active[:, None, None], C_new, C)
            m = torch.where(active[:, None], mm, m)
            gm = m
    return C, m


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The kernel's layout for a grid of ``Nr + 1`` nodes (``Nr - 1``
    interior ones): a block of ``warps_per_member`` warps per member,
    ``nodes_per_lane`` interior nodes a thread.  One warp has no block
    barrier; 2..8 warps share one a step.
    """

    Nr: int
    nodes_per_lane: int
    warps_per_member: int

    @property
    def layout(self) -> str:
        w = self.warps_per_member
        return (f"a block of {w} warp{'s' * (w > 1)} per member, "
                f"{self.nodes_per_lane} nodes a lane")

    @property
    def threads(self) -> int:
        return 32 * self.warps_per_member


def launch_plan(Nr: int) -> LaunchPlan:
    """The layout for ``Nr - 1`` interior nodes, from the shape alone: one
    warp per member at 2 nodes a lane up to 64 interior nodes (51 nodes at
    dr=0.2) and at 4 up to 128 (101 nodes at dr=0.1), then
    ceil((Nr-1)/128) warps at 4 nodes a lane up to 1024 (``MAX_NODES``).
    Each instantiation compiles without spills on Hopper (``-Xptxas -v``:
    128 registers at 2 and at 4 nodes a lane, and with 2-8 warps, under the
    255 that ``__launch_bounds__(256)`` allows)."""
    interior = int(Nr) - 1
    if interior < 1 or interior + 2 > MAX_NODES:
        raise ValueError(f"no layout for {interior + 2} nodes (3 to "
                         f"{MAX_NODES})")
    if interior <= 64:
        return LaunchPlan(int(Nr), 2, 1)
    if interior <= 128:
        return LaunchPlan(int(Nr), 4, 1)
    return LaunchPlan(int(Nr), 4, -(-interior // 128))


def member_order(nt: torch.Tensor) -> torch.Tensor:
    """The kernel's slot -> member map (int32, on ``nt``'s device): members
    by step count, descending, ties in member order.  The kernel reads the
    inputs of member ``order[slot]`` and writes its outputs there, so the
    results come back in member order."""
    return torch.argsort(nt, descending=True, stable=True).to(torch.int32)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library(system: ReactionDiffusionSystem):
    lib = _build.load_library(
        "explicit_solve", ["explicit_solve.cu"],
        {"explicit_rates.cuh": rates_header(system),
         "explicit_lanes.cuh": lane_closure_header(system)})
    lib.explicit_solve_launch.argtypes = (
        [_P] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_double]
        + [ctypes.c_int] * 4 + [_P])
    lib.explicit_solve_launch.restype = ctypes.c_int
    lib.explicit_kernel_info.argtypes = [ctypes.c_int] * 2 + [_P]
    lib.explicit_kernel_info.restype = ctypes.c_int
    return lib


def build(system: ReactionDiffusionSystem) -> None:
    """Build (or load) the kernel library for ``system`` now."""
    _library(system)


def kernel_info(system: ReactionDiffusionSystem, plan: LaunchPlan) -> dict:
    """Registers and local (spill) bytes a thread of the plan's
    instantiation, resident blocks an SM from the occupancy calculator,
    and the card's SM clock in kHz."""
    out = (ctypes.c_int * 4)()
    err = _library(system).explicit_kernel_info(
        plan.nodes_per_lane, plan.warps_per_member, out)
    if err != 0:
        raise RuntimeError(f"explicit_kernel_info failed: CUDA error {err}")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                sm_clock_khz=out[3])


def _launch(system, plan, c0, m0, k, d_eff, dts, nt, order, C_out, m_out,
            dr, maxiters):
    """One launch over the members of ``order`` on the current stream;
    raises if the card refuses it."""
    err = _library(system).explicit_solve_launch(
        c0.data_ptr(), m0.data_ptr(), k.data_ptr(), d_eff.data_ptr(),
        dts.data_ptr(), nt.data_ptr(), order.data_ptr(), C_out.data_ptr(),
        m_out.data_ptr(), order.numel(), plan.Nr, float(dr),
        int(system.geometry is Geometry.SPHERICAL), int(maxiters),
        plan.nodes_per_lane, plan.warps_per_member,
        torch.cuda.current_stream(C_out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"explicit_solve kernel launch failed: CUDA "
                           f"error {err}")


def solve_explicit_fused(
    system: ReactionDiffusionSystem,
    Co,
    params: Params,  # batched (B, ...) leaves
    *,
    R: float = 10.0,
    dr: float = 0.2,
    tf: float = 5.0,
    maxiters: int = 4,
    block: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-state explicit solve of a parameter ensemble in one (or a
    few) fused kernel launches.

    Returns ``(C (B, 10, Nr+1), m (B, 8))`` at t = tf, float32 (``Co`` and
    ``params`` are cast to float32).  Every member takes
    ``ceil(tf/dt)`` steps of its own ``dt = stability_dt(params, dr)``
    with a fixed ``maxiters`` of the membrane fixed point per step.
    ``block`` bounds the members per launch; ``None`` is one launch for
    the whole ensemble.  ``device=None`` runs on the CUDA card (and raises
    if there is none); with ``device="cpu"`` this is
    :func:`solve_explicit_plain`.  The layout is :func:`launch_plan`'s
    for the grid, and each launch takes its members in
    :func:`member_order`.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return solve_explicit_plain(system, Co, params, R=R, dr=dr, tf=tf,
                                    maxiters=maxiters, block=block,
                                    device=dev)
    if dev.type != "cuda":
        raise ValueError(f"solve_explicit_fused runs on a CUDA device or "
                         f"the CPU, got {dev}")
    if block is not None and int(block) < 1:
        raise ValueError("block must be at least 1")
    Nr, Co, pb, dts, nt = _prepare(Co, params, R, dr, tf, maxiters, dev)
    plan = launch_plan(Nr)
    B = pb.k.shape[0]
    C0, m0 = uniform_initial_profile(Co, Nr, 1)
    c0 = C0[0, :, 0].contiguous()                                # (10,)
    m0 = m0[0].contiguous()                                      # (8,)
    k = pb.k.contiguous()
    d_eff = effective_diffusivities(system, pb).contiguous()
    dts = dts.contiguous()
    nt = nt.contiguous()
    C_out = torch.empty((B, N_CYTO, Nr + 1), dtype=torch.float32, device=dev)
    m_out = torch.empty((B, N_MEMB), dtype=torch.float32, device=dev)

    step = B if block is None else int(block)
    for s in range(0, B, step):
        n = min(step, B - s)
        _launch(system, plan, c0, m0, k[s:s + n], d_eff[s:s + n],
                dts[s:s + n], nt[s:s + n], member_order(nt[s:s + n]),
                C_out[s:s + n], m_out[s:s + n], dr, maxiters)
        count_launch()
    return C_out, m_out


# ---------------------------------------------------------------------------
# operation count
# ---------------------------------------------------------------------------


def _reaction_flops(reactions) -> int:
    """Operations of ``rhs._net_reaction_terms`` over ``reactions``."""
    n = 0
    for rx in reactions:
        # forward chain: kf [* scale] * each reactant (st times) * catalysts
        factors = (1 + (rx.rate_scale is not None) + sum(rx.r_stoich())
                   + len(rx.catalysts))
        n += factors - 1
        if rx.kr is not None:
            n += sum(rx.p_stoich())          # kr * products
            n += 1                           # rf - rr
        for st in rx.r_stoich() + rx.p_stoich():
            n += 1 + (st != 1)               # out -/+= [st *] net
    return n


def explicit_flops(system: ReactionDiffusionSystem, Nr: int,
                   maxiters: int) -> int:
    """Floating-point operations of one member-step of the fused solve in
    the kernel's hoisted form (adds, multiplies and divides, each counted
    as one; the invariants 1/dr^2, 1/(r_j dr), dr/d_eff and kSa*dr/d_eff
    are taken once per member and not counted):

    * per interior node (Nr-1 of them): the bulk reactions, and per
      species the stencil (4; the spherical metric term adds 3) and the
      update ``C + dt*(d*lap + rates)`` (4);
    * once a step, on the previous step's membrane state: the membrane
      reactions, and each binding's off term ``kr*m[bound]``;
    * per fixed-point iteration, what the membrane iterate needs: for each
      species with a binding its gain ``kr*m`` and loss ``kf*m`` (and the
      adds that join a species' terms), ``g*q + cn`` and ``l*q + 1`` (2
      each) and one quotient; each binding's net ``(kf*CR)*m - off`` and
      its two accumulations (5); the membrane update (2 per species);
    * once a step, the boundary values of the last iterate that no binding
      reads: Etot (its adds and the scale), iSFK's ``l*q + 1`` with ``l =
      kSa*Etot`` and its quotient (4), aSFK's ``cn + kSa*q*CR[iSFK]*Etot``
      (3).
    """
    spherical = system.geometry is Geometry.SPHERICAL
    node = _reaction_flops(system.bulk_reactions) + N_CYTO * (
        4 + 3 * spherical + 4)
    nb = len(system.surface_bindings)
    per_step = _reaction_flops(system.memb_reactions) + nb
    bound = [0] * N_CYTO
    for sb in system.surface_bindings:
        bound[CYTO[sb.cyto]] += 1
    per_iter = (2 * nb + 2 * sum(max(0, n - 1) for n in bound)
                + 5 * sum(n > 0 for n in bound) + 5 * nb + 2 * N_MEMB)
    boundary = len(ETOT_MEMBERS) + 4 + 3
    return (Nr - 1) * node + per_step + int(maxiters) * per_iter + boundary

