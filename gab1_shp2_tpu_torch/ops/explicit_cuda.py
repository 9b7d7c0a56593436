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
* :func:`solve_explicit_plain` is the kernel's arithmetic in eager torch,
  step by step: a fixed ``maxiters`` of the membrane fixed point, float32,
  per-member step counts by masking.  The CPU tests use it, and
  ``chip_smoke.py`` holds the kernel against it.
* :func:`explicit_flops` counts the floating-point operations of one
  member-step from the reaction tables and the stencil.

Differences from the TPU kernel, all deliberate: the Laplacian is the
production form of ``ops/rhs.laplacian`` (not ``up - 2C + um``); the grid
may have up to ``MAX_NODES`` nodes (not 128); each member runs its own
``nt`` steps instead of a shared masked loop.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gab1_shp2_tpu_torch.models.params import (
    Params,
    resolve_device,
    stability_dt,
)
from gab1_shp2_tpu_torch.models.species import N_CYTO, N_MEMB
from gab1_shp2_tpu_torch.models.system import (
    ETOT_MEMBERS,
    Geometry,
    ReactionDiffusionSystem,
)
from gab1_shp2_tpu_torch.ops import _build
from gab1_shp2_tpu_torch.ops.explicit import uniform_initial_profile
from gab1_shp2_tpu_torch.ops.rates_codegen import rates_header
from gab1_shp2_tpu_torch.ops.rhs import (
    bc_closure,
    bulk_rates,
    effective_diffusivities,
    kdict,
    laplacian,
    memb_rates,
)

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# one thread per interior node, at most 1024 threads in a block
MAX_NODES = 1024 + 2


def _prepare(Co, params, R, dr, tf, maxiters, dev):
    """Shared argument handling: float32 tensors on ``dev`` and the
    per-member step sizes and counts."""
    Nr = int(round(R / dr))
    if Nr < 2:
        raise ValueError(f"the grid needs at least 3 nodes, got {Nr + 1}")
    if Nr + 1 > MAX_NODES:
        raise ValueError(
            f"grid {Nr + 1} nodes exceeds the kernel's {MAX_NODES}-node "
            f"limit (one thread per interior node, 1024 threads a block; "
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
# the wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def _library(system: ReactionDiffusionSystem):
    lib = _build.load_library(
        "explicit_solve", ["explicit_solve.cu"],
        {"explicit_rates.cuh": rates_header(system)})
    lib.explicit_solve_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, _P]
    lib.explicit_solve_launch.restype = ctypes.c_int
    return lib


def build(system: ReactionDiffusionSystem) -> None:
    """Build (or load) the kernel library for ``system`` now."""
    _library(system)


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
    :func:`solve_explicit_plain`.
    """
    global LAUNCHES
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

    lib = _library(system)
    stream = torch.cuda.current_stream(dev).cuda_stream
    step = B if block is None else int(block)
    for s in range(0, B, step):
        n = min(step, B - s)
        err = lib.explicit_solve_launch(
            c0.data_ptr(), m0.data_ptr(), k[s:].data_ptr(),
            d_eff[s:].data_ptr(), dts[s:].data_ptr(), nt[s:].data_ptr(),
            C_out[s:].data_ptr(), m_out[s:].data_ptr(), n, Nr, float(dr),
            int(system.geometry is Geometry.SPHERICAL), int(maxiters),
            stream)
        if err != 0:
            raise RuntimeError(f"explicit_solve kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
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
    """Floating-point operations of one member-step of the fused solve
    (adds, multiplies and divides, each counted as one):

    * per interior node (Nr-1 of them): the bulk reactions, and per
      species the stencil (4; the spherical metric term adds 3) and the
      update ``C + dt*(d*lap + rates)`` (4), plus ``r*dr`` once per node
      when spherical;
    * per fixed-point iteration: ``bc_closure`` (4 per surface binding,
      Etot, the SFK activation loss, 7 per species, 5 for aSFK),
      ``memb_rates`` (the membrane reactions and 6 per surface binding)
      and the membrane update (2 per species).
    """
    spherical = system.geometry is Geometry.SPHERICAL
    node = (_reaction_flops(system.bulk_reactions)
            + N_CYTO * (4 + 3 * spherical + 4) + int(spherical))
    nb = len(system.surface_bindings)
    closure = 4 * nb + len(ETOT_MEMBERS) + 2 + 7 * N_CYTO + 5
    memb = _reaction_flops(system.memb_reactions) + 6 * nb
    return (Nr - 1) * node + int(maxiters) * (closure + memb + 2 * N_MEMB)
