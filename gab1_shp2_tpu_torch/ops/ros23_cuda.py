"""Fused Rosenbrock23 step: the hand-written CUDA kernel and its plain twin.

Counterpart of ``gab1_shp2_tpu/ops/ros23_pallas.py``.  One launch of
``csrc/ros23_step.cu`` performs a whole Rosenbrock23 step for every lane:
Jacobian bands from the state, the factor of W = I - d*h*J by block
cyclic reduction, three stage solves and two right-hand-side
evaluations.  It returns ``(y_1, f(y_1), est)``, the same triple as the
unfused eager branch of ``batch_stiff._SolverCtx.step``.

* :func:`ros23_step_fused` is the wrapper.  On a CPU tensor it runs
  :func:`ros23_step_plain`; on a CUDA tensor it launches the kernel or
  raises.  ``LAUNCHES`` counts kernel launches.
* :func:`ros23_step_plain` composes the eager pieces (``lane_rhs``,
  ``lane_bands``, ``cr_factor_lanes``/``cr_solve_lanes``).  The CPU tests
  use it, and ``chip_smoke.py`` holds the kernel against it.
* ``rates_header`` (``ops/rates_codegen.py``, re-exported here)
  generates the kernel's rate functions from the system's reaction
  tables (``models/system.py``) at build time.
"""

from __future__ import annotations

import ctypes

import torch

from gab1_shp2_tpu_torch.models.species import K_NAMES, N_CYTO
from gab1_shp2_tpu_torch.models.system import (
    Geometry,
    ReactionDiffusionSystem,
)
from gab1_shp2_tpu_torch.ops import _build
from gab1_shp2_tpu_torch.ops.batch_stiff import (
    cr_factor_lanes,
    cr_solve_lanes,
    lane_rhs,
)
from gab1_shp2_tpu_torch.ops.jacobian import BLK, lane_bands
from gab1_shp2_tpu_torch.ops.rates_codegen import rates_header
from gab1_shp2_tpu_torch.ops.rhs import kdict
from gab1_shp2_tpu_torch.ops.trbdf2 import _ROS_D, _ROS_E32

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def ros23_step_plain(system: ReactionDiffusionSystem, y, f_n, h, k_batch,
                     d_eff, Nr: int, dr: float):
    """One Rosenbrock23 step for all lanes in eager torch.

    ``y``, ``f_n``: (NB, 10, B); ``h``: (B,); ``k_batch``: (B, 17);
    ``d_eff``: (B, 10).  Returns ``(y_1, f(y_1), est)``.
    """
    r64 = torch.arange(Nr + 1, dtype=torch.float64) * dr
    rj = r64[1:-1].to(dtype=y.dtype, device=y.device)
    k = kdict(k_batch)
    Lb, Db, Ub = lane_bands(system, y, k, d_eff, rj, dr)
    d = _ROS_D
    hb = h[None, None, None, :]
    hd = h[None, None, :]
    eye = torch.eye(BLK, dtype=y.dtype, device=y.device)[None, :, :, None]
    fac = cr_factor_lanes(-d * hb * Lb, eye - d * hb * Db, -d * hb * Ub)

    def f(yy):
        return lane_rhs(system, yy, k, d_eff, rj, dr)

    k1 = cr_solve_lanes(fac, f_n)
    f_half = f(y + 0.5 * hd * k1)
    k2 = cr_solve_lanes(fac, f_half - k1) + k1
    y_1 = y + hd * k2
    f_1 = f(y_1)
    k3 = cr_solve_lanes(fac, f_1 - _ROS_E32 * (k2 - f_half)
                        - 2.0 * (k1 - f_n))
    est = (hd / 6.0) * (k1 - 2.0 * k2 + k3)
    return y_1, f_1, est


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def _library(system: ReactionDiffusionSystem):
    lib = _build.load_library(
        "ros23_step", ["ros23_step.cu"],
        {"ros23_rates.cuh": rates_header(system)})
    lib.ros23_step_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, _P]
    lib.ros23_step_launch.restype = ctypes.c_int
    lib.ros23_scratch_per_lane.argtypes = [ctypes.c_int]
    lib.ros23_scratch_per_lane.restype = ctypes.c_longlong
    return lib


def build(system: ReactionDiffusionSystem) -> None:
    """Build (or load) the kernel library for ``system`` now."""
    _library(system)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ros23_step_fused(system: ReactionDiffusionSystem, y, f_n, h, k_batch,
                     d_eff, Nr: int, dr: float):
    """One fused Rosenbrock23 step for all lanes.

    ``y``, ``f_n``: (NB, 10, B) float32 with NB = Nr; ``h``: (B,);
    ``k_batch``: (B, 17) packed kinetics; ``d_eff``: (B, 10) effective
    diffusivities.  Returns ``(y_1, f(y_1), est)``.  On CPU tensors this
    is :func:`ros23_step_plain`; on CUDA tensors it launches the kernel
    on the current stream.
    """
    global LAUNCHES
    if y.device.type == "cpu":
        return ros23_step_plain(system, y, f_n, h, k_batch, d_eff, Nr, dr)
    if y.device.type != "cuda":
        raise ValueError(f"ros23_step_fused runs on CUDA or CPU tensors, "
                         f"got {y.device}")
    NB, blk, B = y.shape
    if blk != BLK or NB != int(Nr) or NB < 2:
        raise ValueError(f"y has shape {tuple(y.shape)}; expected "
                         f"({int(Nr)}, {BLK}, B) for Nr={Nr}")
    dev = y.device
    _check("y", y, (NB, BLK, B), dev)
    _check("f_n", f_n, (NB, BLK, B), dev)
    _check("h", h, (B,), dev)
    _check("k_batch", k_batch, (B, len(K_NAMES)), dev)
    _check("d_eff", d_eff, (B, N_CYTO), dev)

    lib = _library(system)
    NBp = _next_pow2(NB)
    scratch = torch.empty(lib.ros23_scratch_per_lane(NBp) * B,
                          dtype=torch.float32, device=dev)
    y1, f1, est = (torch.empty_like(y) for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ros23_step_launch(
        y.data_ptr(), f_n.data_ptr(), h.data_ptr(), k_batch.data_ptr(),
        d_eff.data_ptr(), y1.data_ptr(), f1.data_ptr(), est.data_ptr(),
        scratch.data_ptr(), NB, NBp, B, float(dr),
        int(system.geometry is Geometry.SPHERICAL), float(_ROS_D),
        float(_ROS_E32), stream)
    if err != 0:
        raise RuntimeError(f"ros23_step kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return y1, f1, est


def step_flops(NB: int) -> int:
    """Floating-point operations of the kernel's linear algebra for one
    lane (the factor of W and three solves, padded to a power of two);
    the band and right-hand-side terms, O(NB * reactions), are left out,
    so this is a lower bound of the step's work."""
    n = BLK
    inv, mm, mv = 2 * n**3, 2 * n**3, 2 * n**2
    nb = _next_pow2(NB)
    fac = inv                      # root inverse
    solve = mv                     # root matvec
    while nb > 1:
        hh = nb // 2
        fac += hh * inv + (6 * hh - 3) * mm
        solve += (2 * hh - 1) * mv + (3 * hh - 1) * mv
        nb = hh
    return fac + 3 * solve
