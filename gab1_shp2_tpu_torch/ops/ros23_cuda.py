"""Fused Rosenbrock23 step: the hand-written CUDA kernel and its plain twin.

Counterpart of ``gab1_shp2_tpu/ops/ros23_pallas.py``.  One launch of
``csrc/ros23_step.cu`` performs a whole Rosenbrock23 step for every lane
(one thread block per lane): Jacobian bands from the state, the factor of
W = I - d*h*J by block cyclic reduction, three stage solves and two
right-hand-side evaluations.  It returns ``(y_1, f(y_1), est)``, the same
triple as the unfused eager branch of ``batch_stiff._SolverCtx.step``.

* :func:`ros23_step_fused` is the wrapper.  On a CPU tensor it runs
  :func:`ros23_step_plain`; on a CUDA tensor it launches the kernel or
  raises.  ``LAUNCHES`` counts kernel launches.
* :func:`ros23_step_plain` composes the eager pieces (``lane_rhs``,
  ``lane_bands``, ``cr_factor_lanes``/``cr_solve_lanes``).  The CPU tests
  use it, and ``chip_smoke.py`` holds the kernel against it.
* ``rates_header`` (``ops/rates_codegen.py``, re-exported here)
  generates the kernel's rate functions from the system's reaction
  tables (``models/system.py``) at build time.
* :func:`arena_bytes` and :func:`arena_in_shared` give the size of the
  kernel's per-lane working storage and where it lies (shared memory, or
  a global scratch tensor that the wrapper allocates), by the formula of
  the source's header note.
* :func:`ros23_step_probe` and :func:`blocks_per_sm` are for
  measurements (``chip_smoke.py``): the same kernel stopped after a part,
  or with its arena forced into global memory; and the occupancy
  calculator's answer.
"""

from __future__ import annotations

import ctypes
import functools
import threading

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


# the 227 KB of shared memory a block may ask for on Hopper, less 256 B
# for the kernel's static part (SHARED_ARENA_MAX in csrc/ros23_step.cu)
SHARED_ARENA_MAX = 232448 - 256


def arena_bytes(NB: int) -> int:
    """Bytes of one lane's arena in the kernel for ``NB`` block rows.

    Level l of the cyclic reduction has n_l rows (n_0 = NB, n_{l+1} =
    ceil(n_l / 2), down to 1).  The arena holds NB diagonal blocks,
    level 0's LDinv and UDinv (n_1 blocks each), the two dense boundary
    blocks, n_l blocks of L and of U for every level between the first
    and the root, level 0's L and U as two 10-vectors per row, 7 vectors
    of NB*10 and the right-hand sides of every level.
    """
    n = [int(NB)]
    while n[-1] > 1:
        n.append((n[-1] + 1) // 2)
    n1 = n[1] if len(n) > 1 else 0       # NB = 1: no level below, as in C
    blocks = NB + 2 * n1 + 2 + 2 * sum(n[1:-1])
    floats = BLK * BLK * blocks + (2 + 7) * BLK * NB + BLK * sum(n)
    return 4 * floats


def arena_in_shared(NB: int) -> bool:
    """Whether the kernel keeps a lane's arena in shared memory; if not,
    the wrapper allocates one lane-major arena per lane in global memory.
    The choice depends on the shape alone."""
    return arena_bytes(NB) <= SHARED_ARENA_MAX


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


@functools.lru_cache(maxsize=None)
def _library(system: ReactionDiffusionSystem):
    # cached per system: generating and hashing the sources on every step
    # would cost more host time than the kernel takes on the card
    lib = _build.load_library(
        "ros23_step", ["ros23_step.cu"],
        {"ros23_rates.cuh": rates_header(system)})
    step = [_P] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.ros23_step_launch.argtypes = step + [_P]
    lib.ros23_step_launch.restype = ctypes.c_int
    # the same kernel with a part to stop after, for measurements
    lib.ros23_step_probe.argtypes = step + [ctypes.c_int, _P]
    lib.ros23_step_probe.restype = ctypes.c_int
    lib.ros23_arena_bytes.argtypes = [ctypes.c_int]
    lib.ros23_arena_bytes.restype = ctypes.c_longlong
    lib.ros23_arena_in_shared.argtypes = [ctypes.c_int]
    lib.ros23_arena_in_shared.restype = ctypes.c_int
    lib.ros23_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.ros23_blocks_per_sm.restype = ctypes.c_int
    return lib


def build(system: ReactionDiffusionSystem) -> None:
    """Build (or load) the kernel library for ``system`` now."""
    _library(system)


@functools.lru_cache(maxsize=None)
def _checked_arena(system: ReactionDiffusionSystem, NB: int):
    """The library and the bytes of one lane's arena, once per shape: the
    library's layout must be the one :func:`arena_bytes` mirrors."""
    lib = _library(system)
    nbytes = lib.ros23_arena_bytes(NB)
    if nbytes != arena_bytes(NB):
        raise RuntimeError(f"the kernel library lays out {nbytes} B per "
                           f"lane for NB={NB}, arena_bytes gives "
                           f"{arena_bytes(NB)}")
    return lib, nbytes


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


def _launch(system, y, f_n, h, k_batch, d_eff, dr, *, stop_after=None,
            global_arena=None):
    """Check the CUDA tensors, allocate outputs (and the global arenas
    where the shape needs them) and launch the kernel on the current
    stream; raises if the card refuses the launch.  ``stop_after`` selects
    the measuring entry of the library (see :func:`ros23_step_probe`)."""
    NB, _, B = y.shape
    dev = y.device
    _check("y", y, (NB, BLK, B), dev)
    _check("f_n", f_n, (NB, BLK, B), dev)
    _check("h", h, (B,), dev)
    _check("k_batch", k_batch, (B, len(K_NAMES)), dev)
    _check("d_eff", d_eff, (B, N_CYTO), dev)

    lib, nbytes = _checked_arena(system, NB)
    if global_arena is None:
        global_arena = not arena_in_shared(NB)
    scratch = None
    if global_arena:
        scratch = torch.empty(nbytes // 4 * B, dtype=torch.float32,
                              device=dev)
    y1, f1, est = (torch.empty_like(y) for _ in range(3))
    args = [y.data_ptr(), f_n.data_ptr(), h.data_ptr(), k_batch.data_ptr(),
            d_eff.data_ptr(), y1.data_ptr(), f1.data_ptr(), est.data_ptr(),
            None if scratch is None else scratch.data_ptr(), NB, B,
            float(dr), int(system.geometry is Geometry.SPHERICAL),
            float(_ROS_D), float(_ROS_E32)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if stop_after is None:
        err = lib.ros23_step_launch(*args, stream)
    else:
        err = lib.ros23_step_probe(*args, int(stop_after), stream)
    if err != 0:
        raise RuntimeError(f"ros23_step kernel launch failed: CUDA error "
                           f"{err}")
    return y1, f1, est


def ros23_step_fused(system: ReactionDiffusionSystem, y, f_n, h, k_batch,
                     d_eff, Nr: int, dr: float):
    """One fused Rosenbrock23 step for all lanes.

    ``y``, ``f_n``: (NB, 10, B) float32 with NB = Nr; ``h``: (B,);
    ``k_batch``: (B, 17) packed kinetics; ``d_eff``: (B, 10) effective
    diffusivities.  Returns ``(y_1, f(y_1), est)``.  On CPU tensors this
    is :func:`ros23_step_plain`; on CUDA tensors it launches the kernel
    on the current stream.
    """
    if y.device.type == "cpu":
        return ros23_step_plain(system, y, f_n, h, k_batch, d_eff, Nr, dr)
    if y.device.type != "cuda":
        raise ValueError(f"ros23_step_fused runs on CUDA or CPU tensors, "
                         f"got {y.device}")
    NB, blk, B = y.shape
    if blk != BLK or NB != int(Nr) or NB < 2:
        raise ValueError(f"y has shape {tuple(y.shape)}; expected "
                         f"({int(Nr)}, {BLK}, B) for Nr={Nr}")
    out = _launch(system, y, f_n, h, k_batch, d_eff, dr)
    count_launch()
    return out


def ros23_step_probe(system: ReactionDiffusionSystem, y, f_n, h, k_batch,
                     d_eff, dr: float, *, stop_after: int = 3,
                     global_arena=None):
    """The same kernel for measurements on CUDA tensors: it returns after
    part ``stop_after`` (1: the bands, 2: the factor, 3: the whole step)
    and leaves the outputs unwritten unless it is 3; ``global_arena=True``
    puts the arenas in global memory whatever the shape.  The solver
    never calls this, and it does not count in ``LAUNCHES``."""
    return _launch(system, y, f_n, h, k_batch, d_eff, dr,
                   stop_after=stop_after, global_arena=global_arena)


def blocks_per_sm(system: ReactionDiffusionSystem, NB: int,
                  global_arena=None) -> int:
    """Resident blocks (of 256 threads) per SM that the card's occupancy
    calculator gives the kernel for ``NB`` block rows."""
    if global_arena is None:
        global_arena = not arena_in_shared(NB)
    n = _library(system).ros23_blocks_per_sm(int(NB), int(global_arena))
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def step_flops(NB: int) -> int:
    """Floating-point operations that the step's linear algebra needs for
    one lane: the factor of W by block cyclic reduction on its own rows
    (n_0 = NB, n_{l+1} = ceil(n_l / 2), no padding) and three solves.

    W's level-0 off-diagonal blocks are diagonal apart from the membrane
    row's L and the last interior row's U, so a product or a matvec with
    one of them is a scaling (100 or 10 multiplies); every other product
    costs 2*10^3, a Gauss-Jordan inverse 2*10^3, a matvec 2*10^2.  The
    subtractions that join the products, and the band and right-hand-side
    terms, O(NB * reactions), are left out, so this is a lower bound of
    the step's work.
    """
    s = BLK
    inv, mm, mv = 2 * s**3, 2 * s**3, 2 * s**2

    def off_diag(level, row, n, lower):
        """Cost class of L (lower) or U of a row: None where it is absent,
        True where it is dense."""
        if (row == 0) if lower else (row == n - 1):
            return None
        if level > 0:
            return True
        return row == (NB - 1 if lower else NB - 2)

    def cost(dense, full, scaled):
        return 0 if dense is None else (full if dense else scaled)

    fac = inv                      # root inverse
    solve = mv                     # root matvec
    n, level = int(NB), 0
    while n > 1:
        nt = (n + 1) // 2
        for i in range(nt):
            odd = 2 * i + 1 < n
            if i > 0:
                # LDinv_i = L(2i) Dinv, its share of D', and L'
                fac += cost(off_diag(level, 2 * i, n, True), mm, s * s)
                fac += cost(off_diag(level, 2 * i - 1, n, False), mm, s * s)
                fac += cost(off_diag(level, 2 * i - 1, n, True), mm, s * s)
                solve += mv        # forward: LDinv_i b(2i-1)
            if odd:
                # Dinv of the odd row, UDinv_i, its share of D', and U'
                fac += inv
                fac += cost(off_diag(level, 2 * i, n, False), mm, s * s)
                fac += cost(off_diag(level, 2 * i + 1, n, True), mm, s * s)
                fac += cost(off_diag(level, 2 * i + 1, n, False), mm, s * s)
                solve += mv        # forward: UDinv_i b(2i+1)
                # backward: Dinv (b - L x'_i - U x'_{i+1})
                solve += mv
                solve += cost(off_diag(level, 2 * i + 1, n, True), mv, s)
                solve += cost(off_diag(level, 2 * i + 1, n, False), mv, s)
        n, level = nt, level + 1
    return fac + 3 * solve
