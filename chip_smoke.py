#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gab1_shp2_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's two CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version, drives the stiff ensemble
solver and the explicit path through their public entry points at the
bench configuration (base spherical model, dr=0.2, tf=5 min, N=1024,
f32; the stiff solves with Nts=2, rtol 1e-4, atol 1e-7), then the
ensemble engine and the GSA runner, and checks the results.  Phases:

  0. set-up: card, power limit, versions, both kernel builds (nvcc,
     sm_90a, started together);
  1. the fused Rosenbrock23 kernel against ros23_step_plain on
     mid-transient states of the base, rect and memb_sfk systems: at
     B=256, dr=0.2 (NB=50, the arena in shared memory, two blocks an SM),
     and at B=64 on dr=0.1 (NB=100, shared, one block an SM) and dr=0.05
     (NB=200, the arena in global memory); CUDA-event times of both at
     B=256, of the kernel at B=1, 132, 264 and 1024, of its parts (bands,
     factor, solves and right-hand sides) and of the arena in global
     memory, the kernel's as device times of launches replayed from a CUDA
     graph; blocks per SM from the occupancy calculator;
  2. the main path through the kernel: chunked f32 Rosenbrock23
     (step_impl="fused"), N=1024 in chunks of 256; launch counts are
     reset just before and read just after; chunk 0 is compared with the
     unfused step (step_impl="torch");
  3. the bench headline in eager PyTorch: f32 RODAS4 under the
     lane-refill scheduler, N=1024, 256 lanes; member 0 against a tight
     f64 RODAS4 solve (members 0-3 at rtol 1e-7, solved once on the
     host's CPU for this phase and phases 5 and 9);
  4. the fused explicit solve against solve_explicit_plain at B=256,
     tf=0.25 for base and tf=0.1 for rect and memb_sfk, at B=37 (an odd
     count), and on
     finer grids (101, 201 and 501 nodes: each layout of the kernel);
     CUDA-event times of the plain version and of the kernel at that
     shape;
  5. the explicit path at full width through the kernel: N=1024, tf=5,
     about 37,000 steps per member in one launch; the launch count is
     reset just before and read just after; members 0-3 against tight
     f64 RODAS4 solves; CUDA-event times at N=1024 and N=4096; the
     serial-chain floor beside the bound; registers and blocks per SM of
     each layout;
  6. the engine and the GSA runner: eager run_ensemble(solver="explicit")
     against the kernel (tf=0.25), run_ensemble(solver="stiff") with the 6 GSA
     outputs and masked_quantiles, and a 325-solve eFAST sweep over the
     initial concentrations;
  7. the single-member stiff solver and the inference path at the fit
     configuration (base system, default_co(), dr=0.2, tf=5, rtol 1e-4,
     atol 1e-7, Nts=2, float64 state): solve_stiff with trbdf2 and rodas4
     against solve_stiff_batch (B=1) on the card and a CPU solve; the log
     posterior's value and forward-mode gradient through its autograd
     Function against central finite differences; a scaled-down map_fit
     with one LBFGS iteration in each of its stages;
     the surrogate route of the fit_and_infer workload (a small Chebyshev
     grid of batched solves, 4 NUTS chains on the surrogate, the exact
     likelihood at the draws, importance reweighting, split R-hat, ESS
     and divergences); no kernel of its own (the JAX package computes
     this path with no Pallas kernel);
  8. the workload drivers (gab1_shp2_tpu_torch.workloads), in a process
     of its own on the card beside phase 7, each through its main() with
     --outdir a temporary directory (DRIVER_ARGS lists
     their command lines and the cuts): run_base_model at --n 200, then
     at a small configuration on the card and on the CPU (the CSVs agree
     within 1e-8); pulse_chase (RMSE against the reaction-only ODE trace
     below 20); run_variants --variant hela; length_scales;
     calc_rxn_rates; gsa_driver --target dk --samples 65; fit_and_infer's
     NUTS stage on the committed surrogate with its exact reweighting and
     16 predictive draws; plot_parameter_distributions where matplotlib
     is installed (without it the figure helpers record what they would
     draw).  Every ensemble, evaluator and observable call is checked to
     run on the card, and a member lost fails the phase; no kernel of its
     own (no driver reaches a Pallas kernel in the JAX package);
  9. the mesh, the mixed RHS, imaging and the trace: (a) run_ensemble
     sharded over a mesh of two slots of the card (two worker threads,
     each its own refill queue) on the first 512 members of phase 3's
     ensemble, against phase 3; (b) the sorted scheduler sharded (N=128,
     one super-chunk of 2 x 64) against the unsharded sorted run in
     chunks of 64; (c)
     run_sharded_batch of the fused Rosenbrock23 path (B=256), kernel B1
     launched from the worker threads, launch counts reset just before
     and read just after, against the unsharded batch (and over every
     card where there are several); (d) the north star (f64 state, f32
     linear algebra, RODAS4 at rtol 1e-6, 256 members, lane refill) with
     rhs_mixed False, "df32" and True, member 0 against the f64
     reference, df32 against native f64; (e) PLA puncta counts and cell
     labels of a synthetic 8 x 1024^2 plate on the card and on the
     host's CPU, equal; (f) a torch.profiler trace of a refill group holding CUDA
     kernel events; no kernel of its own (the JAX package reaches no
     Pallas kernel on these paths);
 10. the bench entry point (gab1_shp2_tpu_torch.bench, the port of
     bench.py) through its own row functions at reduced depth (BENCH_RUN:
     N=256, one warm-up and one timed run a row): the refill headline,
     the contiguous-chunk row, the north star and the GSA recipe against
     bench.py's tight reference (solve_stiff, TRBDF2, f64, rtol 1e-8, on
     the host's CPU), the roofline block, and run_mesh over the card;
     gates: 0 failed in every row, each row's error against the
     reference within ACCURACY_LIMIT, pct_hbm_peak at most 100, the mesh
     run consistent with the single queue, both lines serialise; no
     kernel of its own (bench.py's rows reach no Pallas kernel);
 11. one JSON line describing every ported kernel.

The host's CPU works beside the card: a pool of HOST_WORKERS worker
processes, started before phase 0, solves the two f64 references (phase
3's RODAS4 solve of members 0-3 and the bench's TRBDF2 solve of member
0) and the plate's CPU counts of phase 9(e) while the card runs phases
0-8; a phase that needs one waits for it.  These workers see no CUDA
device.  Phases 7 and 8 both pace the card from the host (eager solves,
no kernel of the port): phase 8 runs in a second process on the card
while phase 7 runs in this one, and its log follows phase 7's.  Every
worker ends with the script.

Every phase raises on failure.  The last line of standard output is
``{"ok": true, "device": {...}}``.  It needs no network and imports no
JAX.  With no CUDA device it exits with status 2 and prints no result.
"""

import concurrent.futures
import json
import multiprocessing
import os
import statistics
import sys
import time

import numpy as np

N = 1024
CHUNK = 256
CFG = dict(dr=0.2, tf=5.0, Nts=2, rtol=1e-4, atol=1e-7)
# finer grids of phase 1, as (dr, lanes): dr=0.1 (NB=100, the kernel's arena
# fills an SM's shared memory) and dr=0.05 (NB=200, it lies in global memory)
FINE_GRIDS = ((0.1, 64), (0.05, 64))
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 on the CUDA cores (dense)
PEAK_HBM_BPS = 3.35e12   # H100 SXM HBM3
# the tight f64 RODAS4 reference of phases 3 and 5 (members 0-3); rtol 1e-8
# until phase 7 joined the script, 1e-7 since: a cut of depth, about 1.8x
# fewer steps, with the reference's error still far below the errors it
# measures
REF_TOL = dict(rtol=1e-7, atol=1e-10)
# fused f32 explicit solve against the f64 RODAS4 reference, as
# max |dC| / (|C| + 0.2) over members 0-3 (3.8e-4 on an NVIDIA H100; phase 5)
EXPLICIT_VS_STIFF = 1e-3
# cycles a dependent f32 operation takes at least on the card (the FMA
# pipeline's latency on Hopper)
CYCLES_PER_CHAIN_OP = 4
# phase 7: the fit configuration (inference/loss.make_observable_fn's
# defaults: trbdf2, float64 state), the prior modes of the four fitted
# parameters, and the smoke run's cuts of the inference workload
FIT = dict(dr=0.2, tf=5.0, rtol=1e-4, atol=1e-7)
FIT_MODES = (0.42, 9.5, 0.42, 9.5)
FD_STEP = 1e-4
# map_fit: the workload runs 101 starts, LBFGS from the best 8 for 30
# iterations, then a dr=0.1 refinement.  Here: 2 starts (seed 123; the
# better one's loss, 0.026, is off the loss floor, where a line search's
# interval search doubles its step about a dozen times, each a
# value-and-gradient solve), LBFGS from the better start for one iteration,
# then one iteration of the refinement, at dr=0.2 (the fit configuration's
# grid; the reference refines at dr=0.1)
MAP_ARGS = dict(n_starts=2, n_local=1, max_iters=1, dr_coarse=0.2,
                dr_fine=0.2, rtol=1e-4, seed=123)
# Chebyshev nodes per axis: 4^4 = 256 solves (the workload: 17^4 = 83,521)
SUR_GRID = 4
NUTS_RUN = dict(chains=4, warmup=60, samples=50, max_depth=6, seed=0)
# phase 8: each workload driver's command line (its main(argv) with
# --outdir a temporary directory), at the driver's defaults (run_base_model
# at its --n 200; the reference's lowest ensemble size, 1000, was cut to
# hold the script's wall) except: gsa_driver at 65 samples a parameter (the
# reference's 1000; 65 is the least eFAST takes with 4 harmonics);
# fit_and_infer's NUTS stage on the committed 17^4 surrogate (rebuilding it
# is 83,521 solves), 4 chains x (300 warmup + 200 draws) instead of 5 x
# (500 + 1000), and 16 predictive draws instead of 500.  Its chains run on
# the card (the driver's default), and its 800 exact reweighting solves go
# in one batch (--chunk 1024).  The draws:
# the driver exits 1 when split R-hat exceeds 1.05, and in CPU runs of the
# port over seeds 0-7, 4 x 50 draws passed 3 of 8 (300 warmup) and 4 of 8
# (500 warmup), 4 x 100 passed 7 of 8, 4 x 200 all 8
DRIVER_ARGS = {
    "run_base_model": [],
    "pulse_chase": [],
    "run_variants": ["--variant", "hela"],
    "length_scales": [],
    "calc_rxn_rates": [],
    "gsa_driver": ["--target", "dk", "--samples", "65"],
    "fit_and_infer": ["--stage", "nuts", "--likelihood", "surrogate",
                      "--chains", "4", "--warmup", "300", "--samples", "200",
                      "--predictive", "16", "--chunk", "1024"],
    "plot_parameter_distributions": [],
}
# run_base_model at a small configuration, on the card and on the host's
# CPU; the two pct_shp2_bound_gab1.csv rows agree within phase 7's
# card-against-CPU limit for pct_shp2_bound_gab1
DRIVER_SMALL = ["--n", "8", "--dr", "0.5", "--nts", "4", "--rtol", "1e-3",
                "--linsolve", "none"]
DRIVER_SMALL_RTOL = 1e-8
# phase 9: the mesh, the mixed RHS, imaging.  f32 parity of a sharded run
# against the single-device one: per-member results do not depend on the
# sharding, but f32 reductions may follow a batch's width (relative 2e-3
# against phase 3's refill, the f32 parity bound; the JAX test's rtol
# 5e-5, atol 1e-8 where both runs solve batches of the same width)
SHARD_REL = 2e-3
SHARD_RTOL, SHARD_ATOL = 5e-5, 1e-8
# (a) the first SHARD_N members of phase 3's ensemble, 256 lanes a slot;
# (b) SORTED_RUN: one super-chunk of 2 x 64 (both cut by half, from 1024
# and 256 members, to hold the script's wall)
SHARD_N = 512
SORTED_RUN = dict(n=128, chunk=64)
FUSED_MESH_B = 256
# the north star (bench.py): f64 state, f32 linear algebra, RODAS4 at rtol
# 1e-6 under the lane refill, 256 members; the gates of
# tests/test_df32.py::TestDf32StiffPath for "df32" against native f64
NORTH_STAR = dict(dr=0.2, tf=5.0, Nts=2, rtol=1e-6, atol=1e-9)
NORTH_STAR_N = 256
DF32_STEPS, DF32_REL = 2, 2e-5
ACCURACY_LIMIT = 1e-3
# the synthetic imaging plate: 8 images of 1024^2 pixels, 9 disk cells an
# image with puncta inside them, spots on a sloped background
PLATE = dict(n=8, H=1024, seed=0)
# the traced refill group: its first steps only (every eager operation is
# a few events; a whole solve's trace runs to hundreds of MB)
TRACE_RUN = dict(n=16, tf=0.005)
# phase 10: the bench module's rows at N=256 with one timed run a row
# (bench.py: N=1024, the headline and chunked rows the median of 3)
BENCH_RUN = dict(N=256, runs=1)
# the host pool beside the card: worker processes, torch threads each, and
# the longest a phase waits for a worker's result
HOST_WORKERS = 2
HOST_THREADS = 2
HOST_WAIT_S = 900


def log(msg):
    print(msg, flush=True)


def chain_ops(system, maxiters):
    """Floating-point operations on the longest dependency path of one
    member-step of csrc/explicit_solve.cu, a fused multiply-add counted as
    one: what no kernel can run in parallel, since a member's steps run in
    order.  Shuffles and selects, which move values between lanes, count
    zero.  A model of the kernel's code, counted by hand from it.

    Per fixed-point iteration, from the membrane iterate to the next one:
    the binding's loss ``kf*m``, ``1 + l*q``, the quotient (reciprocal,
    product and the two operations of its correction), ``kf*CR`` and the
    net, the membrane rate's accumulations (the most terms one membrane
    species takes) and the update.  The first iteration waits instead for
    C_near, node Nr-1's update from the last step's CR (the second
    difference and its scale, 3; the metric term when spherical, 1; ``d*lap
    + rates`` and ``C + dt*...``, 2), then ``cn + g*q`` and the product:
    the loss and the reciprocal run beside the node update.  The last
    iteration's boundary values (Etot, iSFK's quotient, aSFK) run beside its
    chain and are no longer.
    """
    terms = {}
    for sb in system.surface_bindings:
        for name in (sb.memb, sb.product):
            terms[name] = terms.get(name, 0) + 1
    tail = 2 + 2 + max(terms.values()) + 1        # correction, net, dm, mm
    per_iter = 1 + 1 + 2 + tail                   # loss, 1 + l q, rcp, product
    node = 3 + (system.geometry.name == "SPHERICAL") + 2
    first = node + 1 + 1 + tail                   # C_near, cn + g q, product
    return first + (int(maxiters) - 1) * per_iter


def chain_floor_ms(system, steps, maxiters, sm_clock_khz):
    """The serial-chain floor of a launch whose longest member takes
    ``steps`` steps: ``steps * chain_ops * CYCLES_PER_CHAIN_OP`` cycles at
    ``sm_clock_khz``."""
    cycles = int(steps) * chain_ops(system, maxiters) * CYCLES_PER_CHAIN_OP
    return cycles / float(sm_clock_khz)


def state_from_solution(sol, Nr):
    """Lane-minor state y (NB, 10, B) at the last save of ``sol``."""
    import torch

    C = sol.C[:, -1, :, 1:Nr]                  # (B, 10, M) interior nodes
    m = sol.m[:, -1]                           # (B, 8)
    B = C.shape[0]
    memb = torch.cat([m.T, m.new_zeros((2, B))], dim=0)
    return torch.cat([C.permute(2, 1, 0), memb[None]], dim=0).contiguous()


def cuda_ms(fn, reps, warmup=2):
    """Median CUDA-event time of ``fn`` in ms over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps=25, launches=20):
    """Device time of one call of ``fn`` in ms: ``launches`` calls are
    captured into a CUDA graph, and the median CUDA-event time of ``reps``
    replays is divided by ``launches``.  For kernels that take less time
    than the host needs to enqueue them, which :func:`cuda_ms` would time
    as the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches


def plain_floor(args, yp, fp):
    """The f32 floor of the direct comparisons: relative norms of the
    differences in y1 and f1 between ros23_step_plain on the CPU (another
    op order) and its results ``yp``, ``fp`` on the card, for the same
    arguments."""
    import torch
    from gab1_shp2_tpu_torch.ops import ros23_cuda

    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    yc, fc, _ = ros23_cuda.ros23_step_plain(*cpu)
    return (float((yc - yp.cpu()).norm() / yc.norm()),
            float((fc - fp.cpu()).norm() / fc.norm()))


def step_case(g, name, system, batch, dev, B, dr):
    """The kernel against ros23_step_plain on a mid-transient state of the
    first ``B`` bench members on the grid ``dr``; raises if they disagree.
    Returns the errors, the step's arguments, the members and a solver
    context for that grid."""
    import torch
    from gab1_shp2_tpu_torch.ops import ros23_cuda
    from gab1_shp2_tpu_torch.ops.batch_stiff import (_SolverCtx,
                                                     make_mol_rhs_lanes)
    from gab1_shp2_tpu_torch.ops.rhs import effective_diffusivities

    R = 10.0
    Nr = int(round(R / dr))
    p = g.Params.unpack(torch.as_tensor(batch[:B], dtype=torch.float32,
                                        device=dev))
    Co = g.default_co(dtype=torch.float32, device=dev)
    h = torch.as_tensor(np.logspace(-3, -1, B), dtype=torch.float32,
                        device=dev)
    # a mid-transient state: the ensemble stepped to t=0.5 min
    sol = g.solve_stiff_batch(system, Co, p, device=dev, dr=dr, tf=0.5,
                              Nts=1, rtol=1e-4, atol=1e-7, method="rodas4")
    y = state_from_solution(sol, Nr)
    rhs, _ = make_mol_rhs_lanes(system, R, dr)
    f_n = rhs(y, p).contiguous()
    k = p.k.contiguous()
    d_eff = effective_diffusivities(system, p).contiguous()
    args = (system, y, f_n, h, k, d_eff, Nr, dr)
    yk, fk, ek = ros23_cuda.ros23_step_fused(*args)
    yp, fp, ep = ros23_cuda.ros23_step_plain(*args)
    torch.cuda.synchronize()
    for t in (yk, fk, ek):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{name}: the kernel returned non-finite "
                               "values")
    ctx = _SolverCtx(system, R, dr, 2, 1e-4, 1e-7, 5.0, torch.float32,
                     dev, None, "rosenbrock23", "torch")
    err_y = float((yk - yp).norm() / yp.norm())
    err_f = float((fk - fp).norm() / fp.norm())
    # f1 = f(y1): the plain right-hand side at the kernel's own y1
    # isolates the kernel's RHS from the y1 rounding, which the stiff
    # Jacobian amplifies by ~|J||y|/|f| in the direct comparison
    f_at_yk = rhs(yk, p)
    err_fc = float((fk - f_at_yk).norm() / f_at_yk.norm())
    err_e = float(ctx.scaled_norm(ek - ep, y, yp).max())
    abs_y = float((yk - yp).abs().max())
    arena = ("shared" if ros23_cuda.arena_in_shared(Nr) else "global")
    log(f"  {name} NB={Nr} B={B} ({arena} arena): y1 rel-norm err "
        f"{err_y:.3e}; f1 rel-norm err {err_f:.3e} (vs f(kernel y1): "
        f"{err_fc:.3e}); est scaled-norm diff {err_e:.3e}; y1 max abs err "
        f"{abs_y:.3e}")
    # the direct f1 limit is 1e-3 down to dr=0.1.  On a finer grid the
    # stiffness amplifies y1's rounding further, and the limit comes from
    # the twin's own f32 floor there: three times the f1 difference of the
    # same plain step run on the CPU (another op order) and on the card
    lim_f = 1e-3
    if dr < 0.1:
        _, floor_f = plain_floor(args, yp, fp)
        lim_f = max(1e-3, 3.0 * floor_f)
        log(f"  {name} NB={Nr}: plain step CPU vs card f1 rel-norm "
            f"{floor_f:.3e}; direct f1 limit {lim_f:.3e}")
    if not (err_y <= 1e-4 and err_fc <= 1e-4 and err_f <= lim_f
            and err_e <= 1e-2):
        raise RuntimeError(f"{name} NB={Nr}: kernel disagrees with "
                           "ros23_step_plain")
    if arena == "shared" and Nr > 50:
        # the same launch with the arena in global memory: the same bits,
        # so the same limits hold on that path at this shape
        before = ros23_cuda.LAUNCHES
        in_global = ros23_cuda.ros23_step_probe(system, y, f_n, h, k, d_eff,
                                                dr, global_arena=True)
        torch.cuda.synchronize()
        ros23_cuda.LAUNCHES = before
        if not all(torch.equal(a, b)
                   for a, b in zip((yk, fk, ek), in_global)):
            raise RuntimeError(f"{name} NB={Nr}: the global arena gives "
                               "other bits than the shared one")
        log(f"  {name} NB={Nr} B={B} (global arena): bit-identical to the "
            "shared arena")
    errs = dict(err_y=err_y, err_f=err_f, err_fc=err_fc, err_e=err_e,
                abs_y=abs_y)
    return errs, args, p, ctx, (yp, fp)


def phase1(g, batch, dev, rows):
    """Kernel against its plain version on mid-transient states."""
    import torch
    from gab1_shp2_tpu_torch.ops import ros23_cuda

    B, dr = CHUNK, CFG["dr"]
    Nr = int(round(10.0 / dr))
    systems = (("base", g.base_system()), ("rect", g.rect_system()),
               ("memb_sfk", g.memb_sfk_system()))
    result = []
    for name, system in systems:
        errs, args, p, ctx, (yp, fp) = step_case(g, name, system, batch, dev,
                                                 B, dr)
        result.append(errs)
        if name == "base":
            floor_y, floor_f = plain_floor(args, yp, fp)
            log(f"  base, plain step CPU vs card: y1 rel-norm "
                f"{floor_y:.3e}, f1 rel-norm {floor_f:.3e}")
            base = (system, args, p, ctx)
    fine = []
    for fine_dr, fine_B in FINE_GRIDS:
        for name, system in systems:
            errs, fargs, _, _, _ = step_case(g, name, system, batch, dev,
                                             fine_B, fine_dr)
            result.append(errs)
            if name == "base":
                fine.append(fargs)

    system, args, p, ctx = base
    _, y, f_n, h, k, d_eff, _, _ = args
    before = ros23_cuda.LAUNCHES

    def lanes(n):
        """The step's arguments for n lanes: the B states, tiled or cut."""
        m = -(-n // B)
        return (system, y.repeat(1, 1, m)[..., :n].contiguous(),
                f_n.repeat(1, 1, m)[..., :n].contiguous(),
                h.repeat(m)[:n].contiguous(),
                k.repeat(m, 1)[:n].contiguous(),
                d_eff.repeat(m, 1)[:n].contiguous(), Nr, dr)

    # device times of the kernel: 20 launches replayed from a CUDA graph,
    # median of 25 replays; one call launched alone from Python is paced by
    # the host and timed beside it
    ms = graph_ms(lambda: ros23_cuda.ros23_step_fused(*args))
    call_ms = cuda_ms(lambda: ros23_cuda.ros23_step_fused(*args), reps=25)
    plain_ms = cuda_ms(lambda: ros23_cuda.ros23_step_plain(*args),
                       reps=5, warmup=1)
    # other lane counts (the same states, tiled): 132 blocks are one per
    # SM, 264 two per SM; four times the lanes show how the time scales
    by_lanes = {}
    for n in (1, 132, 264, 4 * B):
        a_n = lanes(n)
        by_lanes[n] = graph_ms(lambda: ros23_cuda.ros23_step_fused(*a_n))
    ms4 = by_lanes[4 * B]
    flops = ros23_cuda.step_flops(Nr) * B
    nbytes = 4 * (5 * y.numel() + h.numel() + k.numel() + d_eff.numel())
    bound_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BPS)
    bound_by = ("operations" if flops / PEAK_F32_FLOPS
                >= nbytes / PEAK_HBM_BPS else "bytes")
    log(f"  base B={B}: kernel {ms:.4f} ms per launch (20 launches in a "
        f"CUDA graph, median of 25 replays; one call launched alone: "
        f"{call_ms:.4f} ms, median of 25), plain {plain_ms:.4f} ms (median "
        f"of 5); bound {bound_s * 1e3:.5f} ms by {bound_by} "
        f"({flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.3f} MB)")
    log(f"  base B=1: kernel {by_lanes[1]:.4f} ms, B=132: "
        f"{by_lanes[132]:.4f} ms, B=264: {by_lanes[264]:.4f} ms, "
        f"B={4 * B}: {ms4:.4f} ms (graph replays as above)")

    # occupancy and arena, from the library
    occ = {}
    for nb in (Nr, fine[0][6], fine[1][6]):
        occ[nb] = dict(
            arena_bytes=ros23_cuda.arena_bytes(nb),
            arena="shared" if ros23_cuda.arena_in_shared(nb) else "global",
            blocks_per_sm=ros23_cuda.blocks_per_sm(system, nb))
        log(f"  NB={nb}: arena {occ[nb]['arena_bytes']} B per lane in "
            f"{occ[nb]['arena']} memory, {occ[nb]['blocks_per_sm']} blocks "
            f"of 256 threads per SM (occupancy calculator)")

    # the kernel's parts: the same kernel stopped after the bands and
    # after the factor, timed in turns with the whole step
    def probe(**kw):
        return lambda: ros23_cuda.ros23_step_probe(system, y, f_n, h, k,
                                                   d_eff, dr, **kw)

    t_bands = graph_ms(probe(stop_after=1))
    t_factor = graph_ms(probe(stop_after=2))
    t_all = graph_ms(probe(stop_after=3))
    parts = dict(bands=t_bands, factor=t_factor - t_bands,
                 solves_rhs=t_all - t_factor)
    log(f"  parts at B={B} (graph replays; loads and bands {t_bands:.4f}, "
        f"through the factor {t_factor:.4f}, whole step {t_all:.4f} ms): "
        f"bands {parts['bands']:.4f}, factor {parts['factor']:.4f}, three "
        f"solves + two RHS + stores {parts['solves_rhs']:.4f} ms")
    # the arena in global memory at the bench shape, in turns with the
    # shared one
    tglob = graph_ms(probe(global_arena=True))
    log(f"  arena in global memory at B={B} (graph replays): {tglob:.4f} ms "
        f"(in shared memory: {t_all:.4f} ms)")
    # the first finer grid: shared arena (as the wrapper chooses) against
    # global; the second through the wrapper
    fsys, fy, ff, fh, fk, fd, fnb, fdr = fine[0]
    f_sh = graph_ms(lambda: ros23_cuda.ros23_step_probe(
        fsys, fy, ff, fh, fk, fd, fdr))
    f_gl = graph_ms(lambda: ros23_cuda.ros23_step_probe(
        fsys, fy, ff, fh, fk, fd, fdr, global_arena=True))
    f200 = graph_ms(lambda: ros23_cuda.ros23_step_fused(*fine[1]))
    log(f"  NB={fnb} B={fy.shape[-1]}: shared arena {f_sh:.4f} ms, global "
        f"arena {f_gl:.4f} ms; NB={fine[1][6]} B={fine[1][1].shape[-1]} "
        f"(global arena): {f200:.4f} ms (graph replays)")
    ros23_cuda.LAUNCHES = before   # timing launches do not count

    # the eager layers one RODAS4 step is made of (the headline's
    # step: 6 RHS, 1 band build, 1 factor, 6 solves)
    lp = ctx.lane_params(p)
    Lj, Dj, Uj = ctx.bands(y, lp)
    gh = 0.25 * h[None, None, None, :]     # RODAS4's g = 0.25
    W = (-gh * Lj, ctx.eye_l - gh * Dj, -gh * Uj)
    fac = ctx.factor(*W)
    layer_ms = {
        "rhs": cuda_ms(lambda: ctx.make_f(lp)(y), reps=5),
        "bands": cuda_ms(lambda: ctx.bands(y, lp), reps=5),
        "factor": cuda_ms(lambda: ctx.factor(*W), reps=5),
        "solve": cuda_ms(lambda: ctx.solve(fac, f_n), reps=5)}
    log(f"  eager layers at B={B} (median of 5): " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in layer_ms.items()))
    rows.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                bound_by=bound_by, ms_one_call=call_ms, ms_x4_lanes=ms4,
                ms_1_lane=by_lanes[1], ms_132_lanes=by_lanes[132],
                ms_264_lanes=by_lanes[264], parts_ms=parts,
                blocks_per_sm=occ[Nr]["blocks_per_sm"],
                arena_bytes=occ[Nr]["arena_bytes"], ms_global_arena=tglob,
                ms_nb100_b64=f_sh,
                ms_nb100_b64_global_arena=f_gl, ms_nb200_b64=f200,
                eager_rhs_ms=layer_ms["rhs"])
    rows["max_abs_err"] = max(r["abs_y"] for r in result)
    rows["max_err"] = max(max(r["err_y"], r["err_fc"]) for r in result)
    rows["f1_direct_err"] = max(r["err_f"] for r in result)
    rows["est_scaled_err"] = max(r["err_e"] for r in result)


def phase2(g, batch, dev, rows):
    """The main path through the kernel: chunked f32 Rosenbrock23."""
    import torch
    from gab1_shp2_tpu_torch.ops import ros23_cuda

    system = g.base_system()
    Co = g.default_co(dtype=torch.float32, device=dev)
    chunks = [g.Params.unpack(torch.as_tensor(batch[s:s + CHUNK],
                                              dtype=torch.float32,
                                              device=dev))
              for s in range(0, N, CHUNK)]
    kw = dict(device=dev, method="rosenbrock23", return_stats=True, **CFG)
    torch.cuda.synchronize()
    ros23_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    outs, loop_steps, failed = [], 0, 0
    for pb in chunks:
        sol, st = g.solve_stiff_batch(system, Co, pb, step_impl="fused",
                                      **kw)
        outs.append(sol.C[:, -1])
        # lanes advance in lock step: a chunk's loop runs one kernel
        # launch per step of its slowest lane
        loop_steps += int((st.n_accepted + st.n_rejected).max())
        failed += int(st.failed.sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ros23_cuda.LAUNCHES
    log(f"  fused: {N} members in {wall:.3f} s = {N / wall:.2f} solves/s; "
        f"{failed} failed; {launches} kernel launches, {loop_steps} loop "
        f"steps; launches x phase-1 kernel time = "
        f"{launches * rows['ms'] / 1e3:.3f} s of the wall")
    if failed:
        raise RuntimeError(f"{failed} members failed")
    if launches == 0 or launches != loop_steps:
        raise RuntimeError(f"the fused path launched the kernel {launches} "
                           f"times for {loop_steps} loop steps")
    ref, _ = g.solve_stiff_batch(system, Co, chunks[0], step_impl="torch",
                                 **kw)
    Cr = ref.C[:, -1].double()
    Cf = outs[0].double()
    err = float(((Cf - Cr).abs() / (Cr.abs() + 1e-6)).max())
    log(f"  chunk 0, fused vs unfused step: max rel err {err:.3e}")
    if not err < 2e-3:
        raise RuntimeError("fused and unfused Rosenbrock23 disagree")
    for C in outs:
        if not torch.isfinite(C).all():
            raise RuntimeError("non-finite final profiles")
    rows["launches"] = launches
    return N / wall


def _final_C(sol):
    return sol.C[-1]


def worker_init(parent, threads, cuda):
    """Set-up of a pool worker: no CUDA device unless ``cuda``, ``threads``
    torch threads (0: torch's default), and an exit as soon as the
    script's process ``parent`` is gone (a daemon thread watches the
    parent's pid)."""
    import threading

    if not cuda:
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    if threads:
        torch.set_num_threads(threads)

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def f64_reference(batch4, cfg, tol):
    """Final profiles (numpy) of the members of ``batch4`` from tight f64
    RODAS4 solves at ``tol`` on the host's CPU, and their wall in s: the
    yardstick of phases 3, 5 and 9 (a host pool task)."""
    import torch

    import gab1_shp2_tpu_torch as g

    t0 = time.perf_counter()
    p64 = g.Params.unpack(torch.as_tensor(batch4, dtype=torch.float64))
    ref = g.solve_stiff_batch(g.base_system(), g.default_co(device="cpu"),
                              p64, device="cpu", method="rodas4",
                              dr=cfg["dr"], tf=cfg["tf"], Nts=cfg["Nts"],
                              **tol)
    return ref.C[:, -1].numpy(), time.perf_counter() - t0


def tight_reference(batch1, dr, tf):
    """bench.tight_reference (solve_stiff, TRBDF2, f64, rtol 1e-8) of
    member 0 on the host's CPU (numpy), and its wall in s (a host pool
    task)."""
    from gab1_shp2_tpu_torch import bench

    t0 = time.perf_counter()
    Cref = bench.tight_reference(batch1, device="cpu", dr=dr, tf=tf)
    return Cref.numpy(), time.perf_counter() - t0


def plate_on_cpu(plate):
    """Phase 9(e)'s CPU side (a host pool task): count_puncta over the
    synthetic plate, identify_cells and count_puncta_per_cell of image 0
    on the host's CPU; returns (count, mask, labels, per-cell counts,
    wall in s), arrays as numpy."""
    from gab1_shp2_tpu_torch.imaging import puncta

    pla, cell, _ = synthetic_plate(**plate)
    t0 = time.perf_counter()
    res = puncta.count_puncta(pla, device="cpu")
    labels = puncta.identify_cells(cell[0], device="cpu")
    per_cell = puncta.count_puncta_per_cell(pla[0], cell[0], device="cpu")
    return (res.count.numpy(), res.mask.numpy(), labels.numpy(), per_cell,
            time.perf_counter() - t0)


def phase3(g, batch, dev, Cref):
    """The bench headline in eager PyTorch: f32 RODAS4, lane refill."""
    import torch

    system = g.base_system()
    Co32 = g.default_co(dtype=torch.float32, device=dev)
    pb = g.Params.unpack(torch.as_tensor(batch, dtype=torch.float32,
                                         device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ok, steps = g.solve_stiff_refill(system, Co32, pb, extract=_final_C,
                                          device=dev, method="rodas4",
                                          lanes=CHUNK, **CFG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_failed = int((~ok).sum())
    log(f"  refill rodas4: {N} members in {wall:.3f} s = {N / wall:.2f} "
        f"solves/s; {n_failed} failed; max steps per member "
        f"{int(steps.max())}")
    if n_failed:
        raise RuntimeError(f"{n_failed} members failed")
    relerr = float(((out[0].double() - Cref[0]).abs()
                    / (Cref[0].abs() + 1e-8)).max())
    log(f"  member 0 vs f64 RODAS4 at rtol {REF_TOL['rtol']:g}: max rel err "
        f"{relerr:.3e}")
    if not relerr <= 1e-3:
        raise RuntimeError("the refill headline is off the f64 reference")
    return dict(sps=N / wall, wall=wall, out=out, ok=ok)


def _rel_norm(a, b):
    """Relative norm error in float64 (memb_sfk holds values ~1e32, whose
    squares overflow float32)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def phase4(g, batch, dev, erows):
    """The fused explicit solve against its plain version."""
    import torch
    from gab1_shp2_tpu_torch.models.params import stability_dt
    from gab1_shp2_tpu_torch.ops import explicit_cuda

    Co = g.default_co(dtype=torch.float32, device=dev)

    def members(n):
        return g.Params.unpack(torch.as_tensor(batch[:n],
                                               dtype=torch.float32,
                                               device=dev))

    def compare(label, system, pb, **kw):
        """Errors of the kernel against the plain version, and the plain
        version's CUDA-event time in ms (one run)."""
        Ck, mk = explicit_cuda.solve_explicit_fused(system, Co, pb,
                                                    device=dev, **kw)
        out = {}

        def plain():
            out["Cm"] = explicit_cuda.solve_explicit_plain(
                system, Co, pb, device=dev, **kw)

        plain_ms = cuda_ms(plain, reps=1, warmup=0)
        Cp, mp = out["Cm"]
        if not (torch.isfinite(Ck).all() and torch.isfinite(mk).all()):
            raise RuntimeError(f"{label}: the kernel returned non-finite "
                               "values")
        err_C, err_m = _rel_norm(Ck, Cp), _rel_norm(mk, mp)
        # absolute error where the plain values are of ordinary size: the
        # pinned aSFK boundary value of memb_sfk (~1e32) is held by the
        # relative norm only
        ordinary = Cp.abs() <= 1e6
        abs_C = float(((Ck - Cp).abs() * ordinary).max())
        abs_m = float((mk - mp).abs().max())
        log(f"  {label}: C rel-norm err {err_C:.3e}, m rel-norm err "
            f"{err_m:.3e}; max abs err C {abs_C:.3e}, m {abs_m:.3e}")
        if not (err_C <= 1e-4 and err_m <= 1e-4):
            raise RuntimeError(f"{label}: kernel disagrees with "
                               "solve_explicit_plain")
        return max(err_C, err_m), max(abs_C, abs_m), plain_ms

    kw = dict(dr=CFG["dr"], tf=0.25, maxiters=4)
    pb = members(CHUNK)
    # rect and memb_sfk at tf=0.1 (0.25 until phase 7 joined the script: a
    # cut of depth); base, whose plain version is timed, at tf=0.25
    results = [compare(f"{name} B={CHUNK} tf={tf}", system, pb,
                       **dict(kw, tf=tf))
               for name, system, tf in (("base", g.base_system(), 0.25),
                                        ("rect", g.rect_system(), 0.1),
                                        ("memb_sfk", g.memb_sfk_system(),
                                         0.1))]
    # an odd ensemble
    results.append(compare("base B=37 tf=0.05", g.base_system(), members(37),
                           dr=0.2, tf=0.05, maxiters=4))
    # finer grids, one for each other layout: 101 nodes (a warp per member,
    # 4 nodes a lane), 201 and 501 (blocks of 2 and 4 warps per member)
    results.append(compare("base B=32 dr=0.1 (101 nodes) tf=0.01",
                           g.base_system(), members(32), dr=0.1, tf=0.01,
                           maxiters=4))
    results.append(compare("base B=32 dr=0.05 (201 nodes) tf=0.01",
                           g.base_system(), members(32), dr=0.05, tf=0.01,
                           maxiters=4))
    results.append(compare("base B=4 dr=0.02 (501 nodes) tf=0.0005",
                           g.base_system(), members(4), dr=0.02, tf=0.0005,
                           maxiters=4))
    before = explicit_cuda.LAUNCHES
    plain_ms = results[0][2]
    # the kernel at the shape the plain version was timed at (base, the
    # first comparison), so the two times compare like for like
    small_ms = cuda_ms(lambda: explicit_cuda.solve_explicit_fused(
        g.base_system(), Co, pb, device=dev, **kw), reps=5, warmup=1)
    explicit_cuda.LAUNCHES = before
    nt = torch.ceil(0.25 / stability_dt(pb, CFG["dr"]))
    log(f"  base B={CHUNK} tf=0.25 ({int(nt.min())}-{int(nt.max())} steps): "
        f"plain version {plain_ms:.1f} ms (one run), kernel "
        f"{small_ms:.3f} ms (median of 5)")
    erows.update(max_err=max(r[0] for r in results),
                 max_abs_err=max(r[1] for r in results),
                 plain_ms=plain_ms, ms_at_plain_shape=small_ms,
                 plain_shape=f"B={CHUNK}, tf=0.25, {int(nt.max())} steps")


def phase5(g, batch, dev, erows, Cref):
    """The explicit path at full width through the kernel."""
    import torch
    from gab1_shp2_tpu_torch.models.params import stability_dt
    from gab1_shp2_tpu_torch.ops import explicit_cuda

    system = g.base_system()
    Co = g.default_co(dtype=torch.float32, device=dev)
    pb = g.Params.unpack(torch.as_tensor(batch, dtype=torch.float32,
                                         device=dev))
    kw = dict(dr=CFG["dr"], tf=CFG["tf"], maxiters=4, device=dev)
    torch.cuda.synchronize()
    explicit_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    C, m = explicit_cuda.solve_explicit_fused(system, Co, pb, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = explicit_cuda.LAUNCHES
    nt = torch.ceil(CFG["tf"] / stability_dt(pb, CFG["dr"])).to(torch.int64)
    bad = int((~torch.isfinite(C).all(dim=-1).all(dim=-1)
               | ~torch.isfinite(m).all(dim=-1)).sum())
    log(f"  fused explicit: {N} members in {wall:.3f} s = {N / wall:.2f} "
        f"solves/s; {launches} kernel launch(es); steps per member "
        f"{int(nt.min())}-{int(nt.max())} (mean {float(nt.double().mean()):.0f}); "
        f"{bad} non-finite members")
    if launches != 1:
        raise RuntimeError(f"the explicit path launched the kernel "
                           f"{launches} times, expected 1")
    if bad:
        raise RuntimeError(f"{bad} members are non-finite")
    Nr = int(round(10.0 / CFG["dr"]))
    if tuple(C.shape) != (N, 10, Nr + 1) or tuple(m.shape) != (N, 8):
        raise RuntimeError(f"unexpected output shapes {tuple(C.shape)}, "
                           f"{tuple(m.shape)}")

    # members 0-3 against tight f64 RODAS4 solves of the same PDE:
    # |dC| <= rtol * (|C| + 0.2): the explicit scheme's O(dt) error and
    # the 4-iteration fixed point against a tight adaptive solve
    dev_rel = float(((C[:4].double() - Cref).abs()
                     / (Cref.abs() + 0.2)).max())
    log(f"  members 0-3 vs f64 RODAS4 at rtol {REF_TOL['rtol']:g}: max "
        f"|dC|/(|C|+0.2) = "
        f"{dev_rel:.3e} (limit {EXPLICIT_VS_STIFF:.0e})")
    if not dev_rel <= EXPLICIT_VS_STIFF:
        raise RuntimeError("the fused explicit solve is off the f64 "
                           "reference")

    ms = cuda_ms(lambda: explicit_cuda.solve_explicit_fused(
        system, Co, pb, **kw), reps=5, warmup=1)
    pb4 = g.Params(D=pb.D.repeat(4, 1), k=pb.k.repeat(4, 1))
    ms4 = cuda_ms(lambda: explicit_cuda.solve_explicit_fused(
        system, Co, pb4, **kw), reps=3, warmup=1)
    flops = explicit_cuda.explicit_flops(system, Nr, 4) * int(nt.sum())
    # in: k, d_eff, dt, nt per member, c0 and m0 once; out: C and m
    nbytes = 4 * (N * (17 + 10 + 1 + 1) + 18 + C.numel() + m.numel())
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BPS
    log(f"  N={N}: kernel {ms:.3f} ms per launch (median of 5) = "
        f"{N / ms * 1e3:.1f} solves/s; bound {max(t_ops, t_bytes) * 1e3:.4f}"
        f" ms ({flops / 1e12:.4f} TFLOP = {t_ops * 1e3:.4f} ms, "
        f"{nbytes / 1e6:.3f} MB = {t_bytes * 1e3:.5f} ms)")
    log(f"  N={4 * N}: kernel {ms4:.3f} ms per launch (median of 3) = "
        f"{ms4 / ms:.2f} x N={N}")
    # the serial-chain floor, a model logged beside the measured times:
    # the longest member's steps, each at least chain_ops dependent
    # operations of 4 cycles at the card's maximum SM clock (the clock under
    # load may be lower, which raises the floor)
    plan = explicit_cuda.launch_plan(Nr)
    info = {}
    for nr in (Nr, 100, 200):
        p_nr = explicit_cuda.launch_plan(nr)
        info[p_nr.layout] = explicit_cuda.kernel_info(system, p_nr)
        log(f"  {nr + 1} nodes: {p_nr.layout}, {p_nr.threads} threads a "
            f"block: {info[p_nr.layout]}")
    khz = info[plan.layout]["sm_clock_khz"]
    floor = chain_floor_ms(system, int(nt.max()), 4, khz)
    log(f"  serial-chain floor {floor:.4f} ms: {int(nt.max())} steps x "
        f"{chain_ops(system, 4)} dependent operations x "
        f"{CYCLES_PER_CHAIN_OP} cycles at {khz / 1e6:.3f} GHz (maximum) "
        f"(the kernel is {ms / floor:.1f} x above it, "
        f"{ms / (max(t_ops, t_bytes) * 1e3):.1f} x above the bound)")
    erows.update(launches=launches, ms=ms, ms_x4_members=ms4,
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 vs_f64_stiff=dev_rel,
                 layout=plan.layout,
                 blocks_per_sm=info[plan.layout]["blocks_per_sm"],
                 registers=info[plan.layout]["registers"],
                 layouts={k: dict(registers=v["registers"],
                                  local_bytes=v["local_bytes"],
                                  blocks_per_sm=v["blocks_per_sm"])
                          for k, v in info.items()})
    return N / wall


def _final_state(sol):
    return sol.C[-1], sol.m[-1]


def _gsa6(sol):
    from gab1_shp2_tpu_torch.models.observables import gsa_outputs

    return gsa_outputs(sol, 10.0)


def phase6(g, batch, dev):
    """The ensemble engine and the GSA runner on the card."""
    import torch
    from gab1_shp2_tpu_torch.gsa import runner
    from gab1_shp2_tpu_torch.models.params import stability_dt
    from gab1_shp2_tpu_torch.ops import explicit_cuda

    system = g.base_system()
    # (a) the eager explicit path through run_ensemble against the kernel;
    # tf=0.25 (it was 0.5 until phase 7 joined the script: a cut of depth,
    # the ~1,800 host-paced loop steps halved, to hold the script's wall)
    n = min(64, N)
    chunk = max(1, n // 2)
    kw = dict(dr=0.5, tf=0.25)
    Co64 = g.default_co(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (Ce, me), ok = g.run_ensemble(system, Co64, batch[:n], solver="explicit",
                                  extract=_final_state, device=dev, Nts=2,
                                  maxiters=20, tol=0.0, chunk=chunk, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pb = g.Params.unpack(torch.as_tensor(batch[:n], device=dev))
    nt = torch.ceil(kw["tf"] / stability_dt(pb, kw["dr"])).sort().values
    loop_steps = sum(int(nt[min(s + chunk, n) - 1])
                     for s in range(0, n, chunk))
    Ck, mk = explicit_cuda.solve_explicit_fused(system, Co64, pb,
                                                maxiters=20, device=dev,
                                                **kw)
    if not bool(ok.all()):
        raise RuntimeError("run_ensemble(solver='explicit') lost members")
    err_C = float(((Ck.double() - Ce).abs() - 3e-5 * Ce.abs()).max())
    err_m = float(((mk.double() - me).abs() - 3e-5 * me.abs()).max())
    log(f"  eager explicit run_ensemble N={n} dr=0.5 tf={kw['tf']} (f64, "
        f"maxiters 20, tol 0; tf cut from 0.5): {wall:.2f} s, {loop_steps} "
        f"loop steps, "
        f"{wall / loop_steps * 1e3:.2f} ms per step of {chunk} members; "
        f"vs fused f32 kernel: max(|d| - 3e-5|x|) C {err_C:.3e} (limit "
        f"1e-4), m {err_m:.3e} (limit 1e-6)")
    if not (err_C <= 1e-4 and err_m <= 1e-6):
        raise RuntimeError("eager and fused explicit solves disagree")

    # (b) the stiff ensemble with the GSA outputs, then quantiles
    Co32 = g.default_co(dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ok = g.run_ensemble(system, Co32, batch[:CHUNK].astype(np.float32),
                             solver="stiff", extract=_gsa6, device=dev,
                             **CFG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    q = g.masked_quantiles(out, ok)
    log(f"  stiff run_ensemble N={CHUNK} (refill, 6 GSA outputs): "
        f"{wall:.2f} s, {int(ok.sum())}/{CHUNK} ok; medians "
        + ", ".join(f"{v:.4g}" for v in q[1].tolist()))
    if not bool(ok.all()):
        raise RuntimeError("run_ensemble(solver='stiff') lost members")
    if tuple(q.shape) != (3, 6) or not torch.isfinite(q).all():
        raise RuntimeError("masked_quantiles is not finite of shape (3, 6)")

    # (c) eFAST over the 5 initial concentrations: 5 x 65 = 325 solves
    evaluate = runner.make_conc_evaluator(
        system, g.default_params(dtype=torch.float32, device=dev),
        device=dev, dr=CFG["dr"], tf=CFG["tf"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zero_share = []

    def counted(X):
        Y = evaluate(X)
        zero_share.append(float((np.abs(Y).sum(axis=-1) == 0).mean()))
        return Y

    S1, ST, design = runner.run_efast(counted, runner.conc_bounds(Co64),
                                      samples=65)
    wall = time.perf_counter() - t0
    log(f"  eFAST over initial concentrations: {design.X.shape[0]} solves "
        f"in {wall:.2f} s; share of zero rows {zero_share[0]:.3f}; ST of "
        f"[pG1S2]_average: " + ", ".join(f"{v:.3f}" for v in ST[:, 5]))
    if S1.shape != (5, 6) or not (np.isfinite(S1).all()
                                  and np.isfinite(ST).all()):
        raise RuntimeError("eFAST indices are not finite of shape (5, 6)")


def phase7(g, dev):
    """The single-member stiff solver and the inference path on the card
    at the fit configuration; returns the readings logged at the end."""
    import torch
    from gab1_shp2_tpu_torch.inference import loss as tl
    from gab1_shp2_tpu_torch.inference import nuts as tn
    from gab1_shp2_tpu_torch.inference import surrogate as ts
    from gab1_shp2_tpu_torch.inference.diagnostics import check_chains
    from gab1_shp2_tpu_torch.inference.map_fit import map_fit
    from gab1_shp2_tpu_torch.models.observables import pct_shp2_bound_gab1
    from gab1_shp2_tpu_torch.ops.trbdf2 import solve_stiff

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    system = g.base_system()
    Co = g.default_co(device=dev)
    p = g.default_params(fit="prior", device=dev)
    kw = dict(FIT, Nts=2)
    read = {}

    # (1) solve_stiff against solve_stiff_batch (B=1) on the card and a
    # CPU solve of the port
    for method in ("trbdf2", "rodas4"):
        (sol, st), wall = timed(lambda: solve_stiff(
            system, Co, p, device=dev, method=method, return_stats=True,
            **kw))
        sb = g.solve_stiff_batch(system, Co, g.Params(D=p.D[None],
                                                      k=p.k[None]),
                                 device=dev, method=method, **kw)
        err_b = float((sol.C - sb.C[0]).abs().max() / sb.C[0].abs().max())
        t0 = time.perf_counter()
        sol_c = solve_stiff(system, Co.cpu(), p.to(device="cpu"),
                            device="cpu", method=method, **kw)
        wall_c = time.perf_counter() - t0
        y = float(pct_shp2_bound_gab1(sol, Co, 10.0))
        y_c = float(pct_shp2_bound_gab1(sol_c, Co.cpu(), 10.0))
        err_y = abs(y - y_c) / abs(y_c)
        read[f"solve_{method}_s"] = wall
        log(f"  solve_stiff {method}: {wall:.2f} s, {int(st.n_accepted)} "
            f"accepted / {int(st.n_rejected)} rejected, failed "
            f"{bool(st.failed)}; C vs solve_stiff_batch (B=1) {err_b:.3e} "
            f"(limit 1e-6); pct_shp2_bound_gab1 {y:.10f} vs the CPU's "
            f"{y_c:.10f}: {err_y:.3e} (limit 1e-8); the CPU solve "
            f"{wall_c:.2f} s")
        if bool(st.failed) or not err_b <= 1e-6 or not err_y <= 1e-8:
            raise RuntimeError(f"solve_stiff {method} is off")

    # (2) the log posterior's value and gradient through the autograd
    # Function, against central finite differences of batched solves
    x = torch.as_tensor(np.log(FIT_MODES), device=dev)
    lp = tl.make_log_posterior(tl.make_observable_fn(device=dev, **FIT))

    def value_and_grad():
        q = x.clone().requires_grad_(True)
        v = lp(q)
        (gr,) = torch.autograd.grad(v, q)
        return float(v.detach()), gr

    (v, gr), wall = timed(value_and_grad)
    read["value_and_grad_s"] = wall
    eye = np.eye(4) * FD_STEP
    Q = np.concatenate([np.log(FIT_MODES) + eye, np.log(FIT_MODES) - eye])
    (y_fd, wall_fd) = timed(lambda: tl.make_batch_observable(
        device=dev, **FIT)(Q))
    lp_fd = tl.make_log_posterior(
        lambda q: torch.as_tensor(y_fd, device=dev), wrap_vjp=False)
    vals = lp_fd(torch.as_tensor(Q, device=dev))
    g_fd = ((vals[:4] - vals[4:]) / (2 * FD_STEP)).cpu().numpy()
    g_ad = gr.cpu().numpy()
    err_g = float(np.max(np.abs(g_fd - g_ad)) / np.max(np.abs(g_ad)))
    log(f"  log posterior at the prior modes: {v:.10f}; value + gradient "
        f"{wall:.2f} s; gradient " + ", ".join(f"{a:.6f}" for a in g_ad)
        + "; central differences (step 1e-4, 8 batched solves, "
        f"{wall_fd:.2f} s) " + ", ".join(f"{a:.6f}" for a in g_fd)
        + f": max rel {err_g:.3e} (limit 1e-4)")
    if not (np.isfinite(v) and err_g <= 1e-4 and g_ad[2] > 0
            and g_ad[1] < 0):
        raise RuntimeError("the log posterior's gradient is off")

    # (3) map_fit, scaled down: LBFGS through the stiff solve in both
    # of its stages
    res, wall = timed(lambda: map_fit(device=dev, **MAP_ARGS))
    best = float(np.nanmin(res.start_losses))
    read["map_fit_s"] = wall
    log(f"  map_fit {MAP_ARGS}: {wall:.1f} s; start losses "
        + ", ".join(f"{v:.6g}" for v in res.start_losses)
        + f"; final loss {res.loss:.6g} at "
        + ", ".join(f"{n}={v:.4g}" for n, v in res.values.items()))
    # TestMAPFit's criterion, with the iterations lowering the loss below
    # the best start's
    if not (np.isfinite(res.loss) and res.loss < best):
        raise RuntimeError("map_fit did not improve on its best start")

    # (4) the surrogate route of the fit_and_infer workload
    lo, hi = tl.prior_box()
    batch_obs = tl.make_batch_observable(
        device=dev, dr=FIT["dr"], rtol=FIT["rtol"], method="rodas4",
        linsolve_dtype=torch.float32, max_steps=4000)
    (sur, grid_vals), wall = timed(lambda: ts.build_surrogate(
        batch_obs, lo, hi, n=SUR_GRID, device=dev))
    read["surrogate_s"] = wall
    n_bad = int((~np.isfinite(grid_vals)).sum())
    log(f"  surrogate: {SUR_GRID}^4 = {SUR_GRID ** 4} grid solves "
        f"(rodas4, f32 linear algebra) in {wall:.2f} s, {n_bad} failed")
    if n_bad:
        raise RuntimeError("surrogate grid solves failed")
    lp_s = tl.make_log_posterior(sur.y, wrap_vjp=False)
    C_ = NUTS_RUN["chains"]
    q0 = torch.as_tensor(res.log_k4, device=dev).expand(C_, 4).clone()
    (qs, info), wall = timed(lambda: tn.run_nuts(
        lp_s, q0, tn.chain_generators(NUTS_RUN["seed"], C_),
        num_warmup=NUTS_RUN["warmup"], num_samples=NUTS_RUN["samples"],
        max_depth=NUTS_RUN["max_depth"]))
    read["nuts_s"] = wall
    Qd = qs.reshape(-1, 4).cpu().numpy()
    exact_obs = tl.make_batch_observable(
        device=dev, dr=FIT["dr"], rtol=1e-6, atol=1e-9, method="rodas4",
        linsolve_dtype=torch.float32, max_steps=40_000)
    y_exact, wall_x = timed(lambda: exact_obs(Qd))
    read["reweight_s"] = wall_x
    y_sur = sur.y(torch.as_tensor(Qd, device=dev)).detach()
    ll_exact = tl.datum_loglik(torch.as_tensor(y_exact)).numpy()
    ll_sur = tl.datum_loglik(y_sur.cpu()).numpy()
    w, ess_w = ts.importance_reweight(ll_exact, ll_sur)
    div = info["diverged"].cpu().numpy()
    rep = check_chains(qs.cpu().numpy(), div, names=tl.FIT_NAMES)
    dlog = np.abs(np.log(np.maximum(y_exact, 1e-12))
                  - np.log(np.maximum(y_sur.cpu().numpy(), 1e-12)))
    log(f"  NUTS on the surrogate: {C_} chains x ({NUTS_RUN['warmup']} "
        f"warmup + {NUTS_RUN['samples']} draws), max depth "
        f"{NUTS_RUN['max_depth']}: {wall:.1f} s; mean tree depth "
        f"{float(info['depth'].float().mean()):.2f}; divergences "
        f"{int(div.sum())}/{div.size} (rate {rep['divergence_rate']:.3f})"
        "; split R-hat " + ", ".join(f"{k}={r:.3f}"
                                     for k, r in rep["rhat"].items())
        + "; ESS " + ", ".join(f"{k}={e:.0f}" for k, e in rep["ess"].items())
        + f"; health gate ok={rep['ok']} {rep['failures']}")
    log(f"  exact likelihood at the {len(Qd)} draws (rodas4, rtol 1e-6, "
        f"f32 linear algebra): {wall_x:.2f} s, "
        f"{int((~np.isfinite(y_exact)).sum())} failed; surrogate vs exact "
        f"max |dlog y| {float(np.max(dlog)):.3g}; importance ESS "
        f"{ess_w:.1f} / {len(Qd)}")
    if not (torch.isfinite(qs).all() and np.isfinite(y_exact).all()
            and np.isfinite(ess_w) and ess_w >= 1.0
            and np.isfinite(rep["divergence_rate"])
            and all(np.isfinite(r) for r in rep["rhat"].values())
            and not any("frozen" in f for f in rep["failures"])):
        raise RuntimeError("the surrogate route failed")
    return read


def phase8_beside(device, driver_args, driver_small):
    """Phase 8 in a process of its own (a pool task), so that it runs on
    ``device`` beside phase 7; the drivers' command lines are passed in
    (module constants are this process's own).  Returns (each driver's
    wall or None, the phase's wall in s, its log, the traceback's text or
    None)."""
    import contextlib
    import io
    import traceback

    import torch

    global DRIVER_ARGS, DRIVER_SMALL
    DRIVER_ARGS, DRIVER_SMALL = driver_args, driver_small
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            walls = phase8(torch.device(device))
    except Exception:
        return (None, time.perf_counter() - t0, buf.getvalue(),
                traceback.format_exc())
    return walls, time.perf_counter() - t0, buf.getvalue(), None


def _csv_rows(path):
    import csv

    with open(path) as fh:
        return list(csv.reader(fh))


def _finite_csv(path, n_rows=None, skip_cols=1):
    """A driver's CSV as an array, checked finite, with ``n_rows`` rows
    (at least one when ``None``)."""
    rows = _csv_rows(path)[1:]
    vals = np.asarray([r[skip_cols:] for r in rows], float)
    if (len(rows) != (n_rows or max(1, len(rows)))
            or not np.isfinite(vals).all()):
        raise RuntimeError(f"{path}: {len(rows)} rows (want {n_rows}), "
                           f"finite {bool(np.isfinite(vals).all())}")
    return vals


def phase8(dev):
    """The workload drivers, each through its main() on ``dev`` with
    --outdir a temporary directory; returns each driver's wall in s.

    Every run_ensemble call a driver makes, every GSA evaluator and every
    batched observable of fit_and_infer is checked to take ``dev`` and
    counted (fit_and_infer's chains are checked to run on ``dev`` too): a member whose solve failed is lost, and a lost member fails
    the phase.  Without matplotlib the figure helpers are replaced by
    recorders of what they would draw."""
    import contextlib
    import importlib
    import importlib.util
    import io
    import os
    import shutil
    import tempfile
    from unittest import mock

    import torch
    from gab1_shp2_tpu_torch.workloads import common

    mods = {n: importlib.import_module(f"gab1_shp2_tpu_torch.workloads.{n}")
            for n in DRIVER_ARGS}
    flags = [] if dev.type == "cuda" else ["--cpu"]
    # the device of the driver running now: dev, or the CPU for a --cpu run
    tally = dict(members=0, lost=0, dev=dev)
    walls = {}

    def on_dev(kw, what):
        if torch.device(kw["device"]).type != tally["dev"].type:
            raise RuntimeError(f"{what} was given device {kw['device']}, "
                               f"not {tally['dev']}")

    def guard_ensemble(fn):
        def run(*a, **kw):
            on_dev(kw, "run_ensemble")
            out, ok = fn(*a, **kw)
            if ok.device.type != tally["dev"].type:
                raise RuntimeError("run_ensemble ran off the device")
            tally["members"] += ok.numel()
            tally["lost"] += int((~ok).sum())
            return out, ok
        return run

    def guard_factory(fn, failed):
        """A GSA evaluator or batched-observable factory whose function
        counts its failures: rows of zeros, or NaN."""
        def make(*a, **kw):
            on_dev(kw, fn.__name__)
            inner = fn(*a, **kw)

            def call(X):
                y = inner(X)
                tally["members"] += len(y)
                tally["lost"] += int(failed(y).sum())
                return y
            return call
        return make

    mpl = importlib.util.find_spec("matplotlib") is not None
    drawn = []

    def recorder(name):
        def record(path, *a, **k):
            shapes = [tuple(np.shape(x)) for x in (*a, *k.values())
                      if isinstance(x, np.ndarray)]
            drawn.append(f"{name}({os.path.basename(str(path))}, {shapes})")
        return record

    with contextlib.ExitStack() as stack, \
            tempfile.TemporaryDirectory() as tmp:
        for mod in (common, *mods.values()):
            if hasattr(mod, "run_ensemble"):
                stack.enter_context(mock.patch.object(
                    mod, "run_ensemble", guard_ensemble(mod.run_ensemble)))
        gsa = mods["gsa_driver"]
        for name in ("make_param_evaluator", "make_conc_evaluator"):
            stack.enter_context(mock.patch.object(gsa, name, guard_factory(
                getattr(gsa, name), lambda y: np.abs(y).sum(axis=-1) == 0)))
        fi = mods["fit_and_infer"]
        stack.enter_context(mock.patch.object(
            fi, "make_batch_observable",
            guard_factory(fi.make_batch_observable,
                          lambda y: ~np.isfinite(y))))
        nuts_device = fi._nuts_device

        def chains_on_dev(args):
            ndev = nuts_device(args)
            on_dev({"device": ndev}, "the NUTS chains")
            return ndev
        stack.enter_context(mock.patch.object(fi, "_nuts_device",
                                              chains_on_dev))
        if not mpl:
            log("  matplotlib is not installed on this host: no figure is "
                "drawn; the drivers' figure helpers record the path and the "
                "array shapes of each figure instead")
            for name in ("save_surface_plot", "save_line_plot",
                         "save_bar_comparison", "save_rotated_chase_surface"):
                stack.enter_context(mock.patch.object(common, name,
                                                      recorder(name)))
            stack.enter_context(mock.patch.object(
                gsa, "save_heatmaps",
                lambda outdir, tag, *a: recorder("save_heatmaps")(
                    f"{tag}_heatmap.png", *a)))

        def run(label, module, argv, sub):
            out = os.path.join(tmp, sub)
            os.makedirs(out, exist_ok=True)
            argv = argv + flags
            tally.update(members=0, lost=0, dev=torch.device(
                "cpu" if "--cpu" in argv else dev.type))
            drawn.clear()
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    mods[module].main(argv + ["--outdir", out])
            finally:
                # the driver's own lines, also when it fails
                for line in buf.getvalue().splitlines():
                    log(f"    | {line}")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            if drawn:
                log(f"    figures not drawn ({len(drawn)}): "
                    + "; ".join(drawn))
            log(f"  {label} {' '.join(argv)}: {walls[label]:.1f} s, "
                f"{tally['members']} solves, {tally['lost']} lost")
            if tally["lost"]:
                raise RuntimeError(f"{label}: {tally['lost']} members lost")
            return out, buf.getvalue()

        # run_base_model at its default --n, then at a small configuration
        # on the card and on the CPU
        out, _ = run("run_base_model", "run_base_model",
                     DRIVER_ARGS["run_base_model"], "rbm")
        q = _finite_csv(f"{out}/pct_shp2_bound_gab1.csv", 1, 0)[0]
        if not 0 < q[1] < 100:
            raise RuntimeError(f"run_base_model: median {q[1]} % bound")
        rows = []
        for sub, extra in (("small", []), ("small_cpu", ["--cpu"])):
            out, _ = run(f"run_base_model ({sub})", "run_base_model",
                         DRIVER_SMALL + extra, sub)
            rows.append(_finite_csv(f"{out}/pct_shp2_bound_gab1.csv", 1,
                                    0)[0])
        err = float(np.max(np.abs(rows[0] - rows[1]) / np.abs(rows[1])))
        log(f"  run_base_model small, {dev.type} against the CPU: "
            + ", ".join(f"{a:.12g}/{b:.12g}" for a, b in zip(*rows))
            + f": max rel {err:.3e} (limit {DRIVER_SMALL_RTOL:g})")
        if not err <= DRIVER_SMALL_RTOL:
            raise RuntimeError("run_base_model: card and CPU disagree")

        out, _ = run("pulse_chase", "pulse_chase", DRIVER_ARGS["pulse_chase"],
                     "pc")
        pc = _finite_csv(f"{out}/pulse_chase_vs_ode.csv", 30, 0)
        rmse = float(np.sqrt(np.mean((pc[:, 1] - pc[:, 2]) ** 2)))
        log(f"  pulse_chase: pE median against the reaction-only ODE trace, "
            f"RMSE {rmse:.3f} percent points (limit 20)")
        if not rmse < 20.0:
            raise RuntimeError("pulse_chase: RMSE against the trace")

        out, _ = run("run_variants", "run_variants",
                     DRIVER_ARGS["run_variants"], "hela")
        _finite_csv(f"{out}/hela_vs_base_PG1Stot.csv", None, 0)
        _finite_csv(f"{out}/hela_cs_ratio_bf.csv", 1, 0)

        out, _ = run("length_scales", "length_scales",
                     DRIVER_ARGS["length_scales"], "ls")
        _finite_csv(f"{out}/length_scales_R100.csv", 18)
        out, _ = run("calc_rxn_rates", "calc_rxn_rates",
                     DRIVER_ARGS["calc_rxn_rates"], "rates")
        _finite_csv(f"{out}/rxn_rate_quantiles.csv", 6)

        log("  gsa_driver: samples cut from 1000 to 65 a parameter (the "
            "least eFAST takes with 4 harmonics): 24 x 65 = 1560 solves")
        out, _ = run("gsa_driver", "gsa_driver", DRIVER_ARGS["gsa_driver"],
                     "gsa")
        for label in ("S1", "ST"):
            _finite_csv(f"{out}/eFAST_dk_65spls_{label}.csv", 24)

        inf = os.path.join(tmp, "fit")
        os.makedirs(inf)
        here = os.path.dirname(os.path.abspath(__file__))
        for name in ("surrogate_n17.npz", "fitted_parameters.csv"):
            shutil.copy(os.path.join(here, "results", "inference", name), inf)
        out, text = run("fit_and_infer", "fit_and_infer",
                        DRIVER_ARGS["fit_and_infer"], "fit")
        diag = {r[0]: r[1:] for r in _csv_rows(f"{out}/nuts_diagnostics.csv")}
        fa = DRIVER_ARGS["fit_and_infer"]
        n_draws = (int(fa[fa.index("--chains") + 1])
                   * int(fa[fa.index("--samples") + 1]))
        post = _finite_csv(f"{out}/posterior_samples.csv", n_draws, 0)
        ess = _finite_csv(f"{out}/posterior_ess.csv", 1, 0)[0]
        _finite_csv(f"{out}/posterior_quantiles.csv", 4)
        _finite_csv(f"{out}/predictive_checks.csv", 2)
        log(f"  fit_and_infer: chain health ok={diag['_ok'][0]}, divergence "
            f"rate {float(diag['_divergence_rate'][0]):.3f}, split R-hat "
            + ", ".join(f"{n}={float(diag[n][0]):.3f}" for n in
                        ("kG1p", "kG1dp", "kSa", "kSi"))
            + ", ESS " + ", ".join(f"{n}={float(diag[n][1]):.0f}" for n in
                                   ("kG1p", "kG1dp", "kSa", "kSi"))
            + f"; importance ESS {ess[1]:.1f} / {int(ess[0])}; "
            f"weights sum {post[:, 4].sum():.6f}")
        if not ("NUTS health: ok" in text and diag["_ok"][0] == "1"
                and "exact-solve failures: 0" in text
                and ess[1] >= 1.0 and abs(post[:, 4].sum() - 1) < 1e-9):
            raise RuntimeError("fit_and_infer: the NUTS stage is off")

        if mpl:
            out, _ = run("plot_parameter_distributions",
                         "plot_parameter_distributions",
                         DRIVER_ARGS["plot_parameter_distributions"], "ppd")
            _finite_csv(f"{out}/parameter_ensemble.csv", 5000, 0)
        else:
            log("  plot_parameter_distributions: not run (it draws its "
                "figure itself and matplotlib is not installed; its CSV "
                "needs no device)")
    return walls


def _relc(a, b, floor):
    """max |a - b| / (|b| + floor) in float64."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (b.abs() + floor)).max())


def phase9_mesh(g, batch, dev, p3):
    """(a) the sharded refill at the bench configuration over two slots of
    the card; (b) the sorted scheduler sharded; (c) run_sharded_batch of the
    fused Rosenbrock23 path, kernel B1 launched from the worker threads."""
    import torch
    from gab1_shp2_tpu_torch.models.observables import gsa_outputs
    from gab1_shp2_tpu_torch.ops import ros23_cuda
    from gab1_shp2_tpu_torch.parallel.mesh import (
        ensemble_mesh,
        run_sharded_batch,
    )

    system = g.base_system()
    Co32 = g.default_co(dtype=torch.float32, device=dev)
    pb = g.Params.unpack(torch.as_tensor(batch, dtype=torch.float32,
                                         device=dev))
    two_slots = ensemble_mesh(["cuda:0", "cuda:0"])
    walls = {}

    # (a)
    n = SHARD_N
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ok = g.run_ensemble(system, Co32, pb.k.new_tensor(batch[:n]),
                             extract=_final_C, method="rodas4", chunk=CHUNK,
                             scheduler="refill", device_axis="ensemble",
                             mesh=two_slots, **CFG)
    torch.cuda.synchronize()
    walls["sharded_refill"] = time.perf_counter() - t0
    lost = int((~ok).sum())
    rel = _relc(out, p3["out"][:n], 1e-8)
    log(f"  (a) sharded refill over 2 slots of cuda:0, {n} members, "
        f"{CHUNK} lanes a slot: {walls['sharded_refill']:.3f} s "
        f"({n / walls['sharded_refill']:.2f} solves/s; phase 3 unsharded, "
        f"{N} members: {p3['wall']:.3f} s); {lost} lost; max rel diff from "
        f"phase 3 {rel:.3e}; outputs on {out.device}")
    if out.shape[0] != n or lost:
        raise RuntimeError(f"the sharded refill lost {lost} members")
    if not torch.equal(ok, p3["ok"][:n]):
        raise RuntimeError("the sharded refill's ok mask differs")
    if not rel <= SHARD_REL:
        raise RuntimeError("the sharded refill is off phase 3's result")
    if out.device != two_slots.devices[0]:
        raise RuntimeError(f"outputs gathered on {out.device}")

    # (b) against the unsharded sorted run in chunks of the same width: a
    # member's steps do not depend on its chunk, and at equal widths its
    # f32 arithmetic does not either (against one chunk of n, 4.1e-5 of
    # the 5e-5 bound on an H100)
    n, chunk = SORTED_RUN["n"], SORTED_RUN["chunk"]
    kw = dict(extract=_final_C, method="rodas4", scheduler="sorted",
              chunk=chunk, **CFG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, oka = g.run_ensemble(system, Co32, pb.k.new_tensor(batch[:n]),
                            device=dev, **kw)
    torch.cuda.synchronize()
    walls["sorted_unsharded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b, okb = g.run_ensemble(system, Co32, pb.k.new_tensor(batch[:n]),
                            device_axis="ensemble", mesh=two_slots, **kw)
    torch.cuda.synchronize()
    walls["sorted_sharded"] = time.perf_counter() - t0
    bad = int(((a - b).abs() > SHARD_ATOL + SHARD_RTOL * a.abs()).sum())
    log(f"  (b) sorted, {n} members in super-chunks of 2 x {chunk}: sharded "
        f"{walls['sorted_sharded']:.3f} s, unsharded in chunks of {chunk} "
        f"{walls['sorted_unsharded']:.3f} s; {int((~okb).sum())} lost; max "
        f"rel diff {_relc(b, a, 1e-8):.3e}; {bad} entries beyond rtol "
        f"{SHARD_RTOL:g}")
    if not (bool(okb.all()) and torch.equal(oka, okb)) or bad:
        raise RuntimeError("the sharded sorted run disagrees")

    # (c)
    kw = dict(dr=CFG["dr"], tf=CFG["tf"], Nts=CFG["Nts"], rtol=CFG["rtol"],
              atol=CFG["atol"], method="rosenbrock23", step_impl="fused",
              return_stats=True)
    packed = pb.k.new_tensor(batch[:FUSED_MESH_B])

    def local(shard):
        sol, st = g.solve_stiff_batch(system, Co32.to(shard.device),
                                      g.Params.unpack(shard),
                                      device=shard.device, **kw)
        return gsa_outputs(sol, 10.0), st.n_accepted + st.n_rejected, \
            st.failed

    meshes = [("2 slots of cuda:0", two_slots)]
    if torch.cuda.device_count() > 1:
        meshes.append((f"all {torch.cuda.device_count()} cards",
                       ensemble_mesh()))
    else:
        log("  (c) one card: the mesh over every card is not run")
    ref, _, ref_failed = local(packed)
    launches = None
    for name, mesh in meshes:
        torch.cuda.synchronize()
        ros23_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        o, steps, failed = run_sharded_batch(local, packed, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = ros23_cuda.LAUNCHES
        m = FUSED_MESH_B // mesh.size
        want = sum(int(steps[i * m:(i + 1) * m].max())
                   for i in range(mesh.size))
        bad = int(((o - ref).abs() > SHARD_ATOL + SHARD_RTOL
                   * ref.abs()).sum())
        log(f"  (c) fused rosenbrock23 through run_sharded_batch over {name},"
            f" B={FUSED_MESH_B}: {wall:.3f} s; {n_launch} kernel launches "
            f"from the worker threads ({want} slot loop steps); GSA outputs "
            f"max rel diff from the unsharded batch {_relc(o, ref, 1e-8):.3e}"
            f", {bad} beyond rtol {SHARD_RTOL:g}")
        if bool(failed.any()) or bool(ref_failed.any()):
            raise RuntimeError("the fused mesh run lost members")
        if n_launch == 0 or n_launch != want:
            raise RuntimeError(f"{n_launch} launches for {want} loop steps")
        if bad:
            raise RuntimeError("the fused mesh run disagrees")
        if launches is None:
            launches = n_launch
            walls["fused_mesh"] = wall
    return walls, launches


def phase9_mixed(g, batch, dev, Cref):
    """(d) the north star with rhs_mixed False, "df32" and True."""
    import torch

    system = g.base_system()
    Co64 = g.default_co(device=dev)
    n = NORTH_STAR_N
    pb = g.Params.unpack(torch.as_tensor(batch[:n], device=dev))
    res, walls = {}, {}
    for mixed in (False, "df32", True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, ok, steps = g.solve_stiff_refill(
            system, Co64, pb, extract=_final_C, device=dev, method="rodas4",
            linsolve_dtype=torch.float32, rhs_mixed=mixed, lanes=n,
            **NORTH_STAR)
        torch.cuda.synchronize()
        walls[str(mixed)] = time.perf_counter() - t0
        err = _relc(out[0], Cref[0], 1e-8)
        res[mixed] = (out, steps)
        log(f"  (d) rhs_mixed={mixed!r}: {n} members in "
            f"{walls[str(mixed)]:.3f} s; {int((~ok).sum())} lost; steps "
            f"median {int(steps.median())}, max {int(steps.max())}; member "
            f"0 vs f64 RODAS4 at rtol {REF_TOL['rtol']:g}: max rel err "
            f"{err:.3e}")
        if not bool(ok.all()):
            raise RuntimeError(f"rhs_mixed={mixed!r} lost members")
        if not err <= ACCURACY_LIMIT:
            raise RuntimeError(f"rhs_mixed={mixed!r} is off the reference")
    (a, sa), (b, sb) = res[False], res["df32"]
    dsteps = int((sa - sb).abs().max())
    rel = float(((a - b).abs() / (a.abs() + 1e-6 * a.abs().max())).max())
    log(f"  (d) df32 against native f64: steps differ by at most {dsteps} "
        f"a member, values by {rel:.3e}")
    if dsteps > DF32_STEPS or not rel < DF32_REL:
        raise RuntimeError("the df32 RHS does not track native f64")
    return walls


def synthetic_plate(n, H, seed):
    """``n`` PLA images and cell-marker images of H x H pixels: 9 disk
    cells an image, puncta (Gaussian spots, sigma 1.5 px) inside them,
    a sloped background and noise; returns (pla, cell, puncta placed)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:H]
    pla = np.empty((n, H, H), np.float32)
    cell = np.empty((n, H, H), np.float32)
    wy, wx = np.mgrid[-7:8, -7:8]
    spot = np.exp(-(wy ** 2 + wx ** 2) / (2 * 1.5 ** 2))
    placed = []
    step = H // 3
    for i in range(n):
        c = np.full((H, H), 0.05)
        p = 0.1 + 0.2 * xx / H
        count = 0
        for gy in range(3):
            for gx in range(3):
                jit = step // 16
                cy = step // 2 + gy * step + int(rng.integers(-jit, jit + 1))
                cx = step // 2 + gx * step + int(rng.integers(-jit, jit + 1))
                r = int(rng.integers(step // 4, step * 2 // 5))
                c[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 0.8
                pts = []
                for _ in range(int(rng.integers(0, 12))):
                    py = cy + int(rng.integers(-r // 2, r // 2))
                    px = cx + int(rng.integers(-r // 2, r // 2))
                    if all(abs(py - qy) + abs(px - qx) > 12
                           for qy, qx in pts):
                        pts.append((py, px))
                        p[py - 7:py + 8, px - 7:px + 8] += spot
                count += len(pts)
        cell[i] = c + 0.01 * rng.standard_normal((H, H))
        pla[i] = p + 0.005 * rng.standard_normal((H, H))
        placed.append(count)
    return pla, cell, placed


def phase9_imaging(dev, on_cpu):
    """(e) puncta quantification of a 1024^2 plate on the card, against
    ``on_cpu``, plate_on_cpu's result (the card machine's CPU): counts,
    masks and labels equal."""
    import torch
    from gab1_shp2_tpu_torch.imaging import puncta

    t0 = time.perf_counter()
    pla, cell, placed = synthetic_plate(**PLATE)
    log(f"  (e) plate: {PLATE['n']} x {PLATE['H']}^2 pixels made in "
        f"{time.perf_counter() - t0:.1f} s; puncta placed {placed}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = puncta.count_puncta(pla, device=dev)
    labels = puncta.identify_cells(cell[0], device=dev)
    per_cell = puncta.count_puncta_per_cell(pla[0], cell[0], device=dev)
    torch.cuda.synchronize()
    walls = {"card": time.perf_counter() - t0, "cpu": on_cpu[-1]}
    if res.mask.device.type != dev.type:
        raise RuntimeError(f"count_puncta ran on {res.mask.device}")
    got = [(res.count.cpu(), res.mask.cpu(), labels.cpu(), per_cell),
           tuple(torch.as_tensor(x) for x in on_cpu[:3]) + (on_cpu[3],)]
    for name, (count, _, _, pc) in zip(("card", "cpu"), got):
        log(f"  (e) {name}: count_puncta over the plate, identify_cells "
            f"and count_puncta_per_cell of image 0 in {walls[name]:.3f} s"
            + (f" (a host worker, {HOST_THREADS} threads)"
               if name == "cpu" else "")
            + f"; counts {count.tolist()}; {len(pc.counts)} cells of image "
            f"0, puncta per cell {pc.counts.tolist()}, {pc.n_unassigned} "
            f"unassigned")
    (ca, ma, la, pa), (cb, mb, lb, pbc) = got
    same = (torch.equal(ca, cb) and torch.equal(ma, mb)
            and torch.equal(la, lb)
            and all(np.array_equal(x, y) for x, y in zip(pa, pbc)))
    if not same:
        raise RuntimeError("the card's puncta counts or labels differ from "
                           "the CPU's")
    return walls


def phase9_trace(g, batch, dev):
    """(f) progress.trace around one refill group on the card."""
    import json
    import os
    import shutil
    import tempfile

    import torch
    from gab1_shp2_tpu_torch.utils.progress import trace

    system = g.base_system()
    n = TRACE_RUN["n"]
    pb = g.Params.unpack(torch.as_tensor(batch[:n], dtype=torch.float32,
                                         device=dev))
    Co32 = g.default_co(dtype=torch.float32, device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        t0 = time.perf_counter()
        with trace(tmp) as run:
            g.solve_stiff_refill(system, Co32, pb, extract=_final_C,
                                 device=dev, method="rodas4", lanes=n,
                                 **dict(CFG, tf=TRACE_RUN["tf"]))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        size = os.path.getsize(run.path)
        with open(run.path) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"  (f) trace of a refill group ({n} members, tf="
            f"{TRACE_RUN['tf']:g}): "
            f"{wall:.3f} s with the profiler; {size / 1e6:.1f} MB, "
            f"{len(events)} events, {kernels} CUDA kernel events")
        if kernels == 0:
            raise RuntimeError("the trace holds no CUDA kernel events")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return wall


def phase9(g, batch, dev, p3, Cref, plate):
    """The mesh, the mixed RHS, imaging (``plate``: plate_on_cpu's result)
    and the trace on the card; each step raises on failure."""
    walls, launches = phase9_mesh(g, batch, dev, p3)
    walls.update({f"rhs_mixed={k}": v
                  for k, v in phase9_mixed(g, batch, dev, Cref).items()})
    walls.update({f"imaging_{k}": v
                  for k, v in phase9_imaging(dev, plate).items()})
    walls["trace"] = phase9_trace(g, batch, dev)
    return walls, launches


def phase10(dev, tight):
    """The bench entry point at reduced depth: every row of
    gab1_shp2_tpu_torch.bench against bench.py's tight reference
    (``tight``: tight_reference's result, solved on the host's CPU), then
    run_mesh over the card; raises on a failed gate."""
    import torch
    from gab1_shp2_tpu_torch import bench

    Cref = torch.as_tensor(tight[0], device=dev)
    walls = {"reference_cpu": tight[1]}
    log(f"  reference (solve_stiff trbdf2, f64, rtol 1e-8, member 0; a host "
        f"worker on the CPU, beside phases 0-9): {tight[1]:.3f} s")
    line = bench.main(dev, Cref=Cref, **BENCH_RUN)
    d = line["details"]
    rows = {"headline": dict(d, solves_per_sec=line["value"]),
            "chunked": d["chunked_scheduler"],
            "north_star": d["north_star"], "gsa_config": d["gsa_config"]}
    errs = {"headline": d["max_rel_err_vs_f64_rtol1e-8"],
            "north_star": d["north_star"]["max_rel_err_vs_f64_rtol1e-8"],
            "gsa_config": d["gsa_config"]["max_rel_err_vs_f64_rtol1e-8"]}
    for name, r in rows.items():
        walls[name] = r["wall_s"]
        log(f"  {name}: {d['N']} members in {r['wall_s']:.3f} s = "
            f"{r['solves_per_sec']:.3f} solves/s; {r['failed']} failed"
            + (f"; member 0 vs the reference: max rel err {errs[name]:.3e}"
               if name in errs else ""))
    roof = d["roofline"]
    log(f"  roofline: {roof['chunk_loop_steps']} chunk-loop steps, "
        f"{roof['steps_per_sec']} steps/s, {roof['achieved_GBps_model']} "
        f"GB/s modelled = {roof['pct_hbm_peak']}% of "
        f"{roof['hbm_peak_GBps']} GB/s; {d['device']}, {d['power_limit']}")
    mesh = bench.run_mesh()
    m = mesh["details"]
    walls["mesh"] = m["wall_s"]
    log(f"  run_mesh: {m['N']} members over {m['devices']} card(s) in "
        f"{m['wall_s']:.3f} s = {mesh['value']:.3f} solves/s; "
        f"{m['failed']} failed; consistent with the single queue: "
        f"{m['per_device_consistency_vs_single_queue']}")
    for out in (line, mesh):
        if json.loads(json.dumps(out)) != out:
            raise RuntimeError("a bench line does not serialise")
    failed = {n: r["failed"] for n, r in rows.items() if r["failed"]}
    if failed or m["failed"]:
        raise RuntimeError(f"members failed: {failed}, mesh {m['failed']}")
    if not all(e <= ACCURACY_LIMIT for e in errs.values()):
        raise RuntimeError(f"a row is off the reference: {errs}")
    if not roof["pct_hbm_peak"] <= 100:
        raise RuntimeError("the roofline reads above the HBM peak")
    if not m["per_device_consistency_vs_single_queue"]:
        raise RuntimeError("the sharded run disagrees with the single queue")
    return walls


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import gab1_shp2_tpu_torch  # noqa: F401  (raises outside the repo)

    # a pool's context manager terminates and joins its workers
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(HOST_WORKERS, worker_init,
                  (os.getpid(), HOST_THREADS, False)) as host, \
            ctx.Pool(1, worker_init, (os.getpid(), 0, True)) as beside:
        return smoke(host, beside)


def smoke(host, beside):
    """Phases 0-11 on the card, with ``host`` (a process pool on the
    host's CPU) solving the references and the plate's CPU side beside
    them, and ``beside`` (one process on the card) running phase 8 beside
    phase 7; returns the exit status."""
    import torch

    import gab1_shp2_tpu_torch as g
    from gab1_shp2_tpu_torch.bench import bench_ensemble, card_line
    from gab1_shp2_tpu_torch.ops import _build, explicit_cuda, ros23_cuda

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    batch = bench_ensemble(N)
    # the host's CPU tasks, started first; two workers take the first two,
    # the plate goes to whichever is free first
    on_host = dict(
        ref=host.apply_async(f64_reference, (batch[:4], CFG, REF_TOL)),
        tight=host.apply_async(tight_reference,
                               (batch[:1], CFG["dr"], CFG["tf"])),
        plate=host.apply_async(plate_on_cpu, (PLATE,)))
    card = card_line()

    t = time.perf_counter()
    log("phase 0: set-up")
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    # one nvcc per source, both started together
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        builds = [pool.submit(mod.build, g.base_system())
                  for mod in (ros23_cuda, explicit_cuda)]
        for b in builds:
            b.result()
    for lib in ("ros23_step", "explicit_solve"):
        info = _build.BUILD_LOG.get(lib)
        if info is not None:
            log(f"  nvcc build of {lib}.cu: {info['seconds']:.1f} s")
            for line in info["log"].splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    log(f"  ptxas: {line.strip()}")
    log(f"phase 0 wall {time.perf_counter() - t:.1f} s")

    rows = {}
    t = time.perf_counter()
    log("phase 1: fused Rosenbrock23 kernel vs ros23_step_plain, f32: "
        "B=256 at dr=0.2, B=64 at dr=0.1 and dr=0.05")
    phase1(g, batch, dev, rows)
    log(f"phase 1 wall {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2: chunked f32 rosenbrock23 through the kernel, N=1024")
    sps2 = phase2(g, batch, dev, rows)
    log(f"phase 2 wall {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 3: f32 rodas4 lane-refill headline (eager), N=1024")
    t_wait = time.perf_counter()
    C, wall = on_host["ref"].get(HOST_WAIT_S)
    Cref = torch.as_tensor(C, device=dev)
    log(f"  f64 RODAS4 at rtol {REF_TOL['rtol']:g}, members 0-3, on the "
        f"host's CPU beside phases 0-2: {wall:.1f} s (waited "
        f"{time.perf_counter() - t_wait:.1f} s here)")
    p3 = phase3(g, batch, dev, Cref)
    sps3 = p3["sps"]
    log(f"phase 3 wall {time.perf_counter() - t:.1f} s")

    erows = {}
    t = time.perf_counter()
    log("phase 4: fused explicit solve vs solve_explicit_plain, f32, "
        "maxiters 4")
    phase4(g, batch, dev, erows)
    log(f"phase 4 wall {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 5: the explicit path through the kernel, N=1024, dr=0.2, "
        "tf=5")
    sps5 = phase5(g, batch, dev, erows, Cref)
    log(f"phase 5 wall {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 6: the ensemble engine and the GSA runner")
    phase6(g, batch, dev)
    log(f"phase 6 wall {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    drivers = beside.apply_async(phase8_beside,
                                 ("cuda", DRIVER_ARGS, DRIVER_SMALL))
    log("phase 7: the single-member stiff solver and the inference path "
        "(dr=0.2, tf=5, float64), with phase 8 on the card beside it")
    inf = phase7(g, dev)
    log(f"phase 7 wall {time.perf_counter() - t:.1f} s")

    log("phase 8: the workload drivers, each through its main() on the "
        "card, in a process of its own beside phase 7")
    walls, wall8, text, err = drivers.get(HOST_WAIT_S)
    sys.stdout.write(text)
    if err is not None:
        raise RuntimeError(f"phase 8 failed:\n{err}")
    log(f"phase 8 wall {wall8:.1f} s; phases 7-8 "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 9: the sharded ensemble over a mesh of the card's slots, the "
        "mixed-precision RHS, PLA imaging and the trace")
    walls9, mesh_launches = phase9(g, batch, dev, p3, Cref,
                                   on_host["plate"].get(HOST_WAIT_S))
    log(f"phase 9 wall {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 10: the bench entry point (gab1_shp2_tpu_torch.bench), "
        f"N={BENCH_RUN['N']}, one timed run a row, and run_mesh")
    walls10 = phase10(dev, on_host["tight"].get(HOST_WAIT_S))
    log(f"phase 10 wall {time.perf_counter() - t:.1f} s")

    log("phase 11: kernels")
    kernels = [dict(
        name="ros23_step_fused", route="cuda",
        source="gab1_shp2_tpu_torch/csrc/ros23_step.cu",
        replaces="gab1_shp2_tpu/ops/ros23_pallas.py:323 "
                 "(_step_call, body _make_kernel)",
        launches=rows["launches"], max_abs_err=rows["max_abs_err"],
        max_err=rows["max_err"], f1_direct_err=rows["f1_direct_err"],
        est_scaled_err=rows["est_scaled_err"],
        ms=rows["ms"], ms_one_call=rows["ms_one_call"],
        ms_x4_lanes=rows["ms_x4_lanes"], ms_1_lane=rows["ms_1_lane"],
        ms_132_lanes=rows["ms_132_lanes"], ms_264_lanes=rows["ms_264_lanes"],
        parts_ms=rows["parts_ms"], blocks_per_sm=rows["blocks_per_sm"],
        layout="a block of 256 threads per lane, the arena in shared memory",
        arena_bytes=rows["arena_bytes"],
        ms_global_arena=rows["ms_global_arena"],
        ms_nb100_b64=rows["ms_nb100_b64"],
        ms_nb100_b64_global_arena=rows["ms_nb100_b64_global_arena"],
        ms_nb200_b64=rows["ms_nb200_b64"],
        launches_mesh_threads=mesh_launches,
        plain_ms=rows["plain_ms"], bound_ms=rows["bound_ms"],
        bound_by=rows["bound_by"], library_ms=None), dict(
        name="solve_explicit_fused", route="cuda",
        source="gab1_shp2_tpu_torch/csrc/explicit_solve.cu",
        replaces="gab1_shp2_tpu/ops/explicit_pallas.py:186 "
                 "(_run_block, body _make_kernel, step _step_fn)",
        launches=erows["launches"], max_abs_err=erows["max_abs_err"],
        max_err=erows["max_err"], vs_f64_stiff=erows["vs_f64_stiff"],
        ms=erows["ms"], ms_x4_members=erows["ms_x4_members"],
        plain_ms=erows["plain_ms"], plain_shape=erows["plain_shape"],
        ms_at_plain_shape=erows["ms_at_plain_shape"],
        bound_ms=erows["bound_ms"], bound_by=erows["bound_by"],
        layout=erows["layout"],
        blocks_per_sm=erows["blocks_per_sm"], registers=erows["registers"],
        layouts=erows["layouts"], library_ms=None)]
    log(f"solves/s (first readings, not a benchmark): chunked fused "
        f"rosenbrock23 {sps2:.2f}, refill rodas4 {sps3:.2f}, fused "
        f"explicit {sps5:.2f}")
    log("inference path, wall s (first readings): " + ", ".join(
        f"{k} {v:.2f}" for k, v in inf.items()))
    log("workload drivers, wall s (first readings): " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()))
    log(f"phase 9, wall s (first readings; {card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls9.items()))
    log(f"phase 10, wall s (first readings; {card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls10.items()))
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
