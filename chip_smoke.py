#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gab1_shp2_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds
it against its plain PyTorch version, drives the stiff ensemble solver
through its public entry points at the bench configuration (base
spherical model, dr=0.2, tf=5 min, Nts=2, rtol 1e-4, atol 1e-7, N=1024,
f32), and checks the results.  Phases:

  0. set-up: card, power limit, versions, kernel build (nvcc, sm_90a);
  1. the fused Rosenbrock23 kernel against ros23_step_plain at B=256 on
     a mid-transient state, for the base, rect and memb_sfk systems;
     CUDA-event times of both;
  2. the main path through the kernel: chunked f32 Rosenbrock23
     (step_impl="fused"), N=1024 in chunks of 256; launch counts are
     reset just before and read just after; chunk 0 is compared with the
     unfused step (step_impl="torch");
  3. the bench headline in eager PyTorch: f32 RODAS4 under the
     lane-refill scheduler, N=1024, 256 lanes; member 0 against a tight
     f64 RODAS4 solve;
  4. one JSON line describing every ported kernel.

Every phase raises on failure.  The last line of standard output is
``{"ok": true, "device": {...}}``.  It needs no network and imports no
JAX.  With no CUDA device it exits with status 2 and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N = 1024
CHUNK = 256
CFG = dict(dr=0.2, tf=5.0, Nts=2, rtol=1e-4, atol=1e-7)
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 on the CUDA cores (dense)
PEAK_HBM_BPS = 3.35e12   # H100 SXM HBM3


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_ensemble(g):
    """The bench.py ensemble: seed 0, sigma 0.10 lognormal around the
    default parameters, EGF (packed column 21) held fixed."""
    rng = np.random.default_rng(0)
    p0 = g.default_params(device="cpu").pack().numpy()
    batch = p0[None, :] * np.exp(rng.normal(0.0, 0.10, size=(N, 24)))
    batch[:, 21] = p0[21]
    return batch


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


def phase1(g, batch, dev, rows):
    """Kernel against its plain version on mid-transient states."""
    import torch
    from gab1_shp2_tpu_torch.ops import ros23_cuda
    from gab1_shp2_tpu_torch.ops.batch_stiff import (_SolverCtx,
                                                     make_mol_rhs_lanes)
    from gab1_shp2_tpu_torch.ops.rhs import effective_diffusivities

    B, R, dr = CHUNK, 10.0, CFG["dr"]
    Nr = int(round(R / dr))
    p = g.Params.unpack(torch.as_tensor(batch[:B], dtype=torch.float32,
                                        device=dev))
    Co = g.default_co(dtype=torch.float32, device=dev)
    h = torch.as_tensor(np.logspace(-3, -1, B), dtype=torch.float32,
                        device=dev)
    result = {}
    for name, system in (("base", g.base_system()),
                         ("rect", g.rect_system()),
                         ("memb_sfk", g.memb_sfk_system())):
        # a mid-transient state: the ensemble stepped to t=0.5 min
        sol = g.solve_stiff_batch(system, Co, p, device=dev, dr=dr, tf=0.5,
                                  Nts=1, rtol=1e-4, atol=1e-7,
                                  method="rodas4")
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
        log(f"  {name}: y1 rel-norm err {err_y:.3e}; f1 rel-norm err "
            f"{err_f:.3e} (vs f(kernel y1): {err_fc:.3e}); est scaled-norm "
            f"diff {err_e:.3e}; y1 max abs err {abs_y:.3e}")
        if name == "base":
            # the f32 floor of the direct f1 comparison: the same plain
            # step on the CPU (other op order) against the card's
            cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
            yc, fc, _ = ros23_cuda.ros23_step_plain(*cpu)
            log(f"  base, plain step CPU vs card: y1 rel-norm "
                f"{float((yc - yp.cpu()).norm() / yc.norm()):.3e}, f1 "
                f"rel-norm {float((fc - fp.cpu()).norm() / fc.norm()):.3e}")
        if not (err_y <= 1e-4 and err_fc <= 1e-4 and err_f <= 1e-3
                and err_e <= 1e-2):
            raise RuntimeError(f"{name}: kernel disagrees with "
                               "ros23_step_plain")
        result[name] = dict(err_y=err_y, err_f=err_f, err_fc=err_fc,
                            err_e=err_e, abs_y=abs_y)
        if name == "base":
            before = ros23_cuda.LAUNCHES
            ms = cuda_ms(lambda: ros23_cuda.ros23_step_fused(*args), reps=25)
            plain_ms = cuda_ms(lambda: ros23_cuda.ros23_step_plain(*args),
                               reps=5, warmup=1)
            # four times the lanes (the same states, tiled): how the time
            # scales with B shows whether lanes or SMs are the limit
            args4 = (system, y.repeat(1, 1, 4), f_n.repeat(1, 1, 4),
                     h.repeat(4), k.repeat(4, 1), d_eff.repeat(4, 1), Nr, dr)
            ms4 = cuda_ms(lambda: ros23_cuda.ros23_step_fused(*args4),
                          reps=10)
            ros23_cuda.LAUNCHES = before   # timing launches do not count
            flops = ros23_cuda.step_flops(Nr) * B
            nbytes = 4 * (5 * y.numel() + h.numel() + k.numel()
                          + d_eff.numel())
            bound_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BPS)
            bound_by = ("operations" if flops / PEAK_F32_FLOPS
                        >= nbytes / PEAK_HBM_BPS else "bytes")
            log(f"  base B={B}: kernel {ms:.4f} ms (median of 25), plain "
                f"{plain_ms:.4f} ms (median of 5); bound {bound_s * 1e3:.5f}"
                f" ms by {bound_by} ({flops / 1e6:.1f} MFLOP, "
                f"{nbytes / 1e6:.3f} MB)")
            log(f"  base B={4 * B}: kernel {ms4:.4f} ms (median of 10)")
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
                        bound_by=bound_by, ms_x4_lanes=ms4)
    rows["max_abs_err"] = max(r["abs_y"] for r in result.values())
    rows["max_err"] = max(max(r["err_y"], r["err_fc"])
                          for r in result.values())
    rows["f1_direct_err"] = max(r["err_f"] for r in result.values())
    rows["est_scaled_err"] = max(r["err_e"] for r in result.values())


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


def phase3(g, batch, dev):
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
    p64 = g.Params.unpack(torch.as_tensor(batch[:1], dtype=torch.float64,
                                          device=dev))
    ref = g.solve_stiff_batch(system, g.default_co(device=dev), p64,
                              device=dev, method="rodas4", dr=CFG["dr"],
                              tf=CFG["tf"], Nts=CFG["Nts"], rtol=1e-8,
                              atol=1e-11)
    Cref = ref.C[0, -1]
    relerr = float(((out[0].double() - Cref).abs()
                    / (Cref.abs() + 1e-8)).max())
    log(f"  member 0 vs f64 RODAS4 at rtol 1e-8: max rel err {relerr:.3e}")
    if not relerr <= 1e-3:
        raise RuntimeError("the refill headline is off the f64 reference")
    return N / wall


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import gab1_shp2_tpu_torch as g
    from gab1_shp2_tpu_torch.ops import _build, ros23_cuda

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()

    t = time.perf_counter()
    log("phase 0: set-up")
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    ros23_cuda.build(g.base_system())
    info = _build.BUILD_LOG.get("ros23_step")
    if info is not None:
        log(f"  nvcc build of ros23_step.cu: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"phase 0 wall {time.perf_counter() - t:.1f} s")

    batch = bench_ensemble(g)
    rows = {}
    t = time.perf_counter()
    log("phase 1: fused Rosenbrock23 kernel vs ros23_step_plain, B=256, "
        "dr=0.2, f32")
    phase1(g, batch, dev, rows)
    log(f"phase 1 wall {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2: chunked f32 rosenbrock23 through the kernel, N=1024")
    sps2 = phase2(g, batch, dev, rows)
    log(f"phase 2 wall {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 3: f32 rodas4 lane-refill headline (eager), N=1024")
    sps3 = phase3(g, batch, dev)
    log(f"phase 3 wall {time.perf_counter() - t:.1f} s")

    log("phase 4: kernels")
    kernels = [dict(
        name="ros23_step_fused", route="cuda",
        source="gab1_shp2_tpu_torch/csrc/ros23_step.cu",
        replaces="gab1_shp2_tpu/ops/ros23_pallas.py:323 "
                 "(_step_call, body _make_kernel)",
        launches=rows["launches"], max_abs_err=rows["max_abs_err"],
        max_err=rows["max_err"], f1_direct_err=rows["f1_direct_err"],
        est_scaled_err=rows["est_scaled_err"],
        ms=rows["ms"], ms_x4_lanes=rows["ms_x4_lanes"],
        plain_ms=rows["plain_ms"], bound_ms=rows["bound_ms"],
        bound_by=rows["bound_by"], library_ms=None)]
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"solves/s (first readings, not a benchmark): chunked fused "
        f"rosenbrock23 {sps2:.2f}, refill rodas4 {sps3:.2f}")
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
