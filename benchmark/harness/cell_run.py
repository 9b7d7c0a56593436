"""One run of one cell: set-up, the window, the readings, the check."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from harness import check, recording, spec, window

# the profiled sub-window: loop iterations [PROFILE_FROM, PROFILE_FROM +
# PROFILE_ITERS) of the window, counted from its first request's start
PROFILE_FROM = 20
PROFILE_ITERS = 30
# the warm-up's span of model time, as a share of the configuration's
WARMUP_TF_SHARE = 0.01


def final_state(sol):
    """What a request keeps of a member by default: its final bulk
    profile (10, Nr+1) and membrane state (8,)."""
    return sol.C[-1], sol.m[-1]


def trajectory(sol):
    """What a request keeps of a member under ``"keep": "trajectory"``:
    its bulk profiles (Nts+1, 10, Nr+1) and membrane states (Nts+1, 8)
    at every save time, as the drivers' dense jobs keep them."""
    return sol.C, sol.m


# what a request keeps of each member, by the traffic file's "keep"
KEEP = dict(final=final_state, trajectory=trajectory)


def keep(cell) -> str:
    """The traffic's ``keep``: "final" when it names none."""
    name = cell.traffic.get("keep", "final")
    if name not in KEEP:
        raise ValueError(f"keep {name!r}: not one of {sorted(KEEP)}")
    return name


def _dtype(name):
    return None if name is None else getattr(torch, name)


def program_settings(cell, control: bool) -> dict:
    """The configuration's precision, with the control's switch (the
    next precision down) applied when asked for."""
    cfg = cell.config
    out = dict(state_dtype=cfg["state_dtype"],
               linsolve_dtype=cfg.get("linsolve_dtype"))
    if control:
        out.update(cell.limits["control"]["switch"])
    return out


def run_cell(cell, *, seed, seconds, trace, control, device, t_start):
    """Returns (result dict, the check's lines for standard error)."""
    import gab1_shp2_tpu_torch as port
    from gab1_shp2_tpu_torch.ensemble.engine import run_ensemble
    from gab1_shp2_tpu_torch.ops.batch_stiff import _SolverCtx
    from gab1_shp2_tpu_torch.utils import progress

    from harness.traffic import Requests

    cfg = cell.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    prog = program_settings(cell, control)
    system = getattr(port, cfg["system"])()
    Co_list = spec.initial_concentrations(cfg)
    Co = torch.tensor(Co_list, dtype=_dtype(prog["state_dtype"]),
                      device=dev)
    kw = dict(solver="stiff", method=cfg["method"], rtol=cfg["rtol"],
              atol=cfg["atol"], max_steps=int(cfg["max_steps"]),
              chunk=int(cfg["lanes"]), R=float(cfg["R"]),
              dr=float(cfg["dr"]), Nts=int(cell.traffic["Nts"]),
              linsolve_dtype=_dtype(prog["linsolve_dtype"]), device=dev,
              extract=KEEP[keep(cell)])

    def solve(X, tf=float(cfg["tf"])):
        (C, m), ok = run_ensemble(system, Co, X, tf=tf, **kw)
        return (C, m), ok

    requests = Requests(cell.traffic, cfg["params"], seed)
    # warm-up: the cell's lanes, dtypes and output shapes, over a short
    # span of model time
    center = np.array(list(cfg["params"].values()), dtype=np.float64)
    warm = np.repeat(center[None], int(cfg["lanes"]), axis=0)
    solve(warm, tf=float(cfg["tf"]) * WARMUP_TF_SHARE)
    counter = None
    if trace:
        p = window.profile.make_profiler()
        p.start()
        torch.ones(8, device=dev).sum().item()
        p.stop()
        counter = window.Counter(_SolverCtx, PROFILE_FROM, PROFILE_ITERS,
                                 sync)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    if counter is not None:
        counter.install()
    try:
        # the traced run records the program's spans and counters; the
        # untraced one runs the program as its users do
        with (progress.record() if trace
              else contextlib.nullcontext()) as rec:
            win = window.run_window(solve, requests, seconds, sync)
    finally:
        if counter is not None:
            counter.remove()
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    result = dict(correct=None, attempted=win.members,
                  failed=win.members - win.solved)
    metrics, breakdown = {}, None
    dev_info = dict(platform="gpu" if cuda else dev.type,
                    kind=torch.cuda.get_device_name(dev) if cuda
                    else "cpu", count=cell.chips, memory_peak_bytes=peak)
    if not trace:
        values = dict(solves_per_s=win.solved / win.seconds,
                      setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=values[m["name"]],
                                      unit=m["unit"])
    else:
        ctx = dict(counter.totals(), members=win.members,
                   window_s=win.seconds, config=cfg,
                   device_kind=dev_info["kind"],
                   profile=window.reduce_profile(counter))
        ctx["recorded"] = recording.per_iteration(
            rec.read(), recording.slowed(ctx, PROFILE_FROM))
        for m in cell.per_layer:
            v = spec.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        if ctx["profile"]:
            dev_info.update(busy_s=ctx["profile"]["busy_s"],
                            window_s=ctx["profile"]["window_s"])
            breakdown = dict(device_ops=ctx["profile"]["device_ops"],
                             idle_gaps=ctx["profile"]["idle_gaps"])
    result["metrics"] = metrics
    result["device"] = dev_info
    if breakdown is not None:
        result["breakdown"] = breakdown

    req_line = ("requests: " + ", ".join(f"{t:.3f}" for t in win.request_s)
                + f" s; window {win.seconds:.3f} s; set-up {setup_s:.3f} s")
    correct, shown, lines = verify(cell, win, seed, Co_list)
    result["correct"] = correct
    result["checks"] = shown
    return result, [req_line] + lines


def verify(cell, win, seed, Co_list):
    """Free the program's state, solve the sample with the reference,
    compare.  Returns (correct, {number: value and limit}, lines)."""
    lim = cell.limits
    picks = check.pick([len(X) for X, _, _ in win.requests],
                       int(lim["sample"]), seed)
    rows, C, m, ok = [], [], [], []
    for r, i in picks:
        X, (Cr, mr), okr = win.requests[r]
        rows.append(X[i])
        C.append(Cr[i].double().cpu().numpy())
        m.append(mr[i].double().cpu().numpy())
        ok.append(bool(okr[i]))
    win.requests.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ok = np.array(ok)
    rows = np.stack(rows)[ok]
    cfg = cell.config
    t0 = time.perf_counter()
    t_save = None
    if keep(cell) == "trajectory":
        t_save = np.linspace(0.0, float(cfg["tf"]),
                             int(cell.traffic["Nts"]) + 1)
    if len(rows):
        C_ref, m_ref = check.reference(cfg["reference"], rows, Co_list, cfg,
                                       lim["reference_tolerance"],
                                       t_save=t_save)
        errs = check.member_errors(np.stack(C)[ok], np.stack(m)[ok], C_ref,
                                   m_ref, float(cfg["rtol"]),
                                   float(cfg["atol"]))
    else:
        errs = np.array([])
    nums = check.numbers(errs)
    correct, shown = check.verdict(nums, lim["numbers"])
    lines = [f"sampled {len(picks)} members, {int(ok.sum())} valid; the "
             f"reference took {time.perf_counter() - t0:.1f} s"]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in shown.items()]
    return correct, shown, lines
