"""The measured window: requests back to back, in a closed loop.

Each request is one ``run_ensemble`` call of the program over one
ensemble of the cell's traffic.  The window opens when the first request
starts and closes when the first request that completes after
``seconds`` does; its rate is all the work over all that time.

With ``--trace 1`` a wrapper around the program's step
(``ops.batch_stiff._SolverCtx.step``) keeps a reference to every call's
``active`` lane mask; it launches nothing on the device, and the masks
are summed once, after the window.  The same wrapper opens and closes
the profiler around a steady run of loop iterations.  The program's own
recorder, on for the whole traced window (``harness/cell_run.py``),
counts the same iterations from the same start.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from harness import profile


class Counter:
    """The step wrapper: one loop iteration of the scheduler is one call
    of the step for every lane."""

    def __init__(self, ctx_cls, prof_from: int, prof_iters: int, sync):
        self.ctx_cls, self.sync = ctx_cls, sync
        self.orig = ctx_cls.__dict__["step"]
        self.masks = []
        self.prof_from, self.prof_iters = prof_from, prof_iters
        self.prof = None
        self.prof_span = None       # loop iterations inside the profile

    def install(self):
        orig, counter = self.orig, self

        def step(ctx, f, lp, t1, active, st, jac=None):
            counter.before(len(counter.masks))
            out = orig(ctx, f, lp, t1, active, st, jac=jac)
            counter.masks.append(active)
            return out

        self.ctx_cls.step = step

    def remove(self):
        self.ctx_cls.step = self.orig
        self.stop_profile()

    def before(self, i):
        if i == self.prof_from and self.prof is None:
            self.sync()
            self.prof = profile.make_profiler()
            self.prof.start()
            self.prof_span = [i, None]
            self.prof_t0 = time.perf_counter()
        elif (self.prof_span is not None and self.prof_span[1] is None
              and i == self.prof_from + self.prof_iters):
            self.stop_profile()

    def stop_profile(self):
        if self.prof_span is not None and self.prof_span[1] is None:
            self.sync()
            self.prof.stop()
            self.prof_span[1] = len(self.masks)
            self.prof_host_s = time.perf_counter() - self.prof_t0

    def totals(self) -> dict:
        """Loop iterations, lane slots and active lane-steps of the whole
        window and of the profiled iterations (one device read)."""
        sums = (torch.stack([m.sum() for m in self.masks]).cpu().tolist()
                if self.masks else [])
        lanes = [m.numel() for m in self.masks]
        out = dict(iterations=len(sums), lane_slots=sum(lanes),
                   active=sum(sums))
        if self.prof_span is not None:
            a, b = self.prof_span
            out.update(prof_iterations=b - a, prof_active=sum(sums[a:b]),
                       prof_host_s=self.prof_host_s)
        return out


class Window(NamedTuple):
    seconds: float          # first request's start to last request's end
    requests: list          # (rows (N, 24) float64, outputs, valid mask)
    request_s: list         # each request's seconds
    members: int
    solved: int


def run_window(solve, requests, seconds: float, sync) -> Window:
    """Issue requests until the first one that completes after
    ``seconds``; ``solve(rows)`` runs one request and returns its
    outputs and validity mask, on the device."""
    done, each = [], []
    t0 = t1 = time.perf_counter()
    while True:
        X = requests.next()
        out, ok = solve(X)
        sync()
        done.append((X, out, ok))
        each.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    members = sum(len(X) for X, _, _ in done)
    solved = int(sum(int(ok.sum()) for _, _, ok in done))
    return Window(seconds=t1 - t0, requests=done, request_s=each,
                  members=members, solved=solved)


def reduce_profile(counter: Optional[Counter]) -> dict:
    if counter is None or counter.prof is None:
        return {}
    return profile.reduce(counter.prof)
