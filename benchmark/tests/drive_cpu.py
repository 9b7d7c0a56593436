"""Drive one run of a cell on the CPU, past the harness's look for a card,
optionally with the timed path broken underneath.

    python drive_cpu.py <checkout> <fault|none> <run.py arguments...>

``<checkout>`` holds ``BENCHMARK.json`` and ``benchmark/``; the program is
imported from the repository this file lives in.  Faults:

* ``frozen_step``: every step returns its state unchanged (the clock and
  counters advance, the solution does not);
* ``half_batch``: only the first half of each request's members is
  solved; the rest get the mean of the solved half's outputs;
* ``altered_answer``: every saved profile is off by one part in a
  thousand where the step writes it;
* ``shifted_save``: the middle save of every member holds the save
  after it, where the program hands a member's saves to the request's
  ``extract`` (a final state is untouched).
"""

from __future__ import annotations

import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]


def frozen_step():
    from gab1_shp2_tpu_torch.ops import batch_stiff
    orig = batch_stiff._SolverCtx.step

    def step(self, f, lp, t1, active, st, jac=None):
        new, ok = orig(self, f, lp, t1, active, st, jac=jac)
        return new._replace(y=st.y), ok

    batch_stiff._SolverCtx.step = step


def half_batch():
    import torch
    from gab1_shp2_tpu_torch.ensemble import engine

    orig = engine.run_ensemble

    def run_ensemble(system, Co, ensemble, **kw):
        X = torch.as_tensor(ensemble)
        h = max(1, X.shape[0] // 2)
        (C, m), ok = orig(system, Co, X[:h], **kw)
        rest = X.shape[0] - h
        C = torch.cat([C, C.mean(0, keepdim=True).expand(rest, *C.shape[1:])])
        m = torch.cat([m, m.mean(0, keepdim=True).expand(rest, *m.shape[1:])])
        ok = torch.cat([ok, ok.new_ones(rest)])
        return (C, m), ok

    engine.run_ensemble = run_ensemble


def altered_answer():
    from gab1_shp2_tpu_torch.ops import batch_stiff
    orig = batch_stiff._SolverCtx.snapshot

    def snapshot(self, y, lp):
        C, m = orig(self, y, lp)
        return C * 1.001, m

    batch_stiff._SolverCtx.snapshot = snapshot


def shifted_save():
    import torch
    from gab1_shp2_tpu_torch.ensemble import engine

    orig = engine.run_ensemble

    def run_ensemble(system, Co, ensemble, *, extract, **kw):
        def shifted(sol):
            k = sol.C.shape[0] // 2
            idx = torch.arange(sol.C.shape[0])
            idx[k] = k + 1
            return extract(sol._replace(C=sol.C[idx], m=sol.m[idx]))

        return orig(system, Co, ensemble, extract=shifted, **kw)

    engine.run_ensemble = run_ensemble


FAULTS = dict(frozen_step=frozen_step, half_batch=half_batch,
              altered_answer=altered_answer, shifted_save=shifted_save)

if __name__ == "__main__":
    t0 = time.perf_counter()
    checkout = pathlib.Path(sys.argv[1])
    sys.path[:0] = [str(checkout / "benchmark"), str(REPO)]
    import run
    if sys.argv[2] != "none":
        FAULTS[sys.argv[2]]()
    run.main(sys.argv[3:], device="cpu", t_start=t0)
