"""The program's recorder of spans and counters
(``gab1_shp2_tpu_torch.utils.progress``), reduced to numbers per loop
iteration of the scheduler.

A ``--trace 1`` run keeps the recorder on for the whole window
(``harness/cell_run.py``); the per-layer readers find what
:func:`per_iteration` returns under ``ctx["recorded"]``.  The loop
iterations that the profiled sub-window slowed are left out of the times,
as ``iteration_ms`` leaves them out; the counters are the whole
window's.

This module imports neither torch nor the program.
"""

from __future__ import annotations

# the program's span names, from the request down to the linear algebra
SPANS = ("request", "group", "iteration", "harvest", "sync", "step",
         "dense_output", "rhs", "bands", "factor", "solve")


def slowed(totals: dict, prof_from: int):
    """The loop iterations that the profile slowed: the profiled ones
    and the one after, whose step first stops the profiler; None when
    nothing was profiled.  ``totals`` is the step wrapper's
    (``window.Counter.totals``)."""
    if "prof_iterations" not in totals:
        return None
    return range(prof_from, prof_from + totals["prof_iterations"] + 1)


def per_iteration(rec, profiled=None) -> dict:
    """The recorder's numbers over the loop iterations outside
    ``profiled`` (a range of iteration indices, or None); an empty dict
    when no loop iteration was recorded."""
    c = rec.counters

    def skip(i):
        return profiled is not None and i is not None and i in profiled

    n = sum(1 for s in rec.spans
            if s.name == "iteration" and not skip(s.iteration))
    if not n:
        return {}

    def ms(name, less=("sync",)):
        return rec.self_ns(name, less, skip) / n / 1e6

    out = dict(
        iterations_timed=n,
        iteration_span_ms=ms("iteration", ()),
        host_syncs_per_iteration=c["host_syncs"] / c["iterations"],
        sync_wait_ms=ms("sync"),
        step_host_ms=ms("step"),
        accepted_step_pct=100.0 * c["accepted_steps"]
        / c["active_lane_steps"],
        rhs_host_ms=ms("rhs"),
        bands_host_ms=ms("bands"),
        linalg_host_ms=ms("factor") + ms("solve"))
    # each span less all its recorded children: the parts add up to the
    # iteration span
    out["exclusive_ms"] = {name: ms(name, SPANS) for name in SPANS[2:]}
    out["counters"] = dict(c)
    return out
