"""Run one cell as ``run.py`` does, with the program's recorder of spans
and counters (``gab1_shp2_tpu_torch.utils.progress``) switched on for the
window, and print one more JSON line after the result line: the host
milliseconds per loop iteration of each span, and the program's counters
beside the step wrapper's (``--trace 1``).

    python3 benchmark/recorded.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>
    python3 benchmark/recorded.py --chrome --workload <cell> --seed <n> \\
        --seconds 0 --trace 0

(``--cpu`` as a further argument runs on the host, for a rehearsal.)

``run.py`` never switches the recorder on: its runs measure the program
as users run it, and a ``--trace 0`` run here beside one of ``run.py``
on the same seed gives what the recorder costs.  With ``--trace 1`` the
times per iteration leave out the profiled sub-window and the profiler's
stop, as ``iteration_ms`` does.  ``--chrome`` replaces the window by one
request under ``progress.trace()`` (its Chrome trace goes to a temporary
directory, removed after) and prints, for each span, the kernel launches
and the device time of the kernels launched directly inside it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import defaultdict  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

SPANS = ("request", "group", "iteration", "harvest", "sync", "step",
         "dense_output", "rhs", "bands", "factor", "solve")


def per_iteration(rec, profiled=None) -> dict:
    """The recorder's numbers over the loop iterations outside
    ``profiled`` (a half-open range of iteration indices, or None)."""
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


def launches_by_span(profile) -> dict:
    """Kernel launches, copies and device time of a CUDA profile, each
    given to the innermost span (a host event of a name in ``SPANS``)
    around the host call that made it."""
    from torch.autograd import DeviceType
    spans, calls, kernels = [], [], {}
    for e in profile.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # a span's range on the card's timeline is no kernel
            if name not in SPANS:
                kernels[e.correlation_id()] = e.duration_ns()
        elif name in SPANS:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          name))
        elif name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                              "cudaMemset")):
            calls.append((e.start_ns(), e.correlation_id(),
                          "copies" if "Mem" in name else "launches"))
    spans.sort(key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    # each span's parent, by a sweep over the properly nested intervals
    parent, stack = [], []
    for i, (s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    table = defaultdict(lambda: dict(calls=0, launches=0, copies=0,
                                     device_ms=0.0))
    for _, _, name in spans:
        table[name]["calls"] += 1
    for t, corr, kind in calls:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][1] < t:
            i = parent[i]
        row = table[spans[i][2] if i >= 0 else "outside spans"]
        row[kind] += 1
        row["device_ms"] += kernels.pop(corr, 0) / 1e6
    table["unattributed kernels"]["device_ms"] = sum(kernels.values()) / 1e6
    table["unattributed kernels"]["launches"] = len(kernels)
    return dict(table)


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    flags = {a for a in ("--chrome", "--cpu") if a in args}
    args = [a for a in args if a not in flags]
    chrome = "--chrome" in flags
    import run
    # pin the process and its threads as run.py does, before anything
    # imports torch (run.main repeats it, to no further effect)
    run.environment()
    from harness import cell_run, window
    from gab1_shp2_tpu_torch.utils import progress

    seen = {}
    orig_window, orig_totals = window.run_window, window.Counter.totals

    def totals(counter):
        seen["wrapper"] = orig_totals(counter)
        return seen["wrapper"]

    def recorded_window(solve, requests, seconds, sync):
        with progress.record() as rec:
            seen["recorder"] = rec
            return orig_window(solve, requests, seconds, sync)

    def traced_request(solve, requests, seconds, sync):
        """One request under ``trace()``, as a window of one."""
        tmp = tempfile.mkdtemp(prefix="recorded_")
        try:
            with progress.trace(tmp) as tr:
                t0 = time.perf_counter()
                X = requests.next()
                out, ok = solve(X)
                sync()
                wall = time.perf_counter() - t0
            seen["recorder"] = tr.recorder
            seen["chrome_bytes"] = os.path.getsize(tr.path)
            seen["launches"] = launches_by_span(tr.profile)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return window.Window(seconds=wall, requests=[(X, out, ok)],
                             request_s=[wall], members=len(X),
                             solved=int(ok.sum()))

    window.run_window = traced_request if chrome else recorded_window
    window.Counter.totals = totals
    result = run.main(args, device="cpu" if "--cpu" in flags else None,
                      t_start=T_START)
    rec = seen["recorder"].read()
    profiled = None
    if "prof_iterations" in seen.get("wrapper", {}):
        # the profiled iterations, and the one after, whose step first
        # stops the profiler (``iteration_ms`` leaves that time out too)
        lo = cell_run.PROFILE_FROM
        profiled = range(lo, lo + seen["wrapper"]["prof_iterations"] + 1)
    line = dict(recorder=per_iteration(rec, profiled),
                wrapper=seen.get("wrapper"))
    if "iteration_ms" in result["metrics"]:
        line["iteration_ms"] = result["metrics"]["iteration_ms"]["value"]
    if chrome:
        line.update(chrome_bytes=seen["chrome_bytes"],
                    launches=seen["launches"])
    print(json.dumps(line), flush=True)
    return result, line


if __name__ == "__main__":
    main()
