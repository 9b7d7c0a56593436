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

``run.py`` switches the recorder on only with ``--trace 1``: its
``--trace 0`` runs measure the program as users run it, and a
``--trace 0`` run here beside one of ``run.py`` on the same seed gives
what the recorder costs.  With ``--trace 1`` this reads the recorder
that ``run.py`` switched on, and the times per iteration leave out the
profiled sub-window and the profiler's stop, as ``iteration_ms`` does.
``--chrome`` replaces the window by one request under
``progress.trace()`` (its Chrome trace goes to a temporary directory,
removed after) and prints, for each span, the kernel launches and the
device time of the kernels launched directly inside it.
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

from harness.recording import SPANS, per_iteration, slowed  # noqa: E402


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
        if progress.RECORDER is not None:
            # a --trace 1 run records its window already
            seen["recorder"] = progress.RECORDER
            return orig_window(solve, requests, seconds, sync)
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
    profiled = slowed(seen.get("wrapper", {}), cell_run.PROFILE_FROM)
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
