"""Per-file worker time of a tier-1 run, from its junit XML record.

Read a record::

    python scripts/tier1_times.py run.xml

prints one row a test file (worker seconds summed over setup, call and
teardown of its tests, the tests' count and, where the record has them,
the worker that ran the file, its first start and last end in seconds
from the run's first start, and that wall), then the sum over all files
and the sum divided by tier-1's six xdist workers: under ``--dist
loadfile`` the run's wall cannot fall below that quotient, nor below the
longest file.

The same module is a pytest plugin that adds those clock readings to
the record. Run pytest from the repo root with
``PYTHONPATH=scripts python -m pytest ... -p tier1_times --junitxml=run.xml``:
each test case then carries the properties ``worker`` (the xdist worker's
id, ``main`` without xdist), ``start`` (epoch seconds when its setup
began) and ``end`` (when its teardown ended).
"""

from __future__ import annotations

import os
import sys
import xml.etree.ElementTree as ET
from collections import defaultdict

import pytest

WORKERS = 6  # tier-1's ``-n 6``


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    # The junit record takes the teardown report's properties, which copy
    # the item's when the report is made: append before it is.
    if call.when == "setup":
        item.user_properties.append(
            ("worker", os.environ.get("PYTEST_XDIST_WORKER", "main")))
        item.user_properties.append(("start", f"{call.start:.3f}"))
    elif call.when == "teardown":
        item.user_properties.append(("end", f"{call.stop:.3f}"))
    yield


def file_of(classname: str) -> str:
    """``tests.test_x.TestY`` -> ``tests/test_x.py``."""
    parts = classname.split(".")
    for i, part in enumerate(parts):
        if part.startswith("test_") or part == "conftest":
            return "/".join(parts[:i + 1]) + ".py"
    return "/".join(parts) + ".py" if classname else "(no file)"


def per_file(path: str) -> dict[str, dict]:
    """File -> {seconds, tests, workers, start, end} from a junit XML."""
    files: dict[str, dict] = defaultdict(lambda: dict(
        seconds=0.0, tests=0, workers=set(), start=None, end=None))
    for case in ET.parse(path).getroot().iter("testcase"):
        row = files[file_of(case.get("classname", ""))]
        row["seconds"] += float(case.get("time") or 0.0)
        row["tests"] += 1
        props = {p.get("name"): p.get("value")
                 for p in case.iter("property")}
        if "worker" in props:
            row["workers"].add(props["worker"])
        if "start" in props:
            t = float(props["start"])
            row["start"] = t if row["start"] is None else min(row["start"], t)
        if "end" in props:
            t = float(props["end"])
            row["end"] = t if row["end"] is None else max(row["end"], t)
    return dict(files)


def table(files: dict[str, dict], workers: int = WORKERS) -> str:
    starts = [r["start"] for r in files.values() if r["start"] is not None]
    t0 = min(starts) if starts else None
    rows = sorted(files.items(), key=lambda kv: -kv[1]["seconds"])
    lines = [f"{'file':<44} {'worker_s':>9} {'tests':>5} {'worker':>8} "
             f"{'start':>8} {'end':>8} {'wall':>8}"]
    for name, r in rows:
        clock = ("", "", "")
        if t0 is not None and r["start"] is not None and r["end"] is not None:
            clock = (f"{r['start'] - t0:.1f}", f"{r['end'] - t0:.1f}",
                     f"{r['end'] - r['start']:.1f}")
        lines.append(f"{name:<44} {r['seconds']:>9.1f} {r['tests']:>5} "
                     f"{','.join(sorted(r['workers'])):>8} "
                     f"{clock[0]:>8} {clock[1]:>8} {clock[2]:>8}")
    total = sum(r["seconds"] for r in files.values())
    port = sum(r["seconds"] for n, r in files.items()
               if os.path.basename(n).startswith("test_torch_"))
    lines.append(f"total worker seconds {total:.1f} "
                 f"(port files {port:.1f}); total / {workers} = "
                 f"{total / workers:.1f}")
    if starts:
        ends = [r["end"] for r in files.values() if r["end"] is not None]
        lines.append(f"first start to last end {max(ends) - t0:.1f} s")
    return "\n".join(lines)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python scripts/tier1_times.py RUN.xml")
    print(table(per_file(sys.argv[1])))
