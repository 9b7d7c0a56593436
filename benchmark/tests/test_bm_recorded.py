"""``recorded.py``: a cell's run with the program's recorder on for the
window.  Its numbers per loop iteration from a synthetic recording, and
one traced run of the tiny cell on the CPU, whose recorder line holds
every number and whose program counters equal the step wrapper's."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from test_bm_harness import CELL, REPO, checkout  # noqa: F401

import recorded
from gab1_shp2_tpu_torch.utils import progress

NUMBERS = ("host_syncs_per_iteration", "sync_wait_ms", "step_host_ms",
           "accepted_step_pct", "rhs_host_ms", "bands_host_ms",
           "linalg_host_ms")


def _synthetic():
    """Two loop iterations (the second one profiled), each a step with
    one RHS, the bands, a factor and a solve, a sync in the step and a
    harvest with a sync of its own in the first."""
    S = progress.Span
    spans, n = [], 0

    def add(name, start, end, parent, it):
        nonlocal n
        spans.append(S(n, name, start, end, parent, 0, it))
        n += 1
        return n - 1

    for it, base in ((0, 0), (1, 1000)):
        i = add("iteration", base, base + 900, None, it)
        s = add("step", base + 10, base + 710, i, it)
        add("rhs", base + 20, base + 120, s, it)
        add("bands", base + 130, base + 230, s, it)
        add("factor", base + 240, base + 440, s, it)
        add("solve", base + 450, base + 500, s, it)
        add("sync", base + 600, base + 700, s, it)
        if it == 0:
            h = add("harvest", base + 720, base + 880, i, it)
            add("sync", base + 730, base + 760, h, it)
    counters = dict(iterations=2, host_syncs=3, accepted_steps=9,
                    active_lane_steps=12)
    return progress.Recording(sorted(spans, key=lambda s: s.start_ns),
                              counters)


def test_numbers_per_iteration():
    out = recorded.per_iteration(_synthetic(), profiled=range(1, 2))
    assert out["iterations_timed"] == 1
    assert out["host_syncs_per_iteration"] == 1.5       # the whole window
    assert out["accepted_step_pct"] == 75.0
    ms = pytest.approx
    assert out["iteration_span_ms"] == ms(900e-6)
    assert out["sync_wait_ms"] == ms(130e-6)
    assert out["step_host_ms"] == ms(600e-6)
    assert out["rhs_host_ms"] == ms(100e-6)
    assert out["bands_host_ms"] == ms(100e-6)
    assert out["linalg_host_ms"] == ms(250e-6)
    ex = out["exclusive_ms"]
    assert sum(ex.values()) == ms(out["iteration_span_ms"])
    assert ex["step"] == ms(150e-6) and ex["harvest"] == ms(130e-6)
    whole = recorded.per_iteration(_synthetic())
    assert whole["iterations_timed"] == 2
    assert whole["step_host_ms"] == ms(600e-6)

def test_traced_run_prints_the_recorder_line(checkout):  # noqa: F811
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    p = subprocess.run(
        [sys.executable, "benchmark/recorded.py", "--cpu", "--workload",
         CELL, "--seed", "3000000019", "--seconds", "0.1", "--trace", "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=checkout)
    assert p.returncode == 0, p.stderr[-3000:]
    result, line = map(json.loads, p.stdout.strip().splitlines()[-2:])
    assert result["correct"] is True
    assert {"lane_occupancy_pct", "member_steps",
            "iteration_ms"} <= set(result["metrics"])
    rec, wrapper = line["recorder"], line["wrapper"]
    for name in NUMBERS:
        assert rec[name] is not None and rec[name] >= 0, name
    c = rec["counters"]
    assert (c["iterations"], c["lane_slots"], c["active_lane_steps"]) == (
        wrapper["iterations"], wrapper["lane_slots"], wrapper["active"])
    assert c["members"] == result["attempted"]
