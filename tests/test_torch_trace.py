"""The recorder of ``gab1_shp2_tpu_torch.utils.progress`` on the refill
path, on the CPU: one tiny ensemble (float32 RODAS4, dr = 1, six members
on four lanes, so lanes are harvested and refilled) solved through
``run_ensemble`` under a ``torch.profiler`` profile twice, with the
recorder on and off.  A wrapper around ``_SolverCtx.step`` keeps every
call's ``active`` mask, as the benchmark's does, to hold the program's
counters against."""

from __future__ import annotations

import json
from collections import Counter

import pytest
import torch

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.ensemble import engine
from gab1_shp2_tpu_torch.ops.batch_stiff import _SolverCtx
from gab1_shp2_tpu_torch.utils import progress

N, LANES = 6, 4
# tf and its save points exact in float32; a dozen loop iterations
RUN = dict(solver="stiff", method="rodas4", dr=1.0, tf=1 / 128, Nts=2,
           chunk=LANES, rtol=1e-4, atol=1e-7, device="cpu")
SPANS = ("request", "group", "iteration", "harvest", "sync", "step",
         "dense_output", "rhs", "bands", "factor", "solve")
KERNELS = ("rhs", "bands", "factor", "solve")


def _final_C(sol):
    return sol.C[-1]


def _ensemble(n=N):
    g = torch.Generator().manual_seed(7)
    X = tg.default_params(device="cpu").pack()[None].repeat(n, 1).float()
    return X * torch.exp(0.3 * torch.randn(X.shape, generator=g))


def _co():
    return tg.default_co(dtype=torch.float32, device="cpu")


def _solve(masks):
    """One request; every step call's ``active`` mask lands in
    ``masks``."""
    orig = _SolverCtx.__dict__["step"]

    def step(ctx, f, lp, t1, active, st, jac=None):
        masks.append(active)
        return orig(ctx, f, lp, t1, active, st, jac=jac)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_SolverCtx, "step", step)
        return tg.run_ensemble(tg.base_system(), _co(), _ensemble(),
                               extract=_final_C, **RUN)


def _profiled(fn):
    """``fn()`` under a CPU profile; returns its result and the profile's
    host events as (name, start ns, end ns)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()]


def _top_level_ops(events):
    """The names of the operations no other operation encloses."""
    out, end = Counter(), None
    for s, e, n in sorted((s, -e, n) for n, s, e in events
                          if n.startswith("aten::")):
        if end is None or s >= end:
            out[n] += 1
            end = -e
    return out


@pytest.fixture(scope="module")
def runs():
    """The recorded run (with the refill calls' returned steps kept) and
    the run with the recorder off."""
    steps = []
    orig_refill = engine.solve_stiff_refill

    def refill(*args, **kwargs):
        out = orig_refill(*args, **kwargs)
        steps.append(out[2])
        return out

    on_masks, off_masks = [], []
    with pytest.MonkeyPatch.context() as mp, progress.record() as rec:
        mp.setattr(engine, "solve_stiff_refill", refill)
        on, on_events = _profiled(lambda: _solve(on_masks))
    read = rec.read()
    off, off_events = _profiled(lambda: _solve(off_masks))
    return dict(on=on, off=off, rec=read, after=rec.read(),
                on_masks=on_masks, off_masks=off_masks, steps=steps,
                on_events=on_events, off_events=off_events)


def test_counters_equal_the_step_wrapper(runs):
    c, masks = runs["rec"].counters, runs["on_masks"]
    assert c["iterations"] == len(masks) == len(runs["off_masks"])
    assert c["lane_slots"] == sum(m.numel() for m in masks) == \
        c["iterations"] * LANES
    assert c["active_lane_steps"] == sum(int(m.sum()) for m in masks)
    assert c["harvests"] >= 2     # six members on four lanes: a refill


def test_active_lane_steps_are_the_returned_steps(runs):
    c = runs["rec"].counters
    (steps,) = runs["steps"]      # one refill group
    assert c["active_lane_steps"] == int(steps.sum())
    assert 0 < c["accepted_steps"] <= c["active_lane_steps"]
    out, ok = runs["on"]
    assert c["members"] == N
    assert c["members_failed"] == int((~ok).sum())


def test_host_syncs_are_the_sync_spans(runs):
    rec = runs["rec"]
    syncs = [s for s in rec.spans if s.name == "sync"]
    assert rec.counters["host_syncs"] == len(syncs) > 0
    # every read the host makes of a device value in the recorder-off run
    # is one the helper counts when the recorder is on
    reads = sum(1 for n, _, _ in runs["off_events"]
                if n == "aten::_local_scalar_dense")
    assert reads == len(syncs)


def test_spans_nest_by_layer(runs):
    spans = runs["rec"].spans
    by_id = {s.id: s for s in spans}
    (req,) = [s for s in spans if s.name == "request"]
    assert {s.request for s in spans} == {req.id}

    def ancestors(s):
        out = []
        while s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
            out.append(up)
            s = up
        return out

    iters = [s for s in spans if s.name == "iteration"]
    assert [s.iteration for s in iters] == list(range(len(iters)))
    for s in spans:
        up = ancestors(s)
        names = [u.name for u in up]
        if s.name in KERNELS:
            assert "step" in names, (s.name, names)
            assert names.index("step") < names.index("iteration") < \
                names.index("group") < names.index("request") == \
                len(names) - 1
        it = [u.iteration for u in up if u.name == "iteration"]
        if s.name != "iteration":
            assert s.iteration == (it[0] if it else None)


def test_recorder_off_changes_nothing_and_records_nothing(runs):
    (out_on, ok_on), (out_off, ok_off) = runs["on"], runs["off"]
    assert torch.equal(out_on, out_off) and torch.equal(ok_on, ok_off)
    assert runs["after"] == runs["rec"]        # the off run added nothing
    assert not {n for n, _, _ in runs["off_events"]} & {*SPANS, "recorder"}
    # the recorder's own operations: per harvest, the accepted steps of
    # the harvested lanes summed; per group, the two sums read after its
    # loop (zeros, stack, tolist); per request, the failed members read
    h = runs["rec"].counters["harvests"]
    on, off = (_top_level_ops(runs[k]) for k in ("on_events", "off_events"))
    assert on - off == Counter({
        "aten::where": h, "aten::add": h, "aten::sum": h + 2,
        "aten::zeros": 1, "aten::stack": 1, "aten::resolve_conj": 1,
        "aten::resolve_neg": 1, "aten::bitwise_not": 1, "aten::item": 1})
    assert not off - on
    assert runs["rec"].counters["iterations"] > 4 * h
    # and it reads one value of the device more than the program, per
    # request
    reads = [sum(1 for n, _, _ in runs[k] if n == "aten::_local_scalar_dense")
             for k in ("on_events", "off_events")]
    assert reads[0] == reads[1] + 1


def test_spans_stand_on_the_profiler_clock(runs):
    """Every span is a host event of its name in the profile, and the
    recorder's start is the event's, to a few microseconds in the
    median.  The two clocks are read at two moments: a span between
    whose readings the profiler grew its event buffers, or the host ran
    something else, may lie past 100 µs (a few in a hundred allowed)."""
    theirs, mine = {}, {}
    for n, t, _ in runs["on_events"]:
        if n in SPANS:
            theirs.setdefault(n, []).append(t)
    for s in runs["rec"].spans:
        mine.setdefault(s.name, []).append(s.start_ns)
    assert set(mine) == set(theirs) == set(SPANS)
    gaps = []
    for name in SPANS:
        assert len(theirs[name]) == len(mine[name]), name
        gaps += [abs(a - b) for a, b in zip(sorted(mine[name]),
                                            sorted(theirs[name]))]
    gaps.sort()
    assert gaps[len(gaps) // 2] <= 20_000, gaps[len(gaps) // 2]
    assert sum(g > 100_000 for g in gaps) <= len(gaps) // 30, gaps[-8:]


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    """``trace()`` switches the recorder on: its Chrome trace holds the
    spans by name, and its run yields the recorder's read."""
    with progress.trace(str(tmp_path)) as run:
        tg.run_ensemble(tg.base_system(), _co(), _ensemble(1),
                        extract=_final_C, **dict(RUN, tf=1 / 512))
    with open(run.path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert set(SPANS) <= names
    assert {s.name for s in run.recorder.read().spans} == set(SPANS)


def test_self_time_leaves_out_the_syncs():
    S = progress.Span
    rec = progress.Recording(spans=[
        S(0, "iteration", 0, 100, None, None, 0),
        S(1, "step", 10, 90, 0, None, 0),
        S(2, "rhs", 20, 30, 1, None, 0),
        S(3, "dense_output", 40, 80, 1, None, 0),
        S(4, "sync", 50, 70, 3, None, 0),
        S(5, "iteration", 100, 150, None, None, 1),
        S(6, "step", 105, 145, 5, None, 1),
    ], counters={})
    assert rec.self_ns("step") == 80 - 20 + 40
    assert rec.self_ns("step", skip=lambda i: i == 1) == 60
    assert rec.self_ns("sync") == 20
    assert rec.self_ns("dense_output", less=()) == 40


def test_mesh_threads_record_under_the_request():
    """Two worker threads of a host mesh: each records its group in its
    own list, under the caller's request span."""
    from gab1_shp2_tpu_torch.parallel.mesh import ensemble_mesh
    with progress.record() as rec:
        tg.run_ensemble(tg.base_system(), _co(), _ensemble(4),
                        extract=_final_C, device_axis="ensemble",
                        mesh=ensemble_mesh(["cpu", "cpu"]),
                        **RUN)
    r = rec.read()
    (req,) = [s for s in r.spans if s.name == "request"]
    groups = [s for s in r.spans if s.name == "group"]
    assert len(groups) == 2 and {g.parent for g in groups} == {req.id}
    assert {s.request for s in r.spans} == {req.id}
    assert r.counters["members"] == 4
    # each slot's two members on two lanes
    assert r.counters["lane_slots"] == 2 * r.counters["iterations"]
    assert r.counters["iterations"] == sum(
        1 for s in r.spans if s.name == "iteration")


def test_threads_lose_no_span_or_count():
    """More recording threads than cores, switching every microsecond:
    every span and every count lands, with an id of its own, nested in
    its own thread's outer span."""
    import sys
    import threading

    n_threads, n_spans = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with progress.record() as rec:
            def work():
                with rec.span("group"):
                    for _ in range(n_spans):
                        with rec.span("step"):
                            rec.count(steps=1)

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    r = rec.read()
    assert r.counters["steps"] == n_threads * n_spans
    assert len({s.id for s in r.spans}) == len(r.spans) == \
        n_threads * (n_spans + 1)
    groups = {s.id for s in r.spans if s.name == "group"}
    per_group = Counter(s.parent for s in r.spans if s.name == "step")
    assert set(per_group) == groups
    assert set(per_group.values()) == {n_spans}


def test_profiler_may_start_and_stop_inside_a_span():
    """The benchmark's sub-window profile starts inside one loop
    iteration's step and stops inside a later one."""
    from torch.profiler import ProfilerActivity, profile
    with progress.record() as rec:
        with rec.span("iteration"):
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.start()
            with rec.span("step"):
                torch.ones(4).sum()
        with rec.span("iteration"):
            prof.stop()
    assert [s.name for s in rec.read().spans] == [
        "iteration", "step", "iteration"]
