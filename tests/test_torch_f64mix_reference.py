"""The drivers' default precision (float64 state, float32 Jacobian bands,
factor and stage solves; RODAS4 at rtol 1e-4, atol 1e-7) through
``run_ensemble`` on the lane-refill scheduler, against the benchmark's
plain reference at a small size, and the save path's counters.

Four rows drawn by the benchmark's own generator from the upstream
parameter ensemble (``benchmark/data/parameter_ensemble.csv``, EGF
fixed), dr = 1, tf = 0.5, 10 saves, every save kept.  The reference is
``benchmark/reference/mol_spherical.py`` (SciPy's Radau IIA at rtol
1e-7, atol 1e-9, its states at the save times from its continuous
extension), loaded by path; errors are in the benchmark check's
tolerance units (``benchmark/harness/check.py`` ``member_errors``: the
largest |port - reference| / (atol + rtol * scale) over the saves after
t = 0, scale each species' largest magnitude over the trajectory).
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.ops import batch_stiff
from gab1_shp2_tpu_torch.ops.batch_stiff import _SolverCtx
from gab1_shp2_tpu_torch.utils import progress

torch.set_num_threads(2)

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "base_f64mix.json").read_text())
TRAFFIC = {"kind": "rows", "file": "data/parameter_ensemble.csv",
           "members": 4, "fixed": ["EGF"]}
SEED = 3016000002
DR, TF, NTS = 1.0, 0.5, 10
RUN = dict(solver="stiff", method=CONFIG["method"], rtol=CONFIG["rtol"],
           atol=CONFIG["atol"], max_steps=CONFIG["max_steps"], dr=DR,
           Nts=NTS, device="cpu")
# Sound runs read at most 0.90 tolerance units over 20 members (five
# draws of four rows from seeds 3016000001-005): the Hermite output
# between steps, not the float32 linear algebra (float64 throughout
# reads within 0.003 of it), sets the error; the reference's own error at
# the saves is at most 1.4e-4 units (against itself at rtol 1e-10, atol
# 1e-12, the same 20 members).  bfloat16 linear algebra reads above
# 2.3 on 19 of those 20 members (1.45 on one), median 4.7.
ERR_MAX = 1.5
# bfloat16 takes 300-600 steps a member over the first tf 0.1 (about
# 25 ms each on a CPU, where sound runs read at most 0.62), so its case
# solves that span for one row of the draw
BF16_TF = 0.1


def _load(kind, name):
    spec = importlib.util.spec_from_file_location(
        f"_t_{kind}_{name}", BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    """The benchmark's generator, check and reference (the check imports
    the benchmark's ``harness`` package from ``benchmark/``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(BENCH))
        check = _load("harness", "check")
    return dict(traffic=_load("harness", "traffic"), check=check,
                reference=_load("reference", CONFIG["reference"]))


def _trajectory(sol):
    return sol.C, sol.m


def _solve(rows, tf=TF, linsolve_dtype=torch.float32):
    (C, m), ok = tg.run_ensemble(
        tg.base_system(), tg.default_co(device="cpu"), rows, tf=tf,
        linsolve_dtype=linsolve_dtype, extract=_trajectory, **RUN)
    return C, m, ok


def _errors(bench, rows, C, m, tf=TF):
    co = tg.default_co(device="cpu").numpy()
    t_save = np.linspace(0.0, tf, NTS + 1)
    ref = [bench["reference"].solve_member(
        x, co, R=10.0, dr=DR, tf=tf, rtol=1e-7, atol=1e-9, t_save=t_save)
        for x in rows]
    return bench["check"].member_errors(
        C.numpy(), m.numpy(), np.stack([r[0] for r in ref]),
        np.stack([r[1] for r in ref]), CONFIG["rtol"], CONFIG["atol"])


@pytest.fixture(scope="module")
def runs(bench):
    """The rows solved twice, with the recorder on and off; in both, the
    save passes counted by hand (one snapshot a pass inside
    ``dense_output``) and the solver's host reads."""
    rows = bench["traffic"].Requests(TRAFFIC, CONFIG["params"], SEED).next()
    orig_dense = _SolverCtx.__dict__["dense_output"]
    orig_snap = _SolverCtx.__dict__["snapshot"]
    orig_read = batch_stiff.host_read
    out = {}
    for mode in ("on", "off"):
        tally = dict(passes=0, reads=0, inside=False)

        def dense_output(ctx, f, lp, st, *args):
            tally["inside"] = True
            try:
                return orig_dense(ctx, f, lp, st, *args)
            finally:
                tally["inside"] = False

        def snapshot(ctx, y, lp):
            tally["passes"] += tally["inside"]
            return orig_snap(ctx, y, lp)

        def host_read(*args, **kwargs):
            tally["reads"] += 1
            return orig_read(*args, **kwargs)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_SolverCtx, "dense_output", dense_output)
            mp.setattr(_SolverCtx, "snapshot", snapshot)
            mp.setattr(batch_stiff, "host_read", host_read)
            if mode == "on":
                with progress.record() as rec:
                    solved = _solve(rows)
                tally["counters"] = rec.read().counters
            else:
                solved = _solve(rows)
        out[mode] = dict(tally, solved=solved)
    out["rows"] = rows
    return out


def test_f64_state_f32_linear_algebra_within_the_bound(bench, runs):
    C, m, ok = runs["on"]["solved"]
    assert C.dtype == torch.float64 and C.shape == (4, NTS + 1, 10, 11)
    assert ok.all()
    err = _errors(bench, runs["rows"], C, m)
    assert err.max() <= ERR_MAX, err


def test_state_carries_float64_bits(runs):
    """The state is integrated in float64, not in float32 and widened on
    the way out: the saves after t = 0 hold values that float32 cannot
    (the tolerance check cannot tell: at rtol 1e-4 a float32 state reads
    within the Hermite output's own error)."""
    C, m, _ = runs["on"]["solved"]
    for x in (C[:, 1:], m[:, 1:]):
        assert not torch.equal(x, x.float().double())


def test_bfloat16_linear_algebra_fails_the_bound(bench, runs):
    rows = runs["rows"][1:2]
    C, m, ok = _solve(rows, tf=BF16_TF, linsolve_dtype=torch.bfloat16)
    assert ok.all()
    err = _errors(bench, rows, C, m, tf=BF16_TF)
    assert err.min() > ERR_MAX, err


def test_save_counters_equal_the_passes_counted_by_hand(runs):
    on = runs["on"]
    c = on["counters"]
    assert c["save_passes"] == on["passes"] >= NTS
    assert c["host_syncs"] == on["reads"]


def test_recorder_off_reads_and_returns_the_same(runs):
    on, off = runs["on"], runs["off"]
    for a, b in zip(on["solved"], off["solved"]):
        assert torch.equal(a, b)
    assert off["passes"] == on["passes"]
    assert off["reads"] == on["reads"]
