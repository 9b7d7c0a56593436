"""The port's pulse-chase, GSA and remaining ``run_variants`` drivers
against the JAX package's drivers on the CPU.

Each port driver runs through ``main([..., "--cpu", "--outdir", tmp])``
and the JAX driver through ``main`` at the same flags, at a tiny
configuration in float64 throughout (``--linsolve none``; for the GSA
driver ``--full-f64-linsolve``), so both take the same steps; their CSVs
are compared cell by cell within relative 1e-8 (the f64 bound of
ROADMAP's rules).  The JAX drivers' ensemble calls are handed one
extract function per source line (``workload_csvs.once_per_extract``),
so each program compiles once.

* ``pulse_chase``: the reference's trace file is absent here, so the JAX
  driver is handed the port's ``reference_trace`` (the committed copy)
  and writes its ``pulse_chase_vs_ode.csv`` too.
* ``gsa_driver``: eFAST over the initial concentrations at 65 samples,
  the least eFAST takes with 4 harmonics: the design's seed and
  harmonics, the evaluator and the indices.
* ``run_variants --variant rect``, and ``--variant hi_egfr`` with member
  0's output set to NaN in both packages' ensemble calls, so the
  driver's masking of non-finite ratios decides the quantiles and the
  scatter rows; both under the cost-sorted scheduler, whose JAX programs
  compile in about half the lane-refill scheduler's time (the refill
  path is held against JAX's in ``test_torch_refill.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gab1_shp2_tpu.workloads import common as jcommon
from gab1_shp2_tpu.workloads import gsa_driver as j_gsa_driver
from gab1_shp2_tpu.workloads import pulse_chase as j_pulse_chase
from gab1_shp2_tpu.workloads import run_variants as j_run_variants

from gab1_shp2_tpu_torch.workloads import gsa_driver, pulse_chase, run_variants
from tests.workload_csvs import assert_same_csvs, once_per_extract, rows

torch.set_num_threads(2)

RTOL = 1e-8


def _run_both(tmp_path, monkeypatch, port, jax_mod, argv):
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    port.main(argv + ["--cpu", "--outdir", t_out])
    for mod in (jcommon, jax_mod):
        if hasattr(mod, "run_ensemble"):
            monkeypatch.setattr(mod, "run_ensemble",
                                once_per_extract(mod.run_ensemble))
    jax_mod.main(argv + ["--outdir", j_out])
    return t_out, j_out


def test_pulse_chase_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(j_pulse_chase, "reference_trace",
                        pulse_chase.reference_trace)
    t_out, j_out = _run_both(
        tmp_path, monkeypatch, pulse_chase, j_pulse_chase,
        ["--n", "2", "--dr", "1.0", "--nts", "20", "--rtol", "1e-3",
         "--linsolve", "none"])
    names = ("pulse_chase_PG1S_chase_surface", "pulse_chase_vs_ode")
    assert_same_csvs(t_out, j_out, names, RTOL)
    surf = np.asarray(rows(f"{t_out}/{names[0]}.csv")[1:], float)
    # the chase window t >= 5 of the 20-interval grid over tf=7, 11 nodes
    assert surf.shape == (int(np.sum(np.linspace(0, 7, 21) >= 5 - 1e-9)),
                          1 + 11)
    assert np.isfinite(surf).all()


def test_gsa_driver_matches_jax(tmp_path, monkeypatch):
    t_out, j_out = _run_both(
        tmp_path, monkeypatch, gsa_driver, j_gsa_driver,
        ["--target", "concs", "--samples", "65", "--dr", "1.0", "--tf", "0.3",
         "--rtol", "1e-3", "--full-f64-linsolve"])
    names = [f"eFAST_concs_65spls_{lab}" for lab in ("S1", "ST")]
    assert_same_csvs(t_out, j_out, names, RTOL)
    for name in names:
        M = np.asarray([r[1:] for r in rows(f"{t_out}/{name}.csv")[1:]],
                       float)
        assert M.shape == (5, 6) and np.isfinite(M).all()
        assert np.abs(M).max() > 1e-3  # not a sweep of failed solves


def _first_member_nan(run, set_nan):
    def wrapped(*args, **kw):
        out, ok = run(*args, **kw)
        return set_nan(out), ok
    return wrapped


def _t_nan(out):
    out = out.clone()
    out[0] = float("nan")
    return out


@pytest.mark.parametrize("variant,csvs", [
    ("rect", ["rect_vs_sphere_PG1Stot"]),
    ("hi_egfr", ["hi_egfr_hi_egfr", "hi_egfr_hi_egfr_scatter"]),
])
def test_run_variants_matches_jax(tmp_path, monkeypatch, variant, csvs):
    n = 2
    if variant == "hi_egfr":
        n = 3
        monkeypatch.setattr(run_variants, "run_ensemble", _first_member_nan(
            run_variants.run_ensemble, _t_nan))
        monkeypatch.setattr(j_run_variants, "run_ensemble", _first_member_nan(
            j_run_variants.run_ensemble, lambda o: o.at[0].set(jnp.nan)))
    t_out, j_out = _run_both(
        tmp_path, monkeypatch, run_variants, j_run_variants,
        ["--variant", variant, "--n", str(n), "--dr", "1.0", "--tf", "0.3",
         "--nts", "2", "--rtol", "1e-3", "--linsolve", "none",
         "--scheduler", "sorted"])
    assert_same_csvs(t_out, j_out, csvs, RTOL)
    for name in csvs:
        vals = np.asarray(rows(f"{t_out}/{name}.csv")[1:], float)
        assert np.isfinite(vals).all(), name
    if variant == "rect":
        assert vals.shape == (11, 7)  # r + 2 x (lo, median, hi)
    else:
        # member 0 is masked at every factor: 2 scatter rows a factor
        sc = np.asarray(rows(f"{t_out}/hi_egfr_hi_egfr_scatter.csv")[1:],
                        float)
        np.testing.assert_array_equal(
            sc[:, 0], np.repeat([1.0, 10.0, 100.0, 1000.0, 10000.0], 2))
