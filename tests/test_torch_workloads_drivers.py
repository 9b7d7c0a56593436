"""The port's pulse-chase, length-scale, parameter-distribution and GSA
drivers, and ``run_base_model``'s perturbation studies, on the CPU.
The perturbation studies' CSVs are compared with the JAX package's
(relative 1e-8, f64 throughout); the pulse-chase and GSA drivers are
compared with the JAX package's in ``test_torch_workloads_parity.py``.

Each driver runs through ``main([..., "--cpu", "--outdir", tmp])``.  The
pulse chase is held to the JAX package's regression gate (RMSE < 20
percent points against the reaction-only ODE trace,
``tests/test_workloads.py``); the reference's trace file is absent here,
so the port reads its committed copy.  ``delta_estimates`` and the
parameter-ensemble CSV equal the JAX package's exactly (the same float64
operations, the same draws written as the same text).
"""

import csv
import os
import shutil

import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import default_params as j_default_params
from gab1_shp2_tpu.workloads import length_scales as j_length_scales
from gab1_shp2_tpu.workloads import plot_parameter_distributions as j_ppd
from gab1_shp2_tpu.workloads import run_base_model as j_run_base_model

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.workloads import (
    gsa_driver,
    length_scales,
    plot_parameter_distributions,
    pulse_chase,
    run_base_model,
)
from tests.workload_csvs import assert_same_csvs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(path):
    with open(path) as fh:
        return list(csv.reader(fh))


def test_perturbation_profiles(tmp_path):
    """The five profile-level perturbation studies
    (run_base_model.jl:465-818) at a tiny config, with the checks of the
    JAX package's test: the reference's condition sets, and every
    profile max-normalized (peak == 1) and in range, for both
    observables; and every CSV within relative 1e-8 of the JAX
    package's ``perturbation_profiles`` at the same settings (f64
    throughout, so both take the same steps)."""
    out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    kw = dict(solver="stiff", dr=0.5, tf=0.5, Nts=2, rtol=1e-3, chunk=8,
              linsolve_dtype=None)
    run_base_model.perturbation_profiles(
        tg.base_system(), tg.default_co(device="cpu"),
        tg.default_params(device="cpu"), out,
        dict(kw, device=torch.device("cpu")))
    j_run_base_model.perturbation_profiles(
        jg.base_system(), jg.default_co(), j_default_params(), j_out, kw)
    expected = {
        "Dsfk": {"1-fold", "0.01-fold"},
        "kS2r": {"1-fold", "0.01-fold", "100-fold"},
        "kSi-kG1dp_SHP2": {"base model", "100x kSi", "100x kG1dp",
                           "100x kSi; 10x [SHP2]",
                           "100x kG1dp; 10x [SHP2]"},
        "kS2r-kG1dp_Dsfk": {"base model", "0.01x kS2r", "0.01x kG1dp",
                            "0.01x Dsfk", "0.01x kS2r; 0.01x Dsfk",
                            "0.01x kG1dp; 0.01x Dsfk"},
        "EGFR": {"1x [EGFR]", "0.1x [EGFR]", "0.01x [EGFR]",
                 "0.001x [EGFR]"},
    }
    for name, conds in expected.items():
        path = f"{out}/perturbation_profiles_{name}.csv"
        assert os.path.exists(path), name
        with open(path) as fh:
            rows = list(csv.DictReader(fh))
        got = {}
        for row in rows:
            got.setdefault(row["condition"], []).append(
                (float(row["PG1S_norm"]), float(row["PG1_norm"])))
        assert set(got) == conds, name
        for cond, vals in got.items():
            a = np.asarray(vals)
            assert a.shape[0] == 21  # R/dr + 1 radial nodes
            assert np.all((a >= 0) & (a <= 1 + 1e-6)), (name, cond)
            # max-normalized: each profile peaks at exactly 1
            np.testing.assert_allclose(a.max(axis=0), 1.0, rtol=1e-6)
        assert os.path.exists(f"{out}/perturbation_PG1S_{name}.png")
        assert os.path.exists(f"{out}/perturbation_pGAB1_{name}.png")
    assert_same_csvs(out, j_out, [f"perturbation_profiles_{name}"
                                  for name in expected], rtol=1e-8)




def test_pulse_chase_reference_trace():
    """The committed copy of the reaction-only ODE trace passes the JAX
    package's checks of the reference file."""
    t, vals = pulse_chase.reference_trace()
    assert vals is not None
    assert len(vals) == 30
    assert vals[0] == pytest.approx(100.0)
    np.testing.assert_allclose(t, 4.97 + 0.07 * np.arange(30))
    # decays by >90% overall (the tail recovers very slightly)
    assert vals[-1] < 0.1 * vals[0]
    assert np.sum(np.diff(vals) < 0) > 20


def test_pulse_chase_rmse_regression_bound(tmp_path):
    """The JAX package's gate on its driver (RMSE 15.3 percent points at
    full scale): a small-N CPU run stays under 20, with no member lost."""
    out = str(tmp_path)
    pulse_chase.main(["--n", "8", "--dr", "0.4", "--nts", "60",
                      "--rtol", "1e-4", "--cpu", "--outdir", out])
    rows = np.genfromtxt(f"{out}/pulse_chase_vs_ode.csv", delimiter=",",
                         skip_header=1)
    assert rows.shape == (30, 3)
    rmse = float(np.sqrt(np.mean((rows[:, 1] - rows[:, 2]) ** 2)))
    assert rmse < 20.0, f"pulse-chase RMSE vs ODE trace drifted: {rmse}"
    surf = _rows(f"{out}/pulse_chase_PG1S_chase_surface.csv")
    assert surf[0][:3] == ["t_chase", "r0.0", "r0.4"]
    assert len(surf[0]) == 1 + 26  # R/dr + 1 nodes
    # the chase window of the 60-interval grid over tf=7: t >= 5
    assert len(surf) - 1 == int(np.sum(np.linspace(0, 7, 61) >= 5 - 1e-9))
    assert np.isfinite(np.asarray(surf[1:], float)).all()
    for png in ("pulse_chase_pE", "pulse_chase_PG1S_surf_rotated"):
        assert os.path.exists(f"{out}/{png}.png")


def test_length_scales(tmp_path):
    p = j_default_params()
    want = j_length_scales.delta_estimates(p)
    got = length_scales.delta_estimates(tg.default_params(device="cpu"))
    assert got == want
    assert got["aSFK"] == pytest.approx(4.24, abs=0.2)
    # the driver at a coarse grid: every row's delta columns are the
    # JAX package's estimates at that perturbation
    out = str(tmp_path)
    length_scales.main(["--dr", "5", "--tf", "0.5", "--rtol", "1e-3",
                        "--cpu", "--outdir", out])
    rows = _rows(f"{out}/length_scales_R100.csv")
    assert rows[0] == ["param", "factor", "r12_sfk", "r110_sfk",
                       "r12_pg1s", "r110_pg1s", "cs_ratio", "pg1s_ave",
                       "delta_sfk", "delta_pg1s"]
    assert len(rows) == 1 + 6 * 3
    for r in rows[1:]:
        d = j_length_scales.delta_estimates(p.scale(**{r[0]: float(r[1])}))
        assert (float(r[8]), float(r[9])) == (d["aSFK"], d["PG1S"])
        assert np.isfinite([float(x) for x in r[2:8]]).all()


def test_plot_parameter_distributions_matches_jax(tmp_path):
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    plot_parameter_distributions.main(["--n", "100", "--outdir", t_out])
    j_ppd.main(["--n", "100", "--outdir", j_out])
    got = _rows(f"{t_out}/parameter_ensemble.csv")
    assert got == _rows(f"{j_out}/parameter_ensemble.csv")
    ens = np.asarray(got[1:], float)
    assert ens.shape == (100, 24)
    assert (ens > 0).all()
    assert os.path.exists(f"{t_out}/parameter_distributions.png")


def test_gsa_driver_and_replot(tmp_path):
    """An eFAST sweep over the initial concentrations at the least sample
    count eFAST takes with 4 harmonics (65), on a coarse grid; then
    ``--replot`` on its CSVs and on a committed artifact's, copied."""
    out = tmp_path / "gsa"
    gsa_driver.main(["--target", "concs", "--samples", "65", "--dr", "1.0",
                     "--tf", "0.5", "--rtol", "1e-3", "--cpu",
                     "--outdir", str(out)])
    tag = "eFAST_concs_65spls"
    for label in ("S1", "ST"):
        rows = _rows(out / f"{tag}_{label}.csv")
        assert rows[0][0] == "param" and len(rows[0]) == 7
        assert [r[0] for r in rows[1:]] == list(tg.models.params.co_names())
        M = np.asarray([r[1:] for r in rows[1:]], float)
        assert np.isfinite(M).all() and (M > -0.05).all()
    assert (out / f"{tag}_heatmap.png").exists()
    (out / f"{tag}_heatmap.png").unlink()
    for label in ("S1", "ST"):
        shutil.copy(os.path.join(REPO, "results",
                                 f"eFAST_concs_1000spls_{label}.csv"), out)
    gsa_driver.main(["--replot", "--outdir", str(out)])
    assert (out / f"{tag}_heatmap.png").exists()
    assert (out / "eFAST_concs_1000spls_heatmap.png").exists()
    with pytest.raises(SystemExit):
        gsa_driver.main(["--replot", "--outdir", str(tmp_path / "none")])

