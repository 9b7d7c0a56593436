"""The port's ``run_base_model`` driver against the JAX package's on
the CPU, and the drivers' shared argument parser.

The driver runs through ``main([..., "--cpu", "--outdir", tmp])`` at the
JAX package's own test configuration (``tests/test_workloads.py``:
``--n 4 --dr 0.5 --nts 4 --rtol 1e-3``).  The JAX side computes the
numbers of its ``pct_shp2_bound_gab1.csv`` with the calls its driver
makes (the same ensemble, ``run_ensemble``'s refill scheduler at the
same settings, ``masked_quantiles``), without the driver's surface
plots and baseline solve, which take most of its minute of compiling.

Tolerances.  ``--linsolve none`` (f64 throughout): relative 1e-8, and
the refill scheduler's step counts equal.  The default f32 linear
algebra: relative 2e-3 of the same JAX numbers, the bound the JAX
package sets for a different order of f32 operations
(``tests/test_utils_and_pallas.py:164-168``); the JAX driver's own f32
CSV lies within 1e-7 of its f64 one at this configuration (a scratch
run of both drivers), so its f64 row stands in for it and the file
compiles one JAX program, not two.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.ensemble.engine import masked_quantiles as j_quantiles
from gab1_shp2_tpu.models.observables import pct_shp2_bound_gab1 as j_pct
from gab1_shp2_tpu.ops.batch_stiff import solve_stiff_refill as j_refill
from gab1_shp2_tpu.workloads import common as jcommon

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.observables import pct_shp2_bound_gab1
from gab1_shp2_tpu_torch.workloads import common as tcommon
from gab1_shp2_tpu_torch.workloads import run_base_model

torch.set_num_threads(2)

TINY = ["--n", "4", "--dr", "0.5", "--nts", "4", "--rtol", "1e-3"]
# run_ensemble's solver settings at the driver's flags
CFG = dict(dr=0.5, tf=5.0, Nts=4, rtol=1e-3, atol=1e-7, method="rodas4")
PCT_COLS = ("q2.5", "median", "q97.5", "q5.5", "q94.5")


def _read_row(path):
    with open(path) as fh:
        return {k: float(v) for k, v in next(csv.DictReader(fh)).items()}


@pytest.fixture(scope="module")
def jax_row():
    """The JAX driver's pct_shp2_bound_gab1.csv row at --linsolve none,
    and the refill scheduler's step counts per member."""
    ens = jcommon.get_ensemble(4, seed=0)
    Co = jg.default_co()
    pct, ok, steps = j_refill(
        jg.base_system(), Co, jg.Params.unpack(jnp.asarray(ens)),
        extract=lambda s: j_pct(s, Co, 10.0), lanes=4, linsolve_dtype=None,
        **CFG)
    q = np.asarray(j_quantiles(pct, ok, qs=(0.025, 0.5, 0.975)))
    q89 = np.asarray(j_quantiles(pct, ok, qs=(0.055, 0.945)))
    assert bool(np.asarray(ok).all())
    return dict(zip(PCT_COLS, (*q, *q89))), np.asarray(steps)


@pytest.mark.parametrize("linsolve,rtol", [("none", 1e-8), ("f32", 2e-3)])
def test_run_base_model_matches_jax(tmp_path, jax_row, linsolve, rtol):
    out = str(tmp_path)
    run_base_model.main(TINY + ["--linsolve", linsolve, "--cpu",
                                "--outdir", out])
    for png in ("base_aSFK_surface", "ens_PG1Stot_median",
                "ens_PG1Stot_tf_profile", "pct_bound_model_vs_expt"):
        assert os.path.exists(f"{out}/{png}.png"), png
    got = _read_row(f"{out}/pct_shp2_bound_gab1.csv")
    assert 0 < got["median"] < 100
    assert (got["exptl_mu"], got["exptl_sigma"]) == (26.426,
                                                    9.363293460636593)
    want, j_steps = jax_row
    for k in PCT_COLS:
        assert got[k] == pytest.approx(want[k], rel=rtol), k
    if linsolve == "none":
        Co = tg.default_co(device="cpu")
        ens = tcommon.get_ensemble(4, seed=0)
        _, ok, t_steps = tg.solve_stiff_refill(
            tg.base_system(), Co, tg.Params.unpack(torch.as_tensor(ens)),
            extract=lambda s: pct_shp2_bound_gab1(s, Co, 10.0),
            device="cpu", lanes=4, **CFG)
        assert bool(ok.all())
        np.testing.assert_array_equal(t_steps.cpu().numpy(), j_steps)


def test_argparser_flags_and_device():
    """Every flag and default of the JAX package's parser; --linsolve,
    --scheduler and --cpu map to what the entry points take."""
    ap = tcommon.default_argparser("t")
    assert vars(ap.parse_args([])) == vars(
        jcommon.default_argparser("t").parse_args([]))
    for flag, want in (("none", None), ("f32", torch.float32),
                       ("bf16", torch.bfloat16)):
        args = ap.parse_args(["--linsolve", flag])
        assert tcommon.linsolve_dtype(args) is want
    assert ap.parse_args([]).linsolve == "f32"
    assert tcommon.device(ap.parse_args(["--cpu"])) == torch.device("cpu")
    assert tcommon.scheduler(ap.parse_args([])) is None
    assert tcommon.scheduler(ap.parse_args(["--scheduler", "sorted"])) \
        == "sorted"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcommon.device(ap.parse_args([]))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_base_model.main(TINY + ["--outdir", "unused"])
