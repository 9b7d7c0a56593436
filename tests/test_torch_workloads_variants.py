"""The port's ``calc_rxn_rates`` and ``run_variants`` drivers against
the JAX package's on the CPU.

Each port driver runs through ``main([..., "--cpu", "--outdir", tmp])``
at a tiny configuration with ``--linsolve none``, so both packages run
f64 throughout and take the same steps.  ``calc_rxn_rates`` (4 members,
dr=0.5, tf=0.5, 4 save intervals, rtol 1e-3) is compared with the JAX
driver's own CSV.  For ``run_variants --variant hela`` at that
configuration the JAX side computes its CSVs' numbers with the calls its
driver makes (``run_ensemble`` with the same settings,
``masked_quantiles``, the statistics), from one ensemble pass over both
abundance sets with a per-member ``Co``: the driver's own run compiles
four programs, about 40 s on this CPU.  The ``memb_sfk`` and
``hi_egfr_hela`` variants (2 members, dr=1, tf=0.3) are compared with
the JAX driver's own CSVs, its ensemble calls handed one extract
function per source line (``workload_csvs.once_per_extract``), under
the cost-sorted scheduler in both packages: its JAX programs compile in
about half the lane-refill scheduler's time, the drivers hand
``--scheduler`` to every ensemble call, and the refill path is held
against JAX's in ``test_torch_refill.py``.

Tolerances: relative 1e-8 (the f64 bound of ROADMAP's rules).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.ensemble.engine import masked_quantiles as j_quantiles
from gab1_shp2_tpu.ensemble.engine import run_ensemble as j_run
from gab1_shp2_tpu.utils.stats import hedges_g, jzs_ttest_bf10
from gab1_shp2_tpu.workloads import calc_rxn_rates as j_rates
from gab1_shp2_tpu.workloads import common as jcommon
from gab1_shp2_tpu.workloads import run_variants as j_run_variants

from gab1_shp2_tpu_torch.workloads import calc_rxn_rates, run_variants
from tests.workload_csvs import (
    assert_csv_close,
    assert_same_csvs,
    once_per_extract,
    rows,
)

torch.set_num_threads(2)

TINY = ["--n", "4", "--dr", "0.5", "--tf", "0.5", "--nts", "4",
        "--rtol", "1e-3", "--linsolve", "none"]
RTOL = 1e-8


def test_calc_rxn_rates_matches_jax(tmp_path):
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    calc_rxn_rates.main(TINY + ["--cpu", "--outdir", t_out])
    j_rates.main(TINY + ["--outdir", j_out])
    want = rows(f"{j_out}/rxn_rate_quantiles.csv")
    assert [r[0] for r in want[1:]] == ["v_sfk_a", "v_sfk_i", "v_sfk_net",
                                        "v_g1_p", "v_pg1_dp", "v_pg1_net"]
    assert_csv_close(f"{t_out}/rxn_rate_quantiles.csv", want, RTOL)


def test_run_variants_hela_matches_jax(tmp_path):
    out = str(tmp_path)
    run_variants.main(["--variant", "hela"] + TINY + ["--cpu",
                                                      "--outdir", out])
    ens = jcommon.get_ensemble(4, seed=0)
    kw = dict(solver="stiff", dr=0.5, tf=0.5, Nts=4, rtol=1e-3,
              linsolve_dtype=None)
    r = np.arange(21) * 0.5
    # both abundance sets in one unchunked call with a per-member Co
    # (8, 5); per-member results do not depend on the scheduler (exact
    # step counts), and this one compiles fastest
    co = jnp.concatenate([jnp.broadcast_to(jg.default_co(), (4, 5)),
                          jnp.broadcast_to(jg.hela_co(), (4, 5))])
    prof, ok = j_run(jg.base_system(), co, jnp.asarray(np.tile(ens, (2, 1))),
                     extract=lambda s: s.PG1Stot[-1], scheduler="sorted",
                     **kw)
    assert bool(np.asarray(ok).all())
    qs, groups = {}, {}
    for i, name in enumerate(("base", "hela")):
        rows = slice(4 * i, 4 * i + 4)
        qs[name] = np.asarray(j_quantiles(prof[rows], ok[rows]))
        p = np.asarray(prof)[rows]
        groups[name] = p[:, 0] / p[:, -1]
    hdr = ["r"] + [f"{n}_{c}" for n in ("base", "hela")
                   for c in ("lo68", "median", "hi68")]
    cols = [r] + [qs[n][i] for n in ("base", "hela") for i in range(3)]
    assert_csv_close(f"{out}/hela_vs_base_PG1Stot.csv",
                     [hdr] + np.stack(cols, axis=1).tolist(), RTOL)
    bf = jzs_ttest_bf10(groups["base"], groups["hela"])
    gg = hedges_g(groups["base"], groups["hela"])
    assert_csv_close(f"{out}/hela_cs_ratio_bf.csv",
                     [["bf10", "hedges_g"], [bf, gg]], RTOL)


@pytest.mark.parametrize("variant,csvs", [
    ("memb_sfk", ["membSFK_vs_base_PG1Stot"]),
    ("hi_egfr_hela", ["hi_egfr_hi_egfr_hela",
                      "hi_egfr_hi_egfr_hela_scatter"]),
])
def test_run_variants_others(tmp_path, monkeypatch, variant, csvs):
    """The port's CSVs against the JAX driver's at the same flags."""
    small = ["--variant", variant, "--n", "2", "--dr", "1.0", "--tf", "0.3",
             "--nts", "2", "--rtol", "1e-3", "--linsolve", "none",
             "--scheduler", "sorted"]
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    run_variants.main(small + ["--cpu", "--outdir", t_out])
    for mod in (jcommon, j_run_variants):
        monkeypatch.setattr(mod, "run_ensemble",
                            once_per_extract(mod.run_ensemble))
    j_run_variants.main(small + ["--outdir", j_out])
    assert_same_csvs(t_out, j_out, csvs, RTOL)
    for name in csvs:
        vals = np.asarray(rows(f"{t_out}/{name}.csv")[1:], float)
        assert np.isfinite(vals).all(), name
        if name.endswith("PG1Stot"):
            assert vals.shape == (11, 7)  # r + 2 x (lo, median, hi)
            assert (vals[:, 1:] > 0).all()
    if variant == "hi_egfr_hela":
        got = rows(f"{t_out}/hi_egfr_hi_egfr_hela.csv")
        assert [float(r[0]) for r in got[1:]] == [1.0, 10.0, 100.0,
                                                  1000.0, 10000.0]
