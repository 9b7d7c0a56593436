"""The helpers the port's workload drivers share, against the JAX
package's on the CPU: the parameter-name helpers and the ensemble CSV
reader of ``models/params.py``, ``priors/posteriors.py``,
``utils/cache.py``, ``utils/stats.py`` and ``workloads/common``'s
ensemble acquisition.

Tolerances.  Names, draws and the ensemble are equal bit for bit (the
same numpy calls on the same generator and the same chain values).  The
port's CSV readers return the written float64 values exactly (Python's
``float`` rounds correctly); pandas' default C parser, which the JAX
package's readers use, can be a few hundred ulps off (3.9e-13 relative
seen here), so the two readers agree within 1e-12.  The statistics
agree within 1e-12 (the same scipy quadrature).  ``progress`` prints the
JAX package's line up to the rates and times it measures.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import gab1_shp2_tpu.models.params as jparams
import gab1_shp2_tpu.priors.posteriors as jpost
from gab1_shp2_tpu.utils import progress as jprogress
from gab1_shp2_tpu.utils import stats as jstats
from gab1_shp2_tpu.workloads import common as jcommon

import gab1_shp2_tpu_torch.models.params as tparams
import gab1_shp2_tpu_torch.priors.posteriors as tpost
from gab1_shp2_tpu_torch.utils import stats as tstats
from gab1_shp2_tpu_torch.utils import progress as tprogress
from gab1_shp2_tpu_torch.utils.cache import Checkpointer, compute_or_load
from gab1_shp2_tpu_torch.workloads import common as tcommon


def test_names_match_jax():
    assert tparams.param_names() == jparams.param_names()
    assert tparams.co_names() == jparams.co_names()
    assert tparams.FITTED_PARAM_NAMES == jparams.FITTED_PARAM_NAMES
    assert tpost.FITTED == jpost.FITTED


def _write_csv(path, header, rows):
    with open(path, "w") as fh:
        fh.write(",".join(header) + "\n")
        for r in rows:
            fh.write(",".join(repr(float(x)) for x in r) + "\n")


def test_load_ensemble_csv_columns_by_header(tmp_path):
    """Columns in another order, plus one extra, load in reference order
    as the JAX package's pandas reader loads them."""
    rng = np.random.default_rng(3)
    names = list(tparams.param_names()) + ["extra"]
    order = rng.permutation(len(names))
    vals = np.exp(rng.normal(0.0, 3.0, size=(7, len(names))))
    path = tmp_path / "ens.csv"
    _write_csv(path, [names[i] for i in order], vals[:, order])
    got = tparams.load_ensemble_csv(str(path))
    want = jparams.load_ensemble_csv(str(path))
    assert got.shape == (7, 24) and got.dtype == np.float64
    np.testing.assert_array_equal(got, vals[:, :24])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def chain_csv(tmp_path_factory):
    """A synthetic chain in the reference's posterior CSV layout: the
    fitted columns among the sampler's own."""
    rng = np.random.default_rng(11)
    header = ["iteration", "chain", "kSi", "lp", "kG1p", "kSa", "kG1dp"]
    vals = rng.lognormal(0.0, 1.0, size=(40, len(header)))
    path = tmp_path_factory.mktemp("chain") / "posteriors.csv"
    _write_csv(path, header, vals)
    return str(path)


def test_load_chain_csv_and_best_fit_values(chain_csv):
    got = tpost.load_chain_csv(chain_csv)
    want = jpost.load_chain_csv(chain_csv)
    assert got.dtype.names == tpost.FITTED and len(got) == len(want)
    for c in tpost.FITTED:
        np.testing.assert_allclose(got[c], want[c].to_numpy(), rtol=1e-12,
                                   atol=0)
    bt, bj = tpost.best_fit_values(got), jpost.best_fit_values(want)
    assert list(bt) == list(tpost.FITTED)
    for c in tpost.FITTED:
        assert bt[c] == pytest.approx(bj[c], rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_chain", [False, True], ids=["prior", "chain"])
def test_generate_ensemble_bit_equal(seed, with_chain, chain_csv):
    import pandas as pd

    tchain = tpost.load_chain_csv(chain_csv) if with_chain else None
    # the JAX package's DataFrame holding the same values
    jchain = (pd.DataFrame({c: tchain[c] for c in tpost.FITTED})
              if with_chain else None)
    got = tpost.generate_ensemble(tchain, n=25,
                                  rng=np.random.default_rng(seed))
    want = jpost.generate_ensemble(jchain, n=25,
                                   rng=np.random.default_rng(seed))
    assert got.shape == (25, 24) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_get_ensemble_matches_jax():
    """The drivers' ensemble: the reference's files are absent here, so
    both packages draw from the priors through generate_ensemble(None)."""
    for n, seed in ((4, 0), (9, 5)):
        np.testing.assert_array_equal(tcommon.get_ensemble(n, seed=seed),
                                      jcommon.get_ensemble(n, seed=seed))


def test_compute_or_load_roundtrip(tmp_path):
    calls = []

    def compute():
        calls.append(1)
        return {"x": np.arange(5.0), "y": np.ones((2, 2))}

    cfg = {"dr": 0.2, "n": 10}
    a = compute_or_load("t", cfg, compute, cache_dir=str(tmp_path))
    b = compute_or_load("t", cfg, compute, cache_dir=str(tmp_path))
    assert len(calls) == 1  # second call loaded
    np.testing.assert_array_equal(a["x"], b["x"])
    # different config recomputes
    compute_or_load("t", {"dr": 0.1, "n": 10}, compute,
                    cache_dir=str(tmp_path))
    assert len(calls) == 2
    # force recomputes
    compute_or_load("t", cfg, compute, cache_dir=str(tmp_path), force=True)
    assert len(calls) == 3
    # the JAX package's cache reads the same file
    from gab1_shp2_tpu.utils.cache import compute_or_load as j_col

    c = j_col("t", cfg, lambda: pytest.fail("recomputed"),
              cache_dir=str(tmp_path))
    np.testing.assert_array_equal(c["y"], a["y"])


def test_checkpointer(tmp_path):
    ck = Checkpointer("test", {"a": 1}, cache_dir=str(tmp_path), every=0.0)
    assert ck.restore() is None
    ck.save({"i": np.int64(7), "state": np.zeros(3)})
    got = ck.restore()
    assert int(got["i"]) == 7
    assert ck.maybe_save({"i": np.int64(8)})
    assert int(ck.restore()["i"]) == 8
    ck.clear()
    assert ck.restore() is None


def test_stats_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(0.0, 1.0, 200)
    far = rng.normal(2.0, 1.0, 200)
    near = rng.normal(0.0, 1.0, 200)
    for x, y in ((a, far), (a, near), (a, a + 1.0)):
        for fn in ("jzs_ttest_bf10", "hedges_g"):
            got = getattr(tstats, fn)(x, y)
            want = getattr(jstats, fn)(x, y)
            assert got == pytest.approx(want, rel=1e-12, abs=1e-12), fn
    # the JAX test's criteria
    assert tstats.jzs_ttest_bf10(a, far) > 1e6
    assert tstats.jzs_ttest_bf10(a, near) < 1.0
    assert abs(tstats.hedges_g(a, a + 1.0) + 1.0) < 0.05


def _without_numbers(text):
    return re.sub(r"\d+\.\d+", "R", re.sub(r"eta \d+s", "eta Ts", text))


@pytest.mark.parametrize("total", [None, 5])
def test_progress_prints_the_jax_line(capsys, total):
    items = iter(range(5)) if total is None else list(range(5))
    got = list(tprogress.progress(items, desc="solve", every=0.0))
    t_err = capsys.readouterr().err
    items = iter(range(5)) if total is None else list(range(5))
    want = list(jprogress.progress(items, desc="solve", every=0.0))
    j_err = capsys.readouterr().err
    assert got == want == list(range(5))
    assert "solve 5" in t_err and t_err.endswith("\n")
    assert _without_numbers(t_err) == _without_numbers(j_err)


def test_timer_prints_the_block_time(capsys):
    with tprogress.timer("solve"):
        torch.ones(8).sum()
    err = capsys.readouterr().err
    assert re.fullmatch(r"\[solve\] \d+\.\d{3}s\n", err), err


def test_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the block's CPU operations (the card
    test holds CUDA kernel events too)."""
    with tprogress.trace(str(tmp_path / "tr")) as run:
        (torch.ones(64) * 2.0).sum()
    assert isinstance(run.profile, torch.profiler.profile)
    assert os.path.dirname(run.path) == str(tmp_path / "tr")
    with open(run.path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)
