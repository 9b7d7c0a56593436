"""The port's ``fit_and_infer`` driver on the CPU.

The port's NUTS chains draw from per-chain ``torch.Generator``s, not
JAX's keys (ROADMAP, "Deliberate differences"), so the draws are not
compared with the JAX package's.  What is compared, or checked:

* the driver's flow and CSV schemas at ``--stage nuts --likelihood
  surrogate`` with the committed ``surrogate_n17.npz`` and
  ``fitted_parameters.csv`` copied into the output directory (2 chains x
  (20 warmup + 10 draws), dr=0.5), and its chain-health verdict against
  the JAX package's ``check_chains`` on the same draws;
* the importance reweighting and ESS at given draws against the JAX
  package's ``datum_loglik``, surrogate and ``importance_reweight``
  (relative 1e-10: the exact observable is the port's in both);
* ``--stage predictive`` from the committed ``posterior_samples.csv``:
  the resampled posterior and the prior draws equal the JAX package's
  (the same numpy calls), the CSV's schema and values.
"""

import argparse
import csv
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gab1_shp2_tpu.inference import diagnostics as j_diag
from gab1_shp2_tpu.inference import loss as j_loss
from gab1_shp2_tpu.inference import surrogate as j_sur
from gab1_shp2_tpu.priors.literature import build_priors as j_build_priors

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.inference import loss as t_loss
from gab1_shp2_tpu_torch.inference.surrogate import load_surrogate
from gab1_shp2_tpu_torch.workloads import fit_and_infer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = os.path.join(REPO, "results", "inference")
FIT = ("kG1p", "kG1dp", "kSa", "kSi")


def _rows(path):
    with open(path) as fh:
        return list(csv.reader(fh))


def _copy(out, *names):
    for n in names:
        shutil.copy(os.path.join(INF, n), out)


def test_nuts_surrogate_flow(tmp_path, capsys):
    out = str(tmp_path)
    _copy(out, "surrogate_n17.npz", "fitted_parameters.csv")
    argv = ["--stage", "nuts", "--likelihood", "surrogate", "--chains", "2",
            "--warmup", "20", "--samples", "10", "--dr", "0.5", "--cpu",
            "--outdir", out]
    try:
        fit_and_infer.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    log = capsys.readouterr()
    assert "loaded surrogate" in log.out
    assert "chains init at MAP from" in log.out
    diag = _rows(f"{out}/nuts_diagnostics.csv")
    assert diag[0] == ["param", "rhat", "ess"]
    assert [r[0] for r in diag[1:]] == list(FIT) + ["_divergence_rate",
                                                   "_ok"]
    ok = int(diag[-1][1])
    # the checkpoint of the finished run is cleared
    assert not [f for f in os.listdir(f"{out}/cache")
                if f.startswith("ckpt_")]
    if ok:
        assert code == 0
        samples = np.asarray(_rows(f"{out}/posterior_samples.csv")[1:],
                             float)
        assert samples.shape == (20, 5)
        assert _rows(f"{out}/posterior_quantiles.csv")[0] == [
            "param", "q0.025", "q0.25", "q0.5", "q0.75", "q0.975", "mean"]
        draws = np.log(samples[:, :4]).reshape(2, 10, 4)
    else:
        # the health gate quarantines the draws and exits 1
        assert code == 1
        assert "NUTS HEALTH CHECK FAILED" in log.out
        assert not os.path.exists(f"{out}/posterior_samples.csv")
        failed = _rows(f"{out}/posterior_samples_FAILED.csv")
        assert failed[0] == list(FIT)
        draws = np.log(np.asarray(failed[1:], float)).reshape(2, 10, 4)
    assert np.isfinite(draws).all()
    # the verdict and the diagnostics equal the JAX package's on the draws
    rep = j_diag.check_chains(draws, None, names=FIT)
    assert bool(rep["ok"]) == bool(ok) or float(diag[-2][1]) > 0.25
    for r in diag[1:5]:
        assert float(r[1]) == pytest.approx(rep["rhat"][r[0]], rel=1e-9)
        assert float(r[2]) == pytest.approx(rep["ess"][r[0]], rel=1e-9)


def test_generator_states_round_trip():
    gens = tuple(torch.Generator().manual_seed(s) for s in (3, 4))
    for g in gens:
        torch.rand(5, generator=g)
    saved = fit_and_infer._gen_states(gens)
    back = fit_and_infer._restore_gens(saved, 2)
    for a, b in zip(gens, back):
        assert torch.equal(torch.rand(7, generator=a),
                           torch.rand(7, generator=b))


def test_reweight_at_given_draws(tmp_path, monkeypatch):
    out = str(tmp_path)
    seen = []

    def recording(*a, **kw):
        # the driver's exact observable, its values kept for the check
        assert kw["rtol"] == 1e-6 and kw["method"] == "rodas4"
        fn = t_loss.make_batch_observable(*a, **kw)
        return lambda Q: seen.append(fn(Q)) or seen[-1]

    monkeypatch.setattr(fit_and_infer, "make_batch_observable", recording)
    rng = np.random.default_rng(5)
    center = np.log([42.0, 0.095, 16.2, 0.095])
    qs_all = (center + rng.normal(0.0, 0.3, size=(2, 3, 4)))
    args = argparse.Namespace(dr=0.5, chunk=256, seed=0)
    sur = load_surrogate(os.path.join(INF, "surrogate_n17.npz"),
                         device="cpu")
    Co = tg.default_co(device="cpu")
    fit_and_infer._reweight_and_save(args, Co, qs_all, sur, out, "",
                                     torch.device("cpu"))
    Q = qs_all.reshape(-1, 4)
    (y_exact,) = seen
    assert y_exact.shape == (6,) and np.isfinite(y_exact).all()
    j_s = j_sur.load_surrogate(os.path.join(INF, "surrogate_n17.npz"))
    y_sur = np.asarray(jax.vmap(j_s.y)(jnp.asarray(Q)))
    w, ess = j_sur.importance_reweight(
        np.asarray(j_loss.datum_loglik(jnp.asarray(y_exact))),
        np.asarray(j_loss.datum_loglik(jnp.asarray(y_sur))))
    got = np.asarray(_rows(f"{out}/posterior_samples.csv")[1:], float)
    np.testing.assert_allclose(got[:, :4], np.exp(Q), rtol=1e-15)
    np.testing.assert_allclose(got[:, 4], w, rtol=1e-10)
    e = _rows(f"{out}/posterior_ess.csv")
    assert e[0] == ["n_draws", "ess"] and int(e[1][0]) == 6
    assert float(e[1][1]) == pytest.approx(ess, rel=1e-10)
    q = _rows(f"{out}/posterior_quantiles.csv")
    wq = j_sur.weighted_quantiles(np.exp(Q[:, 0]), w, fit_and_infer.QS)
    np.testing.assert_allclose([float(x) for x in q[1][1:6]], wq,
                               rtol=1e-10)


def test_predictive_stage_from_committed_posterior(tmp_path):
    out = str(tmp_path)
    _copy(out, "posterior_samples.csv")
    fit_and_infer.main(["--stage", "predictive", "--predictive", "4",
                        "--dr", "0.5", "--cpu", "--outdir", out])
    rows = _rows(f"{out}/predictive_checks.csv")
    assert rows[0] == ["which", "q0.025", "q0.25", "q0.5", "q0.75",
                       "q0.975"]
    assert [r[0] for r in rows[1:]] == ["prior", "posterior"]
    vals = np.asarray([r[1:] for r in rows[1:]], float)
    assert np.isfinite(vals).all() and (vals > 0).all() \
        and (vals < 100).all()
    assert (np.diff(vals, axis=1) >= 0).all()

    # the draws: the JAX driver's resampling and predictive draws
    arr = np.loadtxt(f"{out}/posterior_samples.csv", delimiter=",",
                     skiprows=1)
    w = arr[:, 4] / arr[:, 4].sum()
    ridx = np.random.default_rng(77).choice(len(arr), size=len(arr),
                                            replace=True, p=w)
    samples = arr[ridx, :4]
    rng = np.random.default_rng(7)
    ln = j_build_priors().lognorm
    j_prior = np.stack([rng.lognormal(ln[n][0], ln[n][1], size=4)
                        for n in FIT], axis=-1)
    j_post = samples[rng.choice(len(samples), size=4, replace=False)]
    t_prior, t_post = fit_and_infer.predictive_draws(samples, 4, 0)
    np.testing.assert_array_equal(t_prior, j_prior)
    np.testing.assert_array_equal(t_post, j_post)
