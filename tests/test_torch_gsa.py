"""The port's GSA layer (gab1_shp2_tpu_torch.gsa) against the JAX package.

Tolerances.  ``gsa/efast.py`` and ``gsa/sobol.py`` are numpy modules
copied from the JAX package: designs and indices must be *identical*.
The evaluators run f64 stiff solves that take the JAX package's steps
exactly, so the 6 outputs per sample agree within 1e-9 relative
(measured ~1e-15), with the same failed (zero) rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.gsa import efast as j_efast
from gab1_shp2_tpu.gsa import runner as j_runner
from gab1_shp2_tpu.gsa import sobol as j_sobol

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.gsa import efast as t_efast
from gab1_shp2_tpu_torch.gsa import runner as t_runner
from gab1_shp2_tpu_torch.gsa import sobol as t_sobol

torch.set_num_threads(2)

SOLVE = dict(dr=1.0, tf=0.5, chunk=4)


def _ishigami(X):
    return (np.sin(X[:, 0]) + 7.0 * np.sin(X[:, 1]) ** 2
            + 0.1 * X[:, 2] ** 4 * np.sin(X[:, 0]))


@pytest.mark.parametrize("resamples,log_space", [(1, True), (2, False)])
def test_efast_copy_is_identical(resamples, log_space):
    bounds = np.array([[0.1, 10.0], [1.0, 3.0], [2.0, 50.0]])
    kw = dict(num_harmonics=4, resamples=resamples, log_space=log_space)
    dj = j_efast.efast_design(bounds, 65, rng=np.random.default_rng(5), **kw)
    dt = t_efast.efast_design(bounds, 65, rng=np.random.default_rng(5), **kw)
    np.testing.assert_array_equal(dt.X, dj.X)
    assert tuple(dt[1:]) == tuple(dj[1:])
    Y = np.stack([_ishigami(dj.X), dj.X.sum(axis=1)], axis=1)
    for a, b in zip(t_efast.efast_indices(Y, dt), j_efast.efast_indices(Y, dj)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_efast.log_bounds_around([1.0, 4.0], 10.0),
                                  j_efast.log_bounds_around([1.0, 4.0], 10.0))
    with pytest.raises(ValueError, match="samples too small"):
        t_efast.efast_design(bounds, 9)


def test_sobol_copy_is_identical():
    bounds = np.array([[0.1, 10.0], [1.0, 3.0], [2.0, 50.0]])
    dj = j_sobol.sobol_design(bounds, 64, seed=3)
    dt = t_sobol.sobol_design(bounds, 64, seed=3)
    np.testing.assert_array_equal(dt.X, dj.X)
    assert (dt.n, dt.d) == (dj.n, dj.d)
    Y = _ishigami(np.log(dj.X))
    for a, b in zip(t_sobol.sobol_indices(Y, dt), j_sobol.sobol_indices(Y, dj)):
        np.testing.assert_array_equal(a, b)


def _samples(kind):
    rng = np.random.default_rng(11)
    if kind == "param":
        base = np.asarray(jg.default_params().pack())
    else:
        base = np.asarray(jg.default_co())
    return base[None] * np.exp(rng.normal(0.0, 0.5, (8, base.size)))


@pytest.mark.parametrize("scheduler", ["refill", "sorted"])
@pytest.mark.parametrize("kind", ["param", "conc"])
def test_evaluators_match_jax(kind, scheduler):
    X = _samples(kind)
    if kind == "param":
        ej = j_runner.make_param_evaluator(jg.base_system(), jg.default_co(),
                                           scheduler=scheduler, **SOLVE)
        et = t_runner.make_param_evaluator(
            tg.base_system(), tg.default_co(device="cpu"), device="cpu",
            scheduler=scheduler, **SOLVE)
    else:
        ej = j_runner.make_conc_evaluator(jg.base_system(),
                                          jg.default_params(),
                                          scheduler=scheduler, **SOLVE)
        et = t_runner.make_conc_evaluator(
            tg.base_system(), tg.default_params(device="cpu"), device="cpu",
            scheduler=scheduler, **SOLVE)
    want, got = ej(X), et(X)
    assert isinstance(got, np.ndarray) and got.shape == (8, 6)
    assert (np.abs(got).sum(axis=1) > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_capped_members_report_zeros_and_dtype_override():
    """``max_steps`` too small: every lane is cut off and reports zeros
    (the reference's on_error=zeros); ``dtype`` selects f32 solves."""
    X = _samples("param")[:3]
    et = t_runner.make_param_evaluator(
        tg.base_system(), tg.default_co(device="cpu"), device="cpu",
        max_steps=3, **SOLVE)
    np.testing.assert_array_equal(et(X), np.zeros((3, 6)))
    e32 = t_runner.make_param_evaluator(
        tg.base_system(), tg.default_co(device="cpu"), device="cpu",
        dtype=torch.float32, scheduler="sorted", **SOLVE)
    e64 = t_runner.make_param_evaluator(
        tg.base_system(), tg.default_co(device="cpu"), device="cpu",
        scheduler="sorted", **SOLVE)
    y32, y64 = e32(X), e64(X)
    assert y32.dtype == np.float32 and y64.dtype == np.float64
    # the average output (column 5) is smooth in the state: f32 vs f64
    np.testing.assert_allclose(y32[:, 5], y64[:, 5], rtol=2e-3)
    with pytest.raises(ValueError, match="unknown scheduler"):
        t_runner.make_conc_evaluator(
            tg.base_system(), tg.default_params(device="cpu"), device="cpu",
            scheduler="fifo")


def test_chunked_batch_unsorts():
    """Rows come back in the caller's order although chunks are solved
    in cost order, and the last chunk may be short."""
    seen = []

    def batch_fn(X):
        seen.append(X.shape[0])
        return X[:, :6] * 2.0

    rng = np.random.default_rng(2)
    X = rng.uniform(0.1, 5.0, (11, 24))
    out = t_runner._chunked_batch(batch_fn, 4, torch.device("cpu"),
                                  torch.float64)(X)
    np.testing.assert_array_equal(out, X[:, :6] * 2.0)
    assert seen == [4, 4, 3]
    seen.clear()
    out = t_runner._refill_batch(batch_fn, torch.device("cpu"),
                                 torch.float64, group=5)(X)
    np.testing.assert_array_equal(out, X[:, :6] * 2.0)
    assert seen == [5, 5, 1]


def test_run_efast_and_sobol_on_ishigami(capsys):
    bounds = np.array([[-np.pi, np.pi]] * 3)
    args = dict(log_space=False, seed=1)
    # 32 pooled resample curves, as the JAX package's own Ishigami test
    efast_kw = dict(samples=2049, resamples=32, **args)
    S1, ST, design = t_runner.run_efast(_ishigami, bounds, **efast_kw)
    S1j, STj, _ = j_runner.run_efast(_ishigami, bounds, **efast_kw)
    np.testing.assert_array_equal(S1, S1j)
    np.testing.assert_array_equal(ST, STj)
    # analytic first-order indices of the Ishigami function
    np.testing.assert_allclose(S1[:, 0], [0.3139, 0.4424, 0.0], atol=0.03)
    assert design.X.shape == (3 * 32 * 2049, 3)
    S1s, STs, _ = t_runner.run_sobol(_ishigami, bounds, n=4096, **args)
    np.testing.assert_allclose(S1s[:, 0], [0.3139, 0.4424, 0.0], atol=0.02)
    assert capsys.readouterr().out == ""       # nothing was dropped

    def half_failed(X):
        Y = np.stack([_ishigami(X)] * 2, axis=1)
        Y[::2] = 0.0
        return Y

    t_runner.run_sobol(half_failed, bounds, n=64, **args)
    assert "50.0% of model evaluations failed" in capsys.readouterr().out


def test_bounds_match_jax():
    np.testing.assert_array_equal(
        t_runner.dk_bounds(tg.default_params(device="cpu")),
        np.asarray(j_runner.dk_bounds(jg.default_params())))
    np.testing.assert_array_equal(
        t_runner.conc_bounds(tg.default_co(device="cpu")),
        j_runner.conc_bounds(jnp.asarray(jg.default_co())))
    np.testing.assert_array_equal(
        t_runner.conc_bounds([1.0, 2.0]), [[2e-4, 2.0], [4e-4, 4.0]])
    assert t_runner.GSA_VAR_NAMES == j_runner.GSA_VAR_NAMES
