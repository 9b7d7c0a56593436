"""The port's Chebyshev surrogate, importance reweighting and the copied
jax-free modules (priors, diagnostics) against the JAX package.

Tolerances (float64): the same numpy batch function fed to both
build_surrogate's gives coefficients within 1e-12 of each other (relative
to the largest), and y(q) and its autograd gradient within 1e-12 of the
JAX package's value and jax.grad; ``.npz`` files written by either
package load in the other's load_surrogate to the same bits;
importance_reweight, weighted_quantiles, build_priors, split_rhat, ess
and check_chains give identical outputs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gab1_shp2_tpu.inference import diagnostics as jd
from gab1_shp2_tpu.inference import surrogate as js
from gab1_shp2_tpu.priors import diffusivity as jdiff
from gab1_shp2_tpu.priors import literature as jlit
from gab1_shp2_tpu.priors import protocol as jprot

from gab1_shp2_tpu_torch.inference import diagnostics as td
from gab1_shp2_tpu_torch.inference import loss as tl
from gab1_shp2_tpu_torch.inference import nuts as tn
from gab1_shp2_tpu_torch.inference import surrogate as ts
from gab1_shp2_tpu_torch.priors import diffusivity as tdiff
from gab1_shp2_tpu_torch.priors import literature as tlit
from gab1_shp2_tpu_torch.priors import protocol as tprot

torch.set_num_threads(2)

LO = np.array([-3.0, -1.0, -4.0, 0.0])
HI = np.array([2.0, 4.0, 1.0, 5.0])


def batch_fn(Q):
    """A smooth positive stand-in for the observable, with one failed
    (NaN) point to exercise the floor."""
    Q = np.asarray(Q, float)
    y = 30.0 * np.exp(0.3 * np.sin(Q[:, 0]) - 0.1 * Q[:, 1] ** 2 / 4.0
                      + 0.2 * Q[:, 2] * Q[:, 3] / 5.0) + 0.5 * Q[:, 3]
    y[np.isclose(Q[:, 0], LO[0]) & np.isclose(Q[:, 1], LO[1])
      & np.isclose(Q[:, 2], LO[2]) & np.isclose(Q[:, 3], LO[3])] = np.nan
    return y


@pytest.fixture(scope="module")
def surrogates():
    sj, vj = js.build_surrogate(batch_fn, LO, HI, n=6, chunk=50)
    st, vt = ts.build_surrogate(batch_fn, LO, HI, n=6, chunk=50,
                                device="cpu")
    return sj, vj, st, vt


def test_build_surrogate_coefficients(surrogates):
    sj, vj, st, vt = surrogates
    np.testing.assert_array_equal(vt, vj)
    assert np.isnan(vt).sum() == 1
    cj = np.asarray(sj.coef)
    assert st.coef.dtype == torch.float64 and st.coef.shape == (6,) * 4
    assert np.max(np.abs(st.coef.numpy() - cj)) / np.max(np.abs(cj)) < 1e-12
    np.testing.assert_array_equal(st.lo.numpy(), LO)
    np.testing.assert_array_equal(st.hi.numpy(), HI)
    np.testing.assert_allclose(ts.cheb_nodes(7), js.cheb_nodes(7),
                               rtol=0, atol=0)


def test_surrogate_value_and_gradient(surrogates):
    sj, _, st, _ = surrogates
    rng = np.random.default_rng(0)
    # inside the box, and two points clamped to it
    Q = LO + (HI - LO) * rng.uniform(size=(6, 4))
    Q = np.concatenate([Q, [LO - 1.0, HI + 0.5]])
    vj = np.array([float(sj.y(jnp.asarray(q))) for q in Q])
    gj = np.array([np.asarray(jax.grad(sj.y)(jnp.asarray(q))) for q in Q])
    q = torch.as_tensor(Q).requires_grad_(True)
    v = st.y(q)                      # batched over the leading axis
    (g,) = torch.autograd.grad(v.sum(), q)
    np.testing.assert_allclose(v.detach().numpy(), vj, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-12, atol=1e-12)
    # the surrogate interpolates at a grid node
    node = LO + (HI - LO) * (js.cheb_nodes(6)[[1, 2, 3, 4]] + 1.0) / 2.0
    want = batch_fn(node[None])[0]
    assert float(st.y(torch.as_tensor(node))) == pytest.approx(want,
                                                               rel=1e-10)


def test_npz_interchange(surrogates, tmp_path):
    sj, vj, st, vt = surrogates
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    js.save_surrogate(pj, sj, vj)
    ts.save_surrogate(pt, st, vt)
    from_jax = ts.load_surrogate(pj, device="cpu")
    from_port = js.load_surrogate(pt)
    for a, b in zip(from_jax, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(from_port, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with np.load(pt) as zt, np.load(pj) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].shape == zj[k].shape and zt[k].dtype == zj[k].dtype


def test_importance_reweight_and_quantiles():
    rng = np.random.default_rng(5)
    le = rng.normal(size=200)
    ls = le + rng.normal(0, 0.3, 200)
    le[3] = np.nan
    le[7] = -np.inf
    wj, ej = js.importance_reweight(le, ls)
    wt, et = ts.importance_reweight(le, ls)
    np.testing.assert_array_equal(wt, wj)
    assert et == ej and 0 < et < 200
    x = rng.lognormal(size=200)
    np.testing.assert_array_equal(
        ts.weighted_quantiles(x, wt, [0.025, 0.5, 0.975]),
        js.weighted_quantiles(x, wj, [0.025, 0.5, 0.975]))
    with pytest.raises(ValueError, match="non-finite"):
        ts.importance_reweight(np.full(3, np.nan), np.zeros(3))


def test_priors_match():
    pj, pt = jlit.build_priors(), tlit.build_priors()
    assert pt.lognorm == pj.lognorm
    assert sorted(pt.mv) == sorted(pj.mv)
    for k in pj.mv:
        np.testing.assert_array_equal(pt.mv[k].mu, pj.mv[k].mu)
        np.testing.assert_array_equal(pt.mv[k].cov, pj.mv[k].cov)
        assert pt.mv[k].kind == pj.mv[k].kind
        assert pt.mv[k].modes() == pj.mv[k].modes()
    assert pt.baseline_pvals() == pj.baseline_pvals()
    assert tdiff.estimate_diffusivities() == jdiff.estimate_diffusivities()
    assert [n for n in dir(tprot) if not n.startswith("__")] == \
        [n for n in dir(jprot) if not n.startswith("__")]


def test_diagnostics_match():
    rng = np.random.default_rng(6)
    qs = rng.normal(size=(4, 300, 3))
    qs[2, :, 1] += np.linspace(0, 2, 300)     # a drifting chain
    div = rng.uniform(size=(4, 300)) < 0.1
    for j in range(3):
        assert td.split_rhat(qs[:, :, j]) == jd.split_rhat(qs[:, :, j])
        assert td.ess(qs[:, :, j]) == jd.ess(qs[:, :, j])
        assert td.ess(qs[:, :, j], rank_normalized=False) == \
            jd.ess(qs[:, :, j], rank_normalized=False)
    rt = td.check_chains(qs, div, names=tl.FIT_NAMES[:3])
    rj = jd.check_chains(qs, div, names=tl.FIT_NAMES[:3])
    assert rt == rj
    frozen = np.tile(np.arange(4.0)[:, None, None], (1, 100, 2))
    assert td.check_chains(frozen) == jd.check_chains(frozen)
    assert not td.check_chains(frozen)["ok"]


def test_nuts_on_the_surrogate_posterior(surrogates):
    """Chains on a surrogate log posterior (wrap_vjp=False: autograd
    through the polynomial), batched over chains: finite draws inside
    the prior support, healthy by check_chains."""
    _, _, st, _ = surrogates
    lp = tl.make_log_posterior(st.y, wrap_vjp=False)
    x0 = torch.as_tensor(np.log([1.27, 3.12, 0.79, 4.67]))
    qs, info = tn.run_nuts(lp, x0.expand(2, 4).clone(),
                           tn.chain_generators(0, 2), num_warmup=60,
                           num_samples=80, max_depth=6)
    qs = qs.numpy()
    assert qs.shape == (2, 80, 4) and np.isfinite(qs).all()
    rep = td.check_chains(qs, info["diverged"].numpy(),
                          names=tl.FIT_NAMES)
    assert all(math.isfinite(r) for r in rep["rhat"].values())
    assert rep["divergence_rate"] < 0.25
