"""The port's inference layer (loss, log posterior, LBFGS) against the JAX
package on the same inputs.

Tolerances (float64): set_fitted, datum_loglik and chi2_loss within
1e-12 relative (jax.scipy's norm.logcdf against torch.special.log_ndtr);
the observable through the stiff solve within 1e-10 and its gradient
(torch.func.jacfwd, and the port's dual-number forward mode) within 1e-8
relative to jax.jacfwd's largest entry; the log posterior's value within
1e-10 and its gradient through the autograd Function within 1e-8;
make_batch_observable within 1e-9; lbfgs_minimize's iterates within
1e-8 of optax.lbfgs on a 4-D quadratic and the 4-D Rosenbrock function
over 10 iterations.  The solves use TestPDELikelihood's FAST
configuration (tests/test_inference.py:150); JAX results are computed
once per module.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gab1_shp2_tpu.inference import loss as jl
from gab1_shp2_tpu.models.params import default_params as j_default_params

from gab1_shp2_tpu_torch.inference import loss as tl
from gab1_shp2_tpu_torch.inference import map_fit as tm
from gab1_shp2_tpu_torch.models.params import default_params
from gab1_shp2_tpu_torch.ops.fwdgrad import value_and_fwd_grad

torch.set_num_threads(2)

FAST = dict(dr=0.5, tf=1.0, rtol=1e-3, atol=1e-6)
X_MODES = np.log([0.42, 9.5, 0.42, 9.5])


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_set_fitted():
    log_k4 = np.log([1.0, 2.0, 3.0, 4.0])
    pj = jl.set_fitted(j_default_params(fit="prior"), jnp.asarray(log_k4))
    pt = tl.set_fitted(default_params(fit="prior", device="cpu"),
                       torch.as_tensor(log_k4))
    np.testing.assert_allclose(pt.k.numpy(), np.asarray(pj.k), rtol=1e-15)
    np.testing.assert_array_equal(pt.D.numpy(), np.asarray(pj.D))
    assert float(pt.kSi) == pytest.approx(4.0)
    # a batch of points against a shared base broadcasts
    Q = np.log(np.array([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]]))
    pb = tl.set_fitted(default_params(fit="prior", device="cpu"),
                       torch.as_tensor(Q))
    assert pb.k.shape == (2, 17)
    np.testing.assert_allclose(pb.kG1p.numpy(), [1.0, 5.0], rtol=1e-15)


def test_datum_loglik_and_chi2():
    y = np.array([26.426, 1.0, 60.0, 99.0, 150.0, 1e-3, 0.0, -3.0, np.nan,
                  np.inf])
    want = np.asarray(jl.datum_loglik(jnp.asarray(y)))
    got = tl.datum_loglik(torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert tl.DATUM_SIGMA == jl.DATUM_SIGMA and tl.DATUM_MU == jl.DATUM_MU
    for v in (10.0, 26.0, 40.0):
        cj = float(jl.chi2_loss(lambda x: jnp.asarray(v), jnp.zeros(4)))
        ct = float(tl.chi2_loss(
            lambda x: torch.tensor(v, dtype=torch.float64), torch.zeros(4)))
        assert ct == pytest.approx(cj, rel=1e-14)
    # the NaN guard: a failed solve is +inf, never NaN
    nan_obs = lambda x: torch.nan * x[0]  # noqa: E731
    assert float(tl.chi2_loss(nan_obs, torch.zeros(4))) == math.inf


def test_prior_box():
    for a, b in zip(tl.prior_box(), jl.prior_box()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-15)


@pytest.fixture(scope="module")
def jax_obs():
    """The JAX observable's value and jacfwd at the modes, from one
    program: the value is jacfwd's primal output."""
    obs = jl.make_observable_fn(**FAST)

    def value_twice(x):
        y = obs(x)
        return y, y

    g, v = jax.jacfwd(value_twice, has_aux=True)(jnp.asarray(X_MODES))
    return float(v), np.asarray(g)


def test_observable_and_fwd_gradient(jax_obs):
    """Value, torch.func.jacfwd and the dual-number forward mode."""
    v_j, g_j = jax_obs
    obs = tl.make_observable_fn(device="cpu", **FAST)
    x = torch.as_tensor(X_MODES)
    v = float(obs(x))
    assert abs(v - v_j) / abs(v_j) < 1e-10
    assert 0.0 < v < 100.0
    g_func = torch.func.jacfwd(obs)(x).numpy()
    assert _rel(g_func, g_j) < 1e-8
    v_d, g_d = value_and_fwd_grad(obs, x)
    assert abs(float(v_d) - v_j) / abs(v_j) < 1e-10
    assert _rel(g_d.numpy(), g_j) < 1e-8
    # the signs of TestPDELikelihood
    assert g_d[2] > 0 and g_d[1] < 0


@pytest.fixture(scope="module")
def jax_logpost():
    lp = jl.make_log_posterior(jl.make_observable_fn(**FAST))
    vg = jax.jit(jax.value_and_grad(lp))
    out = {}
    for name, x in (("modes", X_MODES), ("far", X_MODES + 20.0)):
        v, g = vg(jnp.asarray(x))
        out[name] = (x, float(v), np.asarray(g))
    return out


def test_log_posterior_value_and_gradient(jax_logpost):
    """Inside the support (value and gradient) and far outside it (-inf
    with a zero gradient), as rows of one batched call: each row is its
    own solve."""
    lp = tl.make_log_posterior(tl.make_observable_fn(device="cpu", **FAST))
    (x_in, v_in, g_in), (x_out, v_out, g_out) = (jax_logpost["modes"],
                                                 jax_logpost["far"])
    Q = torch.as_tensor(np.stack([x_in, x_out])).requires_grad_(True)
    v = lp(Q)
    (g,) = torch.autograd.grad(v.sum(), Q)
    assert abs(float(v[0]) - v_in) / abs(v_in) < 1e-10
    assert _rel(g[0].numpy(), g_in) < 1e-8
    assert float(v[1]) == v_out == -math.inf
    np.testing.assert_array_equal(g[1].numpy(), g_out)
    assert not g[1].any()


def test_reverse_differentiable_sentinels():
    """A finite value with NaN tangents reports the sentinel and a zero
    gradient (-inf for densities, +inf for losses), in both packages."""
    c = 0.3

    def fj(q):
        return 2.0 + 0.0 * jnp.sqrt(q[0] - c) + jnp.sum(q**2)

    def ft(q):
        return 2.0 + 0.0 * torch.sqrt(q[0] - c) + torch.sum(q**2)

    x = np.array([c, 0.1, -0.2, 0.4])
    for bad in (-math.inf, math.inf):
        vj, gj = jax.value_and_grad(jl.reverse_differentiable(
            fj, bad_value=bad))(jnp.asarray(x))
        q = torch.as_tensor(x).requires_grad_(True)
        v = tl.reverse_differentiable(ft, bad_value=bad)(q)
        (g,) = torch.autograd.grad(v, q)
        assert float(v) == float(vj) == bad
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    # a regular point passes through: value and exact gradient
    x = np.array([c + 1.0, 0.1, -0.2, 0.4])
    q = torch.as_tensor(x).requires_grad_(True)
    v = tl.reverse_differentiable(ft)(q)
    (g,) = torch.autograd.grad(3.0 * v, q)
    assert float(v) == pytest.approx(2.0 + np.sum(x**2), rel=1e-15)
    np.testing.assert_allclose(g.numpy(), 6.0 * x, rtol=1e-15)


def test_batch_observable():
    rng = np.random.default_rng(4)
    Q = X_MODES + rng.normal(0.0, 0.5, (5, 4))
    want = jl.make_batch_observable(chunk=3, **FAST)(Q)
    got = tl.make_batch_observable(device="cpu", chunk=3, **FAST)(Q)
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-9)


# --- LBFGS against optax.lbfgs ----------------------------------------------

_A = np.diag([1.0, 10.0, 100.0, 3.0]) + 0.5
_X0 = np.array([-1.2, 1.0, 0.5, -0.3])
_TARGETS = {
    "quadratic": (lambda x: 0.5 * x @ jnp.asarray(_A) @ x + jnp.sum(x),
                  lambda x: 0.5 * x @ torch.as_tensor(_A) @ x
                  + torch.sum(x)),
    "rosenbrock": (lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                                     + (1 - x[:-1]) ** 2),
                   lambda x: torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                                       + (1 - x[:-1]) ** 2)),
}


def _optax_iterates(f, x0, n):
    """The loop of the JAX package's lbfgs_minimize, recording x."""
    opt = optax.lbfgs()
    vg = jax.value_and_grad(f)

    @jax.jit
    def step(x, state):
        val, grad = vg(x)
        upd, state = opt.update(grad, state, x, value=val, grad=grad,
                                value_fn=f)
        return optax.apply_updates(x, upd), state

    x = jnp.asarray(x0)
    state = opt.init(x)
    out = []
    for _ in range(n):
        x, state = step(x, state)
        out.append(np.asarray(x))
    return np.array(out)


@pytest.mark.parametrize("target", list(_TARGETS))
def test_lbfgs_iterates_match_optax(target):
    fj, ft = _TARGETS[target]
    want = _optax_iterates(fj, _X0, 10)
    got = np.array([tm.lbfgs_minimize(ft, torch.as_tensor(_X0),
                                      max_iters=n)[0].numpy()
                    for n in range(1, 11)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_lbfgs_projection_and_failure_sentinel():
    """The box projection after each step, and a region where the loss is
    NaN (+inf through the sentinel) rejected by the line search."""
    def f(x):
        v = torch.sum((x - 3.0) ** 2)
        return torch.where(x[0] > 2.5, torch.nan * v, v)

    lb = torch.full((4,), -1.0, dtype=torch.float64)
    ub = torch.full((4,), 2.0, dtype=torch.float64)
    x, v = tm.lbfgs_minimize(f, torch.zeros(4, dtype=torch.float64),
                             max_iters=10, lb=lb, ub=ub)
    np.testing.assert_allclose(x.numpy(), 2.0, atol=1e-8)
    assert float(v) == pytest.approx(4.0, rel=1e-8)
    x, v = tm.lbfgs_minimize(f, torch.zeros(4, dtype=torch.float64),
                             max_iters=10)
    assert np.isfinite(float(v)) and float(x[0]) <= 2.5
