"""The port's NUTS sampler: its deterministic pieces against the JAX
package's on identical inputs (within 1e-12 relative), the analytic
targets of TestNUTS at its thresholds (tests/test_inference.py:23-151),
and a short run on a small PDE posterior.

The draws cannot match the JAX package's (another random generator), so
the sampler is held to the targets statistically.  Chains are a leading
batch axis of the port's state; batched chains draw exactly what
per-chain runs with the same generators draw.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gab1_shp2_tpu.inference import nuts as jn

from gab1_shp2_tpu_torch.inference import loss as tl
from gab1_shp2_tpu_torch.inference import nuts as tn

torch.set_num_threads(2)

PREC = np.array([[2.0, 0.6, 0.0], [0.6, 1.5, -0.3], [0.0, -0.3, 1.0]])
C, D = 5, 3


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _std_normal(q):
    return -0.5 * (q**2).sum(-1)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(q=rng.normal(size=(C, D)), p=rng.normal(size=(C, D)),
                eps=rng.uniform(0.05, 0.5, C),
                inv_mass=rng.uniform(0.5, 2.0, (C, D)))


def test_leapfrog_and_kinetic():
    x = _inputs()
    lp_j = lambda q: -0.5 * q @ jnp.asarray(PREC) @ q  # noqa: E731

    def lp_t(q):
        return -0.5 * torch.einsum("ci,ij,cj->c", q, _t(PREC), q)

    grad = -(x["q"] @ PREC)
    want = jax.vmap(lambda q, p, g, e, m: jn._leapfrog(lp_j, q, p, g, e, m))(
        *(jnp.asarray(x[k]) if k != "g" else jnp.asarray(grad)
          for k in ("q", "p", "g", "eps", "inv_mass")))
    got = tn._leapfrog(lp_t, _t(x["q"]), _t(x["p"]), _t(grad), _t(x["eps"]),
                       _t(x["inv_mass"]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14)
    kj = jax.vmap(jn._kinetic)(jnp.asarray(x["p"]), jnp.asarray(x["inv_mass"]))
    kt = tn._kinetic(_t(x["p"]), _t(x["inv_mass"]))
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-12)


def test_is_turning():
    rng = np.random.default_rng(1)
    args = [rng.normal(size=(64, D)) for _ in range(5)]
    args[0] = np.abs(args[0])  # inverse mass
    want = jax.vmap(jn._is_turning)(*map(jnp.asarray, args))
    got = tn._is_turning(*map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < 64


def _states(seed=2):
    """The same chain states for both packages: a JAX NUTSState with a
    chain axis, and the port's from its numpy fields."""
    rng = np.random.default_rng(seed)
    f = dict(q=rng.normal(size=(C, D)), logp=rng.normal(size=C),
             grad=rng.normal(size=(C, D)),
             step_size=rng.uniform(0.1, 1.0, C),
             inv_mass=rng.uniform(0.5, 2.0, (C, D)),
             log_eps_bar=rng.normal(size=C), h_bar=rng.normal(size=C) * 0.1,
             mu=rng.normal(size=C),
             w_count=rng.integers(0, 5, C).astype(np.int32),
             w_mean=rng.normal(size=(C, D)),
             w_m2=rng.uniform(0.1, 3.0, (C, D)))
    sj = jn.NUTSState(rng=jax.random.split(jax.random.PRNGKey(0), C),
                      **{k: jnp.asarray(v) for k, v in f.items()})
    st = tn.NUTSState.from_numpy(
        {k: np.asarray(getattr(sj, k)) for k in f},
        tn.chain_generators(0, C), device="cpu")
    info = dict(accept_stat=rng.uniform(0, 1, C), diverged=np.zeros(C, bool),
                depth=np.full(C, 3, np.int32), energy=rng.normal(size=C))
    info["accept_stat"][1] = np.nan  # a non-finite statistic
    ij = jn.NUTSInfo(**{k: jnp.asarray(v) for k, v in info.items()})
    it = tn.NUTSInfo(**{k: torch.as_tensor(v) for k, v in info.items()})
    return sj, st, ij, it


def _compare_states(st, sj):
    got = st.to_numpy()
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(getattr(sj, k)),
                                   rtol=1e-12, atol=1e-15, err_msg=k)


def test_state_round_trip():
    sj, st, _, _ = _states()
    _compare_states(st, sj)
    again = tn.NUTSState.from_numpy(st.to_numpy(), st.rng, device="cpu")
    for a, b in zip(again, st):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    # a single chain's fields (no chain axis) get one
    one = tn.NUTSState.from_numpy({k: v[0] for k, v in st.to_numpy().items()},
                                  torch.Generator(), device="cpu")
    assert one.q.shape == (1, D) and one.logp.shape == (1,)


@pytest.mark.parametrize("t", [0, 7, 49])
def test_adapt_and_warm_update(t):
    sj, st, ij, it = _states(seed=t)
    for adapt_mass in (True, False):
        want = jax.vmap(lambda s, i: jn._adapt(
            s, i, jnp.asarray(t, jnp.int32), target_accept=0.65,
            adapt_mass=adapt_mass))(sj, ij)
        got = tn._adapt(st, it, t, target_accept=0.65,
                        adapt_mass=adapt_mass)
        _compare_states(got, want)
    # t == num_warmup // 2 adopts the Welford variance as the mass
    for num_warmup in (2 * t, 100):
        want = jax.vmap(lambda s, i: jn._warm_update(
            s, i, jnp.asarray(t, jnp.int32), num_warmup=num_warmup,
            target_accept=0.65))(sj, ij)
        got = tn._warm_update(st, it, t, num_warmup=num_warmup,
                              target_accept=0.65)
        _compare_states(got, want)


# --- the analytic targets of TestNUTS ---------------------------------------

def test_standard_normal():
    qs, info = tn.run_nuts(_std_normal, torch.zeros(3, dtype=torch.float64),
                           torch.Generator().manual_seed(0), num_warmup=400,
                           num_samples=1500)
    qs = qs.numpy()
    np.testing.assert_allclose(qs.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(qs.std(0), 1.0, atol=0.12)
    assert int(info["diverged"].sum()) == 0
    assert 0.5 < float(info["accept_stat"].mean()) < 0.95


def test_correlated_gaussian():
    cov = np.array([[2.0, 1.5], [1.5, 2.0]])
    prec = _t(np.linalg.inv(cov))

    def logp(q):
        return -0.5 * torch.einsum("...i,ij,...j->...", q, prec, q)

    qs, _ = tn.run_nuts(logp, torch.zeros(2, dtype=torch.float64),
                        torch.Generator().manual_seed(1), num_warmup=500,
                        num_samples=4000)
    np.testing.assert_allclose(np.cov(qs.numpy().T), cov, atol=0.35)


def test_nonzero_mean_and_scales():
    mu = _t([3.0, -2.0])
    sig = _t([0.5, 4.0])

    def logp(q):
        return -0.5 * (((q - mu) / sig) ** 2).sum(-1)

    qs, _ = tn.run_nuts(logp, torch.zeros(2, dtype=torch.float64),
                        torch.Generator().manual_seed(2), num_warmup=600,
                        num_samples=3000)
    qs = qs.numpy()
    np.testing.assert_allclose(qs.mean(0), mu.numpy(), atol=0.3)
    np.testing.assert_allclose(qs.std(0), sig.numpy(), rtol=0.15)


def test_nan_region_cannot_poison_adaptation():
    """A density that is NaN beyond a wall acts like a divergence wall:
    warmup (blocked, as the workload runs it) adapts to a finite step
    size and the chains sample the interior."""
    def logp(q):
        v = -0.5 * (q**2).sum(-1)
        return torch.where((q.abs() > 4.0).any(-1), torch.nan, v)

    st = tn.init(logp, torch.zeros(3, 4, dtype=torch.float64),
                 tn.chain_generators(0, 3), step_size=0.1)
    for t0 in range(0, 200, 20):
        st = tn.warmup_block(logp, st, t0, num_block=20, num_warmup=200,
                             max_depth=6)
    st = tn.warmup_finalize(st)
    assert torch.isfinite(st.step_size).all()
    _, qs, info = tn.sample(logp, st, num_samples=200, max_depth=6)
    qs = qs.numpy()
    div = info["diverged"].numpy()
    assert div.mean() < 0.2, div.mean()
    for c in range(qs.shape[0]):
        assert len(np.unique(qs[c, :, 0])) > 100
    np.testing.assert_allclose(qs[..., 0].mean(), 0.0, atol=0.15)
    np.testing.assert_allclose(qs[..., 0].std(), 1.0, atol=0.15)


def test_blocked_warmup_matches_one_shot():
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    one = tn.warmup(_std_normal, torch.zeros(3, dtype=torch.float64), gen(),
                    num_warmup=50, max_depth=6)
    state = tn.init(_std_normal, torch.zeros(3, dtype=torch.float64), gen(),
                    step_size=0.1)
    for t0, nb in ((0, 20), (20, 20), (40, 10)):  # uneven blocks
        state = tn.warmup_block(_std_normal, state, t0, num_block=nb,
                                num_warmup=50, max_depth=6)
    blocked = tn.warmup_finalize(tn.warmup_finalize(state))
    for a, b, name in zip(one, blocked, one._fields):
        if name != "rng":
            assert torch.equal(a, b), name
    assert torch.equal(one.rng[0].get_state(), blocked.rng[0].get_state())


def test_tree_depth_symmetric():
    """With the direction-aware within-subtree U-turn check a 1-D
    standard normal at eps=0.05 builds trees of mean depth > 4.5 (a
    sign-inverted check stops backward subtrees at ~2.9)."""
    state = tn.init(_std_normal, torch.zeros(1, dtype=torch.float64),
                    torch.Generator().manual_seed(7), step_size=0.05)
    depths = []
    for _ in range(300):
        state, info = tn._nuts_step(_std_normal, state, max_depth=10)
        depths.append(int(info.depth[0]))
    assert np.mean(depths) > 4.5, np.mean(depths)


def test_batched_chains_match_per_chain_runs():
    gens = tn.chain_generators(3, 4)
    qs, info = tn.run_nuts(_std_normal, torch.zeros(4, 2, dtype=torch.float64),
                           gens, num_warmup=200, num_samples=400)
    assert qs.shape == (4, 400, 2)
    np.testing.assert_allclose(qs.reshape(-1, 2).numpy().std(0), 1.0,
                               atol=0.15)
    for c in range(4):
        qc, ic = tn.run_nuts(_std_normal,
                             torch.zeros(2, dtype=torch.float64),
                             torch.Generator().manual_seed(3 + c),
                             num_warmup=200, num_samples=400)
        assert torch.equal(qc, qs[c])
        assert torch.equal(ic["step_size"], info["step_size"][c])


def test_host_tree_sampler_is_the_compiled_step():
    """make_host_tree_sampler draws what _nuts_step (+ the warmup update)
    draws from the same state."""
    st = tn.init(_std_normal, torch.zeros(2, 3, dtype=torch.float64),
                 tn.chain_generators(11, 2))
    draw = tn.make_host_tree_sampler(_std_normal, max_depth=6,
                                     num_warmup=10)
    a, _ = draw(st, warm_t=2)
    st2 = tn.init(_std_normal, torch.zeros(2, 3, dtype=torch.float64),
                  tn.chain_generators(11, 2))
    b, info = tn._nuts_step(_std_normal, st2, max_depth=6)
    b = tn._warm_update(b, info, 2, num_warmup=10, target_accept=0.65)
    for x, y, name in zip(a, b, a._fields):
        if name != "rng":
            assert torch.equal(x, y), name


def test_nuts_smoke_on_pde_posterior():
    """A short run on a PDE posterior (rodas4, dr=1, tf=0.5, rtol 1e-2,
    cheaper than TestPDELikelihood's FAST configuration, 6 + 6 draws at
    depth 3 against 15 + 15 at depth 6): the chain moves and stays
    finite."""
    obs = tl.make_observable_fn(device="cpu", dr=1.0, tf=0.5, rtol=1e-2,
                                method="rodas4")
    lp = tl.make_log_posterior(obs)
    x0 = torch.as_tensor(np.log([1.27, 3.12, 0.79, 4.67]))
    qs, info = tn.run_nuts(lp, x0, torch.Generator().manual_seed(0),
                           num_warmup=6, num_samples=6, max_depth=3,
                           init_step_size=0.5)
    qs = qs.numpy()
    assert np.isfinite(qs).all()
    assert np.isfinite(info["logp"].numpy()).all()
    assert np.std(qs, axis=0).max() > 0.05
    assert math.isfinite(float(info["step_size"]))
