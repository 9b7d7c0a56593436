"""The port's observables, rate summaries and spatial average against the
JAX package on seeded ``Solution`` arrays.

Tolerance: 1e-12 relative.  Both packages evaluate the same closed-form
expressions in f64; sums (the trapezoid rule) may run in another order.
``torch.gradient(edge_order=1)`` and ``jnp.gradient`` use the same
one-sided first-order differences at the two ends, which
``test_time_derivative_edge_order`` shows on a curved series.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models import observables as jobs
from gab1_shp2_tpu.models import rates as jrates
from gab1_shp2_tpu.ops.solution import Solution as JSolution
from gab1_shp2_tpu.ops.solution import spatial_average as j_spatial_average

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models import observables as tobs
from gab1_shp2_tpu_torch.models import rates as trates
from gab1_shp2_tpu_torch.ops.solution import Solution as TSolution
from gab1_shp2_tpu_torch.ops.solution import spatial_average

torch.set_num_threads(2)

R = 10.0


def _solutions(seed, batch=()):
    """A seeded Solution pair with profiles that decay from the membrane
    (so the length scales fall inside the grid)."""
    rng = np.random.default_rng(seed)
    T, n = 7, 21
    r = np.linspace(0.0, R, n)
    t = np.linspace(0.0, 3.0, T)
    decay = np.exp(-(R - r) / rng.uniform(0.5, 4.0, batch + (T, 10, 1)))
    C = rng.uniform(0.5, 5.0, batch + (T, 10, 1)) * decay \
        + rng.uniform(0.0, 0.05, batch + (T, 10, n))
    m = rng.uniform(0.0, 5.0, batch + (T, 8))
    co = rng.uniform(100.0, 500.0, batch + (5,))
    js = JSolution(C=jnp.asarray(C), m=jnp.asarray(m), t=jnp.asarray(t),
                   r=jnp.asarray(r), CoEGFR=jnp.asarray(co[..., 4]))
    ts = TSolution(C=torch.as_tensor(C), m=torch.as_tensor(m),
                   t=torch.as_tensor(t), r=torch.as_tensor(r),
                   CoEGFR=torch.as_tensor(co[..., 4]))
    return js, ts, co


def _close(got, want, name=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               err_msg=name)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_spatial_average(batch):
    js, ts, _ = _solutions(1, batch)
    _close(spatial_average(ts.cyto("aSFK"), ts.r, R),
           j_spatial_average(js.cyto("aSFK"), js.r, R))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_pct_shp2_bound_gab1(batch):
    js, ts, co = _solutions(2, batch)
    _close(tobs.pct_shp2_bound_gab1(ts, torch.as_tensor(co), R),
           jobs.pct_shp2_bound_gab1(js, jnp.asarray(co), R))


@pytest.mark.parametrize("frac", [0.5, 0.1])
def test_length_scale(frac):
    js, ts, _ = _solutions(3, (4,))
    got = tobs.length_scale(ts.PG1Stot[..., -1, :], ts.r, R, frac)
    want = jobs.length_scale(js.PG1Stot[..., -1, :], js.r, R, frac)
    _close(got, want)
    assert 0.0 < float(got.min()) and float(got.max()) <= R


@pytest.mark.parametrize("batch", [(), (3,)])
def test_gsa_outputs(batch):
    js, ts, _ = _solutions(4, batch)
    got = tobs.gsa_outputs(ts, R)
    assert tuple(got.shape) == batch + (6,)
    _close(got, jobs.gsa_outputs(js, R))


def test_gsa_outputs_under_vmap():
    """``run_ensemble`` applies extract functions with torch.func.vmap."""
    js, ts, _ = _solutions(5, (3,))
    tsb = ts._replace(t=ts.t.expand(3, -1), r=ts.r.expand(3, -1))
    got = torch.func.vmap(lambda s: tobs.gsa_outputs(s, R))(tsb)
    _close(got, jobs.gsa_outputs(js, R))


def test_reaction_rate_summaries():
    js, ts, co = _solutions(6)
    want = jrates.reaction_rate_summaries(js, jg.default_params(),
                                          jnp.asarray(co), R)
    got = trates.reaction_rate_summaries(ts, tg.default_params(device="cpu"),
                                         torch.as_tensor(co), R)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], name)
    assert trates.MOLEC_TO_UM == jrates.MOLEC_TO_UM


def test_time_derivative_edge_order():
    t = np.linspace(0.0, 2.0, 9)
    y = np.exp(1.3 * t)[None] * np.array([[1.0], [2.5]])
    want = jnp.gradient(jnp.asarray(y), t[1] - t[0], axis=-1)
    got = trates._ddt(torch.as_tensor(y), torch.as_tensor(t))
    _close(got, want)
    # one-sided first-order at both ends, central inside
    h = t[1] - t[0]
    np.testing.assert_allclose(got[:, 0].numpy(), (y[:, 1] - y[:, 0]) / h,
                               rtol=1e-13)
    np.testing.assert_allclose(got[:, -1].numpy(), (y[:, -1] - y[:, -2]) / h,
                               rtol=1e-13)
