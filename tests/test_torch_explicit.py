"""The port's explicit solver (gab1_shp2_tpu_torch.ops.explicit) against
the JAX ``solve_explicit`` and the independent NumPy oracle, on the CPU.

Tolerances.  In f64 the two packages run the same arithmetic in the same
order, so ``C``, ``m`` and ``t`` agree within 1e-12 relative (measured
~1e-15).  The absolute floor 1e-200 covers the pinned aSFK of memb_sfk,
whose interior values (~1e-300) lose digits to underflow in both
packages.  Against ``tests/reference_numpy_solver.py`` the bound is the
JAX test's own: rtol 1e-10 (``tests/test_cross_implementation.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.species import CYTO_SPECIES, MEMB_SPECIES
from gab1_shp2_tpu.ops import rhs as j_rhs

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.ops import rhs as t_rhs
from tests.reference_numpy_solver import solve_numpy

torch.set_num_threads(2)

KW = dict(dr=0.5, tf=0.5, Nts=5, tol=1e-6, maxiters=100)
VARIANTS = ["base_system", "rect_system", "memb_sfk_system"]


def _tparams(**scale):
    return tg.default_params(device="cpu").scale(**scale)


def _tsolve(system, params=None, co=None, **kw):
    return tg.solve_explicit(
        system, tg.default_co(device="cpu") if co is None else co,
        _tparams() if params is None else params, device="cpu", **kw)


def _assert_solutions_close(ts, js, rtol=1e-12):
    for name in ("C", "m", "t"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=rtol,
                                   atol=1e-200, err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_matches_jax_f64(variant):
    js = jg.solve_explicit(getattr(jg, variant)(), jg.default_co(),
                           jg.default_params(), **KW)
    ts = _tsolve(getattr(tg, variant)(), **KW)
    assert ts.C.dtype == torch.float64
    assert tuple(ts.C.shape) == (6, 10, 21) and tuple(ts.m.shape) == (6, 8)
    _assert_solutions_close(ts, js)
    np.testing.assert_array_equal(ts.r.numpy(), np.asarray(js.r))
    assert float(ts.CoEGFR) == float(js.CoEGFR)


def test_pulse_chase_event_matches_jax():
    kw = dict(dr=0.5, tf=0.6, Nts=6, tol=1e-6, maxiters=100, t_prechase=0.3)
    js = jg.solve_explicit(jg.base_system(), jg.default_co(),
                           jg.default_params(), **kw)
    ts = _tsolve(tg.base_system(), **kw)
    _assert_solutions_close(ts, js)
    pe = ts.pE.numpy()
    assert pe[3] > 0.3 and pe[-1] < 0.01 * pe[3]   # pEGFR decays in the chase


def test_masked_steps_match_plain():
    """Extra masked steps give identical output
    (``tests/test_explicit.py::test_masked_steps_match_plain``)."""
    dt = 5e-4
    kw = dict(dr=0.5, tf=0.3, Nts=3, tol=1e-4, maxiters=20)
    a = _tsolve(tg.base_system(), dt=dt, **kw)
    n = int(np.ceil(0.3 / dt))
    b = _tsolve(tg.base_system(), dt=dt, n_steps=n + 37, nt_active=n, **kw)
    assert torch.isfinite(a.C).all()
    assert torch.equal(a.C, b.C) and torch.equal(a.m, b.m)
    assert torch.equal(a.t, b.t)
    js = jg.solve_explicit(jg.base_system(), jg.default_co(),
                           jg.default_params(), dt=dt, n_steps=n + 37,
                           nt_active=n, **kw)
    _assert_solutions_close(b, js)


def test_batched_solve_equals_each_member_alone():
    """Members with different dt, step counts and fixed-point iteration
    counts share a batch without seeing each other: bit-equal to solo."""
    p0 = _tparams()
    # the EGF=0 member never converges (NaN relative change) and runs all
    # 30 iterations while its neighbours stop after a few
    members = [p0, p0.scale(kp=3.0, kG2f=0.5), p0.scale(Dg2=2.0, kSa=4.0),
               p0.replace(EGF=0.0)]
    pb = tg.Params(D=torch.stack([p.D for p in members]),
                   k=torch.stack([p.k for p in members]))
    kw = dict(dr=0.5, tf=0.15, Nts=3, tol=1e-6, maxiters=30)
    batched = _tsolve(tg.base_system(), params=pb, **kw)
    assert tuple(batched.C.shape) == (4, 4, 10, 21)
    assert tuple(batched.t.shape) == (4, 4)
    assert tuple(batched.CoEGFR.shape) == (4,)
    for i, p in enumerate(members):
        solo = _tsolve(tg.base_system(), params=p, **kw)
        assert torch.equal(batched.C[i], solo.C), i
        assert torch.equal(batched.m[i], solo.m), i
        assert torch.equal(batched.t[i], solo.t), i
    # and the member with D x 2 matches the JAX package's solo solve
    js = jg.solve_explicit(jg.base_system(), jg.default_co(),
                           jg.default_params().scale(Dg2=2.0, kSa=4.0), **kw)
    np.testing.assert_allclose(batched.C[2].numpy(), np.asarray(js.C),
                               rtol=1e-12, atol=1e-200)


def test_no_egf_keeps_iterating_on_nan():
    """EGF=0: the relative change of the untouched species is 0/0 = NaN,
    which must keep the fixed point iterating, not end it
    (``tests/test_explicit.py::test_egf_drives_activation``)."""
    kw = dict(dr=0.5, tf=0.5, Nts=2, tol=1e-4, maxiters=20)
    ts = _tsolve(tg.base_system(), params=_tparams().replace(EGF=0.0), **kw)
    assert float(ts.pE.max()) == 0.0
    assert float(ts.cyto("aSFK").max()) == 0.0
    assert float(ts.PG1Stot.max()) == 0.0
    js = jg.solve_explicit(jg.base_system(), jg.default_co(),
                           jg.default_params().replace(EGF=0.0), **kw)
    _assert_solutions_close(ts, js)


def test_float32_co_selects_f32():
    kw = dict(dr=0.5, tf=0.2, Nts=2, tol=1e-4, maxiters=20)
    ts = _tsolve(tg.base_system(),
                 co=tg.default_co(dtype=torch.float32, device="cpu"), **kw)
    assert ts.C.dtype == ts.m.dtype == ts.t.dtype == torch.float32
    js = jg.solve_explicit(jg.base_system(),
                           jnp.asarray(jg.default_co(), jnp.float32),
                           jg.default_params(), **kw)
    assert js.C.dtype == jnp.float32
    # f32: the same scheme in another op order, ~400 steps
    np.testing.assert_allclose(ts.C.numpy(), np.asarray(js.C), rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("variant,oracle_kw", [
    ("base_system", {}),
    ("rect_system", {"geometry": "rect"}),
    ("memb_sfk_system", {"memb_sfk": True}),
])
def test_matches_independent_numpy(variant, oracle_kw):
    p = _tparams()
    kw = dict(dr=0.5, tf=0.5, Nts=2, maxiters=100, tol=1e-6)
    ref = solve_numpy(tg.default_co(device="cpu").numpy(), p.D.numpy(),
                      p.k.numpy(), R=10.0, **kw, **oracle_kw)
    sol = _tsolve(getattr(tg, variant)(), **kw)
    for name in CYTO_SPECIES:
        np.testing.assert_allclose(sol.cyto(name)[-1].numpy(), ref[name],
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    for i, name in enumerate(MEMB_SPECIES):
        np.testing.assert_allclose(float(sol.m[-1, i]), ref[f"m_{name}"],
                                   rtol=1e-10, atol=1e-14, err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_laplacian_and_full_profile_match_jax(variant):
    """The node-major stencil and the profile reconstruction, one member
    against JAX (1e-13) and a batch of members against each alone."""
    rng = np.random.default_rng(8)
    dr, n = 0.5, 21
    C = rng.uniform(0.1, 5.0, (3, 10, n))
    m = rng.uniform(0.1, 5.0, (3, 8))
    r = np.arange(n) * dr
    js, ts = getattr(jg, variant)(), getattr(tg, variant)()
    pj, pt = jg.default_params(), _tparams()
    lap_b = t_rhs.laplacian(ts, torch.as_tensor(C), torch.as_tensor(r), dr)
    assert tuple(lap_b.shape) == (3, 10, n - 2)
    d_eff = t_rhs.effective_diffusivities(ts, pt)
    prof_b = t_rhs.full_profile(
        ts, t_rhs.MolState(torch.as_tensor(C[:, :, 1:-1]),
                           torch.as_tensor(m)),
        t_rhs.kdict(pt.k), d_eff, dr)
    assert tuple(prof_b.shape) == (3, 10, n)
    for i in range(3):
        want = j_rhs.laplacian(js, jnp.asarray(C[i]), jnp.asarray(r), dr)
        np.testing.assert_allclose(lap_b[i].numpy(), np.asarray(want),
                                   rtol=1e-13, atol=1e-13)
        want = j_rhs.full_profile(
            js, j_rhs.MolState(jnp.asarray(C[i, :, 1:-1]),
                               jnp.asarray(m[i])),
            j_rhs.kdict(pj.k), j_rhs.effective_diffusivities(js, pj), dr)
        np.testing.assert_allclose(prof_b[i].numpy(), np.asarray(want),
                                   rtol=1e-13)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="shape"):
        _tsolve(tg.base_system(), co=torch.ones(2, 5, dtype=torch.float64),
                dr=1.0, tf=0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.solve_explicit(tg.base_system(), tg.default_co(device="cpu"),
                              _tparams(), dr=1.0, tf=0.1)
