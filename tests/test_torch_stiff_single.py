"""The port's single-member stiff solver and its linear algebra against the
JAX package on the same inputs.

Tolerances (float64): the small Gauss-Jordan solves, the block Thomas
sweep, block cyclic reduction and the Jacobians within 1e-12 relative to
the largest entry (the packages differ only in op order); solve_stiff
with the same step sequence (equal accepted and rejected counts, equal
``failed``) and C, m within 1e-10 relative to the largest value.  With
float32 linear algebra on a float64 state: step counts within +-2 and
values within 1e-6 (tests/test_batch_stiff.py::TestMixedPrecision).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops import blocktridiag as j_bt
from gab1_shp2_tpu.ops import cyclic_reduction as j_cr
from gab1_shp2_tpu.ops import jacobian as j_jac
from gab1_shp2_tpu.ops import smalllu as j_lu
from gab1_shp2_tpu.ops.batch_stiff import block_jacobian_lanes as j_bjl
from gab1_shp2_tpu.ops.batch_stiff import make_mol_rhs_lanes as j_rhs_lanes
from gab1_shp2_tpu.ops.trbdf2 import _rhs_blocks_fn as j_rhs_blocks
from gab1_shp2_tpu.ops.trbdf2 import solve_stiff as j_solve

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.params import Params as TParams
from gab1_shp2_tpu_torch.ops import blocktridiag as t_bt
from gab1_shp2_tpu_torch.ops import cyclic_reduction as t_cr
from gab1_shp2_tpu_torch.ops import jacobian as t_jac
from gab1_shp2_tpu_torch.ops import smalllu as t_lu
from gab1_shp2_tpu_torch.ops.jacobian import block_jacobian_lanes as t_bjl
from gab1_shp2_tpu_torch.ops.batch_stiff import (
    make_mol_rhs_lanes as t_rhs_lanes,
)
from gab1_shp2_tpu_torch.ops.trbdf2 import _rhs_blocks_fn as t_rhs_blocks
from gab1_shp2_tpu_torch.ops.trbdf2 import solve_stiff as t_solve

torch.set_num_threads(2)

KW = dict(dr=1.0, tf=0.5, Nts=2, rtol=1e-5, atol=1e-8)

# case -> (method, extra keyword arguments, system)
CASES = {
    "trbdf2": ("trbdf2", {}, "base_system"),
    "rosenbrock23": ("rosenbrock23", {}, "base_system"),
    "rodas3": ("rodas3", {}, "base_system"),
    "rodas4": ("rodas4", {}, "base_system"),
    "rodas4_prechase": ("rodas4", dict(t_prechase=0.25), "base_system"),
    # the geometries run_variants compares with the base system
    "rect_rodas4": ("rodas4", {}, "rect_system"),
    "memb_sfk_trbdf2": ("trbdf2", {}, "memb_sfk_system"),
}


def _rel(a, b):
    """Largest difference relative to the largest reference entry (an
    all-zero reference must match exactly)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)),
                                       np.finfo(np.float64).tiny)


def _dominant(rng, shape, n=10):
    A = rng.normal(size=shape + (n, n))
    return A + n * np.eye(n)


@partial(jax.jit, static_argnames="pivoting")
def _j_gauss_jordan(A, B, pivoting):
    return (j_lu.gauss_jordan_solve(A, B, pivoting=pivoting),
            j_lu.inv_small(A, pivoting=pivoting))


@pytest.mark.parametrize("pivoting", [False, True])
def test_gauss_jordan_and_inverse(pivoting):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(6, 10, 10)) + (0.0 if pivoting else 10 * np.eye(10))
    B = rng.normal(size=(6, 10, 3))
    want, inv_j = _j_gauss_jordan(jnp.asarray(A), jnp.asarray(B),
                                  pivoting=pivoting)
    got = t_lu.gauss_jordan_solve(torch.as_tensor(A), torch.as_tensor(B),
                                  pivoting=pivoting)
    assert _rel(got.numpy(), want) < 1e-12
    inv_t = t_lu.inv_small(torch.as_tensor(A), pivoting=pivoting)
    assert _rel(inv_t.numpy(), inv_j) < 1e-12
    assert _rel(A @ inv_t.numpy(), np.broadcast_to(np.eye(10), A.shape)) \
        < 1e-12


@jax.jit
def _j_block_solves(L, D, U, b):
    """The JAX package's block Thomas solve, its matvec, and block cyclic
    reduction's factor and solve, as one program."""
    x_bt = j_bt.bt_solve(j_bt.bt_factor(L, D, U), b)
    fac = j_cr.cr_factor(L, D, U)
    return x_bt, j_bt.bt_matvec(L, D, U, x_bt), fac, j_cr.cr_solve(fac, b)


@pytest.mark.parametrize("NB", [7, 8])
def test_block_thomas_and_cyclic_reduction(NB):
    rng = np.random.default_rng(NB)
    L = rng.normal(size=(NB, 10, 10))
    U = rng.normal(size=(NB, 10, 10))
    D = _dominant(rng, (NB,), 10) + 20 * np.eye(10)
    b = rng.normal(size=(NB, 10))
    Lj, Dj, Uj, bj = map(jnp.asarray, (L, D, U, b))
    Lt, Dt, Ut, bt = map(torch.as_tensor, (L, D, U, b))

    x_bt_j, mv_j, fac_j, x_cr_j = _j_block_solves(Lj, Dj, Uj, bj)
    x_bt_t = t_bt.bt_solve(t_bt.bt_factor(Lt, Dt, Ut), bt)
    assert _rel(x_bt_t.numpy(), x_bt_j) < 1e-12
    assert _rel(t_bt.bt_matvec(Lt, Dt, Ut, x_bt_t).numpy(), mv_j) < 1e-12
    # the solve inverts the matvec (L[0] and U[-1] are ignored by both)
    Lt0 = torch.cat([torch.zeros_like(Lt[:1]), Lt[1:]])
    Ut0 = torch.cat([Ut[:-1], torch.zeros_like(Ut[:1])])
    assert _rel(t_bt.bt_matvec(Lt0, Dt, Ut0, x_bt_t).numpy(), b) < 1e-12

    fac_t = t_cr.cr_factor(Lt, Dt, Ut)
    assert len(fac_t.levels) == len(fac_j.levels)
    for lt, lj in zip(fac_t.levels, fac_j.levels):
        assert lt.n_blocks == int(lj.n_blocks)
        for name in ("Dinv_odd", "L_odd", "U_odd", "LDinv", "UDinv"):
            assert _rel(getattr(lt, name).numpy(), getattr(lj, name)) \
                < 1e-12, name
    x_cr_t = t_cr.cr_solve(fac_t, bt)
    assert _rel(x_cr_t.numpy(), x_cr_j) < 1e-12
    assert _rel(x_cr_t.numpy(), x_bt_t.numpy()) < 1e-12


def test_pad_pow2():
    rng = np.random.default_rng(3)
    L, D, U = (rng.normal(size=(5, 10, 10)) for _ in range(3))
    Lt, Dt, Ut, m = t_cr._pad_pow2(*map(torch.as_tensor, (L, D, U)), 5)
    Lj, Dj, Uj, mj = j_cr._pad_pow2(*map(jnp.asarray, (L, D, U)), 5)
    assert m == mj == 8
    for a, b in ((Lt, Lj), (Dt, Dj), (Ut, Uj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def jac_case():
    """A mid-transient state (the JAX solve at t=0.2) at dr=1.  The solve
    has the static arguments of ``jax_solves``' trbdf2 case, so the two
    share one compiled program."""
    dr = 1.0
    sol = j_solve(jg.base_system(), jg.default_co(), jg.default_params(),
                  dr=dr, tf=0.2, Nts=KW["Nts"], rtol=1e-6, atol=1e-9,
                  method="trbdf2")
    C = np.asarray(sol.C[-1])
    m = np.asarray(sol.m[-1])
    yb = np.asarray(j_jac.state_to_blocks(jnp.asarray(C[:, 1:-1]),
                                          jnp.asarray(m)))
    return dr, yb


def test_block_layout(jac_case):
    _, yb = jac_case
    C_t, m_t = t_jac.blocks_to_state(torch.as_tensor(yb))
    C_j, m_j = j_jac.blocks_to_state(jnp.asarray(yb))
    np.testing.assert_array_equal(C_t.numpy(), np.asarray(C_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(t_jac.state_to_blocks(C_t, m_t).numpy(),
                                  yb)
    np.testing.assert_array_equal(t_jac._color_seeds(yb.shape[0],
                                                     np.float64),
                                  j_jac._color_seeds(yb.shape[0],
                                                     np.float64))


def test_block_jacobian(jac_case):
    """The 38 colored JVPs against the JAX package's, and against the
    port's structure-aware lane bands."""
    dr, yb = jac_case
    fj, _ = j_rhs_blocks(jg.base_system(), 10.0, dr)
    ft, r = t_rhs_blocks(tg.base_system(), 10.0, dr)
    pj = jg.default_params()
    pt = tg.default_params(device="cpu")
    want, f_j = jax.jit(lambda y: (
        j_jac.block_jacobian(lambda v: fj(v, pj), y), fj(y, pj)))(
        jnp.asarray(yb))
    got = t_jac.block_jacobian(lambda y: ft(y, pt), torch.as_tensor(yb))
    fast = t_jac.fast_block_jacobian_lanes(
        tg.base_system(), torch.as_tensor(yb)[..., None],
        TParams(D=pt.D[None], k=pt.k[None]), r, dr)
    for g, w, f in zip(got, want, fast):
        assert _rel(g.numpy(), w) < 1e-12
        assert _rel(f[..., 0].numpy(), g.numpy()) < 1e-12
    # and the block right-hand side itself
    assert _rel(ft(torch.as_tensor(yb), pt).numpy(), f_j) < 1e-12


def test_block_jacobian_lanes(jac_case):
    """The lane version of the colored JVPs (two lanes: the state and a
    perturbed copy, per-lane kinetics) against the JAX package's and the
    port's structure-aware bands."""
    dr, yb = jac_case
    rng = np.random.default_rng(8)
    y = np.stack([yb, yb * (1.0 + 0.05 * rng.uniform(size=yb.shape))], -1)
    p0 = np.asarray(jg.default_params().pack())
    P = p0[None] * np.exp(rng.normal(0, 0.2, (2, 24)))
    fj, _ = j_rhs_lanes(jg.base_system(), 10.0, dr)
    ft, r = t_rhs_lanes(tg.base_system(), 10.0, dr)
    pj, pt = JParams.unpack(jnp.asarray(P)), TParams.unpack(torch.as_tensor(P))
    want = jax.jit(lambda y: j_bjl(lambda v: fj(v, pj), y))(jnp.asarray(y))
    got = t_bjl(lambda v: ft(v, pt), torch.as_tensor(y))
    fast = t_jac.fast_block_jacobian_lanes(tg.base_system(),
                                           torch.as_tensor(y), pt, r, dr)
    for g, w, f in zip(got, want, fast):
        assert _rel(g.numpy(), w) < 1e-12
        assert _rel(f.numpy(), g.numpy()) < 1e-12


@pytest.fixture(scope="module")
def jax_solves():
    out = {}
    for case, (method, extra, system) in CASES.items():
        sol, st = j_solve(getattr(jg, system)(), jg.default_co(),
                          jg.default_params(), method=method,
                          return_stats=True, **KW, **extra)
        out[case] = (np.asarray(sol.C), np.asarray(sol.m),
                     int(st.n_accepted), int(st.n_rejected), bool(st.failed))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_solve_stiff_matches_jax(jax_solves, case):
    method, extra, system = CASES[case]
    Cj, mj, naj, nrj, fj = jax_solves[case]
    sol, st = t_solve(getattr(tg, system)(), tg.default_co(device="cpu"),
                      tg.default_params(device="cpu"), device="cpu",
                      method=method, return_stats=True, **KW, **extra)
    assert int(st.n_accepted) == naj
    assert int(st.n_rejected) == nrj
    assert bool(st.failed) == fj
    assert _rel(sol.C.numpy(), Cj) < 1e-10
    assert _rel(sol.m.numpy(), mj) < 1e-10
    assert sol.C.shape == (KW["Nts"] + 1, 10, int(10.0 / KW["dr"]) + 1)
    np.testing.assert_allclose(sol.t.numpy(), [0.0, 0.25, 0.5])


@pytest.mark.parametrize("method", ["rodas4", "trbdf2"])
def test_solve_stiff_f32_linsolve(method):
    kw = dict(KW, tf=0.25, method=method, return_stats=True)
    sj, stj = j_solve(jg.base_system(), jg.default_co(), jg.default_params(),
                      linsolve_dtype=jnp.float32, **kw)
    st_, stt = t_solve(tg.base_system(), tg.default_co(device="cpu"),
                       tg.default_params(device="cpu"), device="cpu",
                       linsolve_dtype=torch.float32, **kw)
    assert abs(int(stt.n_accepted) - int(stj.n_accepted)) <= 2
    assert abs(int(stt.n_rejected) - int(stj.n_rejected)) <= 2
    assert st_.C.dtype == torch.float64
    assert _rel(st_.C.numpy(), sj.C) < 1e-6
    assert _rel(st_.m.numpy(), sj.m) < 1e-6


def test_solve_stiff_failure_flags():
    """max_steps exhausted: failed, NaN snapshots past the last save, the
    same step count as the JAX package."""
    kw = dict(KW, method="rodas4", max_steps=5, return_stats=True)
    sj, stj = j_solve(jg.base_system(), jg.default_co(), jg.default_params(),
                      **kw)
    st_, stt = t_solve(tg.base_system(), tg.default_co(device="cpu"),
                       tg.default_params(device="cpu"), device="cpu", **kw)
    assert bool(stt.failed) and bool(stj.failed)
    assert int(stt.n_accepted) + int(stt.n_rejected) == 5
    assert int(stt.n_accepted) == int(stj.n_accepted)
    assert torch.isnan(st_.C[-1]).all()
    np.testing.assert_array_equal(np.isnan(st_.C.numpy()),
                                  np.isnan(np.asarray(sj.C)))


def test_solve_stiff_f32_keeps_the_last_save_at_a_tf_float32_cannot_hold():
    """tf = 0.02 is not a float32 number: t stops at float32(0.02), below
    the float64 save time.  Compared in the state's dtype, as the JAX
    package compares them, the last save is written, with the JAX
    package's step counts."""
    kw = dict(dr=1.0, tf=0.02, Nts=2, rtol=1e-4, atol=1e-7, method="rodas4",
              return_stats=True)
    sj, stj = j_solve(jg.base_system(), jg.default_co(dtype=jnp.float32),
                      jg.default_params(dtype=jnp.float32), **kw)
    st_, stt = t_solve(tg.base_system(),
                       tg.default_co(dtype=torch.float32, device="cpu"),
                       tg.default_params(dtype=torch.float32, device="cpu"),
                       device="cpu", **kw)
    assert not bool(stj.failed)
    assert not bool(stt.failed)
    assert int(stt.n_accepted) == int(stj.n_accepted)
    assert int(stt.n_rejected) == int(stj.n_rejected)
    assert torch.isfinite(st_.C).all() and torch.isfinite(st_.m).all()
