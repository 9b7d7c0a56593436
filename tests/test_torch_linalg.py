"""The port's lane-minor block linear algebra against the JAX package
(gj_inv_lanes, mm_lanes, mv_lanes, cr_factor_lanes/cr_solve_lanes) and
against dense solves (after tests/test_batch_stiff.py::TestLaneLinalg)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gab1_shp2_tpu.ops import batch_stiff as jbs

from gab1_shp2_tpu_torch.ops import batch_stiff as tbs

torch.set_num_threads(2)


def test_gj_inv():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(5, 6, 6, 7)) + 6 * np.eye(6)[None, :, :, None]
    got = tbs.gj_inv_lanes(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbs.gj_inv_lanes(
        jnp.asarray(A))), rtol=1e-13, atol=1e-13)
    want = np.linalg.inv(np.moveaxis(A, -1, 1))            # (5, 7, 6, 6)
    np.testing.assert_allclose(np.moveaxis(got, -1, 1), want, rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("dtype,tiny", [(np.float32, 1e-20),
                                        (np.float64, 1e-30)])
def test_gj_inv_clamps_zero_pivots(dtype, tiny):
    """A zero pivot is clamped (pivot-free Gauss-Jordan), exactly as the
    JAX package clamps it: the result is finite and equal."""
    A = np.eye(3, dtype=dtype)[None, :, :, None].repeat(2, axis=-1)
    A[0, 0, 0, 0] = 0.0
    A[0, 1, 1, 1] = -0.0
    got = tbs.gj_inv_lanes(torch.as_tensor(A)).numpy()
    want = np.asarray(jbs.gj_inv_lanes(jnp.asarray(A)))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0, 0] == np.asarray(1.0 / dtype(tiny), dtype)


def test_mm_and_mv():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(3, 4, 5, 6))
    B = rng.normal(size=(3, 5, 4, 6))
    x = rng.normal(size=(3, 5, 6))
    got = tbs.mm_lanes(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, np.einsum("nijb,njkb->nikb", A, B),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jbs.mm_lanes(
        jnp.asarray(A), jnp.asarray(B))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tbs.mv_lanes(torch.as_tensor(A), torch.as_tensor(x)).numpy(),
        np.asarray(jbs.mv_lanes(jnp.asarray(A), jnp.asarray(x))),
        rtol=1e-12, atol=1e-12)


def _dense(L, D, U, lane):
    NB, n = D.shape[0], D.shape[1]
    M = np.zeros((NB * n, NB * n))
    for i in range(NB):
        M[i * n:(i + 1) * n, i * n:(i + 1) * n] = D[i, :, :, lane]
        if i > 0:
            M[i * n:(i + 1) * n, (i - 1) * n:i * n] = L[i, :, :, lane]
        if i < NB - 1:
            M[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = U[i, :, :, lane]
    return M


@pytest.mark.parametrize("NB,n", [(9, 4), (5, 10), (8, 3), (1, 3)])
def test_cr_factor_solve(NB, n):
    rng = np.random.default_rng(3 + NB)
    B = 5
    L = rng.normal(size=(NB, n, n, B)) * 0.1
    U = rng.normal(size=(NB, n, n, B)) * 0.1
    D = rng.normal(size=(NB, n, n, B)) + 4 * np.eye(n)[None, :, :, None]
    b = rng.normal(size=(NB, n, B))
    fac = tbs.cr_factor_lanes(*map(torch.as_tensor, (L, D, U)))
    x = tbs.cr_solve_lanes(fac, torch.as_tensor(b)).numpy()
    jfac = jbs.cr_factor_lanes(*map(jnp.asarray, (L, D, U)))
    xj = np.asarray(jbs.cr_solve_lanes(jfac, jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-12)
    for lane in range(B):
        M = torch.as_tensor(_dense(L, D, U, lane))
        want = torch.linalg.solve(M, torch.as_tensor(b[:, :, lane]).reshape(
            -1)).numpy()
        np.testing.assert_allclose(x[:, :, lane].ravel(), want, rtol=1e-9,
                                   atol=1e-9)
